// The GEMM's accumulate forms and fused epilogue, applied once per output
// element from an fp32 accumulator (kernels/mma_gemm.py's contract):
//
//     out = cast(residual + act(bias + alpha * ([-]acc [+ (+/-) beta * C])))
//
// Shared by the weight-stream kernel (gemm_stream.cu) and the TMA + wgmma
// tile (gemm_wgmma.cu).  The plain version (mma_gemm_plain) evaluates the
// same expression in the same order.
#pragma once

#include "common.cuh"

struct GemmEpi {
  const void* c;     // ((B,) M, N) seed or null
  const void* bias;  // (N,) or null
  const void* res;   // ((B,) M, N) or null
  void* out;         // ((B,) M, N)
  int c_dt, bias_dt, res_dt, out_dt;
  int M, N;
  float alpha, beta;
  int neg_product, neg_acc, act;
  int vec8;  // c, bias, res and out 16-byte aligned: 8-wide vector access
  // The ABFT sidecar (K1e), fp32: ((B,) gm, N) per-tile column sums and
  // ((B,) M, gn) per-tile row sums, or null (no sidecar).
  float* ck_col = nullptr;
  float* ck_row = nullptr;
};

// The finished value of output (bz, row, col) from its product `acc`.
__device__ __forceinline__ float gemm_finish(const GemmEpi& e, int bz, int row,
                                             int col, float acc) {
  const long long idx = ((long long)bz * e.M + row) * e.N + col;
  float v = e.neg_product ? -acc : acc;
  if (e.c) {
    const float s = e.beta * load_f(e.c, e.c_dt, idx);
    v += e.neg_acc ? -s : s;
  }
  if (e.alpha != 1.f) v *= e.alpha;
  return epilogue_apply(v, e.act, e.bias, e.bias_dt, col, e.res, e.res_dt, idx);
}

// Eight consecutive elements at idx (a multiple of 8, 16-byte aligned).
__device__ __forceinline__ void load8_f(const void* p, int dt, long long idx,
                                        float (&v)[8]) {
  if (dt == DT_F32) {
    const float4 a = *reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(p) + idx);
    const float4 b = *reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(p) + idx + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
  const uint4 u = *reinterpret_cast<const uint4*>(
      reinterpret_cast<const uint16_t*>(p) + idx);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f;
    if (dt == DT_BF16)
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    else
      f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8_f(void* p, int dt, long long idx,
                                         const float (&v)[8]) {
  if (dt == DT_F32) {
    float* q = reinterpret_cast<float*>(p) + idx;
    *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(q + 4) = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (dt == DT_BF16) {
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    } else {
      __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
  }
  *reinterpret_cast<uint4*>(reinterpret_cast<uint16_t*>(p) + idx) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// Eight adjacent columns (col a multiple of 8) of one row, masked at the M
// and N fringes: vector loads and one vector store where the row holds
// all eight and every operand is aligned, else element by element.  The
// arithmetic is gemm_finish's, in its order.  On return v holds the
// finished values of the lanes inside the matrix (the sidecar's input).
__device__ __forceinline__ void gemm_store8(const GemmEpi& e, int bz, int row,
                                            int col, float (&v)[8]) {
  if (row >= e.M || col >= e.N) return;
  if (!e.vec8 || col + 8 > e.N || (e.N & 7)) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col + i < e.N) {
        v[i] = gemm_finish(e, bz, row, col + i, v[i]);
        const long long idx = ((long long)bz * e.M + row) * e.N + col + i;
        store_f(e.out, e.out_dt, idx, v[i]);
      }
    return;
  }
  const long long idx = ((long long)bz * e.M + row) * e.N + col;
  float t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = e.neg_product ? -v[i] : v[i];
  if (e.c) {
    load8_f(e.c, e.c_dt, idx, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = e.beta * t[i];
      v[i] += e.neg_acc ? -s : s;
    }
  }
  if (e.alpha != 1.f) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= e.alpha;
  }
  if (e.bias) {
    load8_f(e.bias, e.bias_dt, col, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += t[i];
  }
  if (e.act != ACT_NONE) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = act_apply(v[i], e.act);
  }
  if (e.res) {
    load8_f(e.res, e.res_dt, idx, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += t[i];
  }
  store8_f(e.out, e.out_dt, idx, v);
}
