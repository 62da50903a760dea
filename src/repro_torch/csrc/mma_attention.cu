// Flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel K2: repro/kernels/mma_attention.py,
// mma_flash_attention (kernel body _flash_kernel, schedule attn_grid_plan):
//
//     out = cast(epilogue(softmax(Q K^T * D^-1/2 + mask) V))
//
// q (B, Sq, H, D), k and v (B, Sk, KVH, D), bf16 or f16, fp32 online
// softmax.  Query head h reads KV head h / (H / KVH) (GQA) without
// materializing the repeat.  The mask is the conjunction of the causal,
// sliding-window, q_offset and valid-slot predicates.
//
// What bounds it on an H100.  Causal prefill at S = 256..4096 with D = 128
// does 4 * D flops per live (q, k) pair over inputs read once: tens to
// hundreds of flops per byte, so past a few hundred tokens the bf16 tensor
// cores (989 TFLOP/s) bound it; the exp() of the softmax runs on the
// special-function units beside them.
//
// Design.  The TPU kernel walked a scalar-prefetched flattened schedule of
// live (qi, ki) blocks in order, keeping O, m and l in VMEM across it.
// Here one thread block owns one (b, h, q-block of 64 rows), computes its
// own live KV-block range [lo, hi) with attn_k_bounds' arithmetic (the
// causal bound above, the window bound below) and loops over it, so the
// sequential grid dimension becomes a loop inside the block and causal
// prefill still skips the blocks above the diagonal.  Each of the 4 warps
// owns 16 query rows: S = Q K^T on WMMA tensor-core fragments, the online
// softmax in fp32 per row (m, l), P rounded to the input type as the
// reference rounds it, and O = O * corr + P V with O held in shared fp32.
// The masked-block guard stays: p = 0 where m_new == NEG_INF, and an
// l == 0 row stores 0 (before the epilogue).  Sq and Sk need not divide
// the 64 x 64 tile: the ragged edge is zero-filled and masked.  This is the
// simple first kernel (synchronous loads, O round-trips through shared
// memory each KV block, no wgmma/TMA); PERF.md has its times.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* valid;  // (B, Sk) or null
  const void* bias;            // (D,) or null
  const void* res;             // (B, Sq, H, D) or null
  void* out;                   // (B, Sq, H, D)
  int bias_dt, res_dt, out_dt;
  int B, Sq, Sk, H, KVH, group;
  int causal, q_offset, window;  // window <= 0: no window
  float scale;
  int act;
};

constexpr int BQ = 64, BKV = 64, ATTN_THREADS = 128;

// ROWS rows of D contiguous elements (row pitch g_stride) into shared
// memory with pitch LD; rows at or past nrows are zero.
template <typename T, int ROWS, int D, int LD>
__device__ void load_rows(T* s, const T* g, int r0, int nrows,
                          long long g_stride) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const int gr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows)
      val = __ldg(reinterpret_cast<const uint4*>(g + (long long)gr * g_stride + c));
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

template <typename T, int D>
struct AttnSmem {
  static constexpr int LDQ = D + 8, LDS = BKV + 4, LDP = BKV + 8, LDO = D + 4;
  static constexpr size_t q = (size_t)BQ * LDQ * sizeof(T);
  static constexpr size_t kv = (size_t)BKV * LDQ * sizeof(T);
  static constexpr size_t s = (size_t)BQ * LDS * sizeof(float);
  static constexpr size_t p = (size_t)BQ * LDP * sizeof(T);
  static constexpr size_t o = (size_t)BQ * LDO * sizeof(float);
  static constexpr size_t stats = (size_t)3 * BQ * sizeof(float);
  static constexpr size_t total = q + 2 * kv + s + p + o + stats;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(ATTN_THREADS) flash_attn_kernel(AttnArgs a) {
  using L = AttnSmem<T, D>;
  constexpr int LDQ = L::LDQ, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::q);
  T* vs = reinterpret_cast<T*>(smem + L::q + L::kv);
  float* ss = reinterpret_cast<float*>(smem + L::q + 2 * L::kv);
  T* ps = reinterpret_cast<T*>(smem + L::q + 2 * L::kv + L::s);
  float* os = reinterpret_cast<float*>(smem + L::q + 2 * L::kv + L::s + L::p);
  float* m_s = os + BQ * LDO;
  float* l_s = m_s + BQ;
  float* corr_s = l_s + BQ;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const int q0 = qi * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q_pitch = (long long)a.H * D;
  const long long kv_pitch = (long long)a.KVH * D;
  const T* qg = reinterpret_cast<const T*>(a.q) + ((long long)b * a.Sq * a.H + h) * D;
  const T* kg = reinterpret_cast<const T*>(a.k) + ((long long)b * a.Sk * a.KVH + kvh) * D;
  const T* vg = reinterpret_cast<const T*>(a.v) + ((long long)b * a.Sk * a.KVH + kvh) * D;

  // prime: O = 0, m = NEG_INF, l = 0
  load_rows<T, BQ, D, LDQ>(qs, qg, q0, a.Sq, q_pitch);
  for (int i = threadIdx.x; i < BQ * LDO; i += blockDim.x) os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
    m_s[i] = REPRO_NEG_INF;
    l_s[i] = 0.f;
  }

  // The live KV-block range of this q block: attn_k_bounds(qi, nk, bq=64,
  // bk=64, causal, q_offset, window) in kernels/mma_attention.py.
  const int nk = (a.Sk + BKV - 1) / BKV;
  int hi = nk;
  if (a.causal) {
    const long long t = (long long)a.q_offset + (long long)(qi + 1) * BQ;
    hi = (int)min((long long)nk, (t + BKV - 1) / BKV);
    hi = max(hi, 1);
  }
  int lo = 0;
  if (a.window > 0) {
    const long long t = (long long)a.q_offset + (long long)qi * BQ - (a.window - 1);
    lo = t > 0 ? (int)(t / BKV) : 0;
    lo = min(lo, hi - 1);
  }
  __syncthreads();

  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BKV;
    load_rows<T, BKV, D, LDQ>(ks, kg, k0, a.Sk, kv_pitch);
    load_rows<T, BKV, D, LDQ>(vs, vg, k0, a.Sk, kv_pitch);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (K read as a column-major K^T).
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BKV / 16];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sf[j], 0.f);
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fq;
        wmma::load_matrix_sync(fq, qs + (warp * 16) * LDQ + d0, LDQ);
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fk;
          wmma::load_matrix_sync(fk, ks + (j * 16) * LDQ + d0, LDQ);
          wmma::mma_sync(sf[j], fq, fk, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(ss + (warp * 16) * LDS + j * 16, sf[j], LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time; lane covers columns lane, lane+32.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const long long qpos = (long long)a.q_offset + q0 + r;
      float sv[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        const int kpos = k0 + j;
        bool live = kpos < a.Sk;
        if (a.causal) live = live && qpos >= kpos;
        if (a.window > 0) live = live && (qpos - kpos < a.window);
        if (a.valid) live = live && a.valid[(long long)b * a.Sk + min(kpos, a.Sk - 1)];
        sv[t] = live ? ss[r * LDS + j] * a.scale : REPRO_NEG_INF;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(sv[0], sv[1])));
      // masked-block guard: a row with no live slot yet contributes zeros
      const float p0 = (m_new == REPRO_NEG_INF) ? 0.f : expf(sv[0] - m_new);
      const float p1 = (m_new == REPRO_NEG_INF) ? 0.f : expf(sv[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      ps[r * LDP + lane] = from_f<T>(p0);
      ps[r * LDP + lane + 32] = from_f<T>(p1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncwarp();

    // O = O * corr + P V on this warp's rows.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float corr = corr_s[r];
      for (int d = lane; d < D; d += 32) os[r * LDO + d] *= corr;
    }
    __syncwarp();
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, os + (warp * 16) * LDO + d0, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fv;
        wmma::load_matrix_sync(fp, ps + (warp * 16) * LDP + kk, LDP);
        wmma::load_matrix_sync(fv, vs + kk * LDQ + d0, LDQ);
        wmma::mma_sync(of, fp, fv, of);
      }
      wmma::store_matrix_sync(os + (warp * 16) * LDO + d0, of, LDO, wmma::mem_row_major);
    }
    __syncthreads();  // K/V tiles are overwritten next
  }

  // deprime: normalise (l == 0 rows store 0), epilogue, cast, store once.
  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    if (s >= a.Sq) continue;
    const float l = l_s[r];
    float o = os[r * LDO + d] / (l == 0.f ? 1.f : l);
    const long long idx = (((long long)b * a.Sq + s) * a.H + h) * D + d;
    o = epilogue_apply(o, a.act, a.bias, a.bias_dt, d, a.res, a.res_dt, idx);
    store_f(a.out, a.out_dt, idx, o);
  }
}

template <typename T, int D>
static int launch_attn(const AttnArgs& a, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t smem = AttnSmem<T, D>::total;
  auto kernel = flash_attn_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, ATTN_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_by_depth(const AttnArgs& a, int d, cudaStream_t stream) {
  if (d == 128) return launch_attn<T, 128>(a, stream);
  if (d == 64) return launch_attn<T, 64>(a, stream);
  if (d == 32) return launch_attn<T, 32>(a, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mma_attention_launch(
    const void* q, const void* k, const void* v, const void* valid,
    const void* bias, const void* res, void* out, int in_dt, int bias_dt,
    int res_dt, int out_dt, int B, int Sq, int Sk, int H, int KVH, int D,
    int causal, int q_offset, int window, float scale, int act, void* stream) {
  AttnArgs a;
  a.q = q; a.k = k; a.v = v;
  a.valid = reinterpret_cast<const unsigned char*>(valid);
  a.bias = bias; a.res = res; a.out = out;
  a.bias_dt = bias_dt; a.res_dt = res_dt; a.out_dt = out_dt;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.KVH = KVH; a.group = H / KVH;
  a.causal = causal; a.q_offset = q_offset; a.window = window;
  a.scale = scale; a.act = act;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_BF16) return launch_by_depth<__nv_bfloat16>(a, D, s);
  if (in_dt == DT_F16) return launch_by_depth<__half>(a, D, s);
  return (int)cudaErrorInvalidValue;
}
