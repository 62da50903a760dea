// Accumulator-resident blocked GEMM for Hopper (sm_90a): the WMMA tiles.
//
// Replaces the TPU kernel K1a: repro/kernels/mma_gemm.py, mma_gemm
// (kernel body _make_kernel), restricted to the F32GER / BF16GER2 / F16GER2
// families, 2-D and batched operands, the accumulate forms, the fused
// epilogue and the ABFT checksum sidecar:
//
//     out = cast(residual + act(bias + alpha * ([-](X @ Y) + s * beta * C)))
//
// with s = -1 for the neg_acc form, and the pm* prefixed masked forms (K1b:
// the row, column and rank predicates of repro/kernels/mma_gemm.py's
// _make_kernel, applied to the staged panels).  The int8/int4/int16/f64
// families (gemm_imma.cu, gemm_dmma.cu) and prepacked panels are not
// here.
//
// Which products run here.  core/tiling.py's choose_gemm_path sends M <=
// 64 to the weight stream (gemm_stream.cu) and larger M with 16-byte
// pitches to the TMA + wgmma tile (gemm_wgmma.cu).  This kernel takes the
// rest: pitches TMA cannot describe at large M (whisper's 51865-column
// logits over a prompt), K below one MMA step (the SSD's K = 1 outer
// product), F32GER, which stays true fp32 (never TF32), and an explicit
// Plan.block naming one of core/tiling.py's GEMM_TILES, and every masked
// 16-bit or fp32 product, at any M (choose_gemm_path(masked=True)).
//
// What bounds it on an H100: device memory (3.35 TB/s) for skinny
// products, the tensor cores (989 TFLOP/s bf16; 67 TFLOP/s fp32 FMAs for
// F32GER) for large ones.
//
// Design.  One thread block owns one (bm, bn) output tile and runs the
// whole k-loop itself; batch comes from blockIdx.z.
//   * prime: the seed C (neg/beta forms) is read once into a shared fp32
//     tile and loaded into the warps' accumulator fragments;
//   * update: (bm, bk) and (bk, bn) panels are staged in shared memory,
//     zero-filled past the M, N and K fringes, and multiplied with WMMA
//     bf16/f16 tensor-core fragments into fp32 registers; F32GER runs fp32
//     FMAs;
//   * deprime: the fragments go back through the shared tile, and one
//     masked pass applies alpha and the epilogue and stores each output
//     element exactly once, in the requested dtype.
//   * masked (K1b): the kernels' MASKED instances stage their panels
//     through tile_gemm.cuh's MaskedRowMajorA/B, which write a disabled
//     row, column or rank as 0 in the branch that zero-fills the fringes
//     (one byte a lane read from the (M,), (N,), (K,) masks, L1-cached);
//     the unmasked instances are unchanged.
//   * the ABFT sidecar (K1e, checksum=True in repro/kernels/mma_gemm.py):
//     with ck_col / ck_row set, the deprime writes each finished fp32
//     value back over the store_matrix_sync staging, and the block sums the
//     tile's columns (one a thread) and rows (one a warp) in a fixed order
//     (common.cuh's tile_checksums): one write per tile column and row, no
//     atomics; the stores are untouched.
// The update loop is tile_gemm.cuh's, shared with K3's implicit GEMM.
// Loads are synchronous 16-byte vectors (no cp.async/TMA pipeline, no
// wgmma): the two other kernels carry the main path's products.

#include "tile_gemm.cuh"

struct GemmArgs {
  const void* x;
  const void* y;
  const void* c;
  const void* bias;
  const void* res;
  void* out;
  int c_dt, bias_dt, res_dt, out_dt;
  int M, N, K;
  long long sxb, syb, scb, srb, sob;  // batch strides in elements (0: shared)
  float alpha, beta;
  int neg_product, neg_acc, act;
  int vec_x, vec_y;  // rows 16-byte aligned: vector loads allowed
  PmMasks mk;        // the pm* predicates (the MASKED instances)
  float* ck_col;     // ((B,) gm, N) per-tile column sums, or null
  float* ck_row;     // ((B,) M, gn) per-tile row sums, or null
};

// prime: the seed s * beta * C into the shared fp32 tile (zero off-matrix).
// With the neg_product form the accumulator holds -(seed) + X@Y and the
// deprime negates it back, so the seed sign folds both forms.
template <int BM, int BN>
__device__ void prime_tile(float* cs, const GemmArgs& a, int bz, int m0,
                           int n0) {
  constexpr int LDC = BN + 4;
  const float sign = (a.neg_acc ? -1.f : 1.f) * (a.neg_product ? -1.f : 1.f);
  const long long base = (long long)bz * a.scb;
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = i / BN, cc = i % BN;
    const int gr = m0 + r, gc = n0 + cc;
    float v = 0.f;
    if (gr < a.M && gc < a.N)
      v = sign * (a.beta * load_f(a.c, a.c_dt, base + (long long)gr * a.N + gc));
    cs[r * LDC + cc] = v;
  }
}

// deprime: alpha, epilogue, cast; every in-bounds element stored once;
// with the sidecar, the finished values back over the tile and its sums.
template <int BM, int BN>
__device__ void store_tile(float* cs, const GemmArgs& a, int bz, int m0,
                           int n0) {
  constexpr int LDC = BN + 4;
  const float fin = a.neg_product ? -1.f : 1.f;
  const long long rbase = (long long)bz * a.srb;
  const long long obase = (long long)bz * a.sob;
  const bool ck = a.ck_col != nullptr;
  for_each_in_tile<BM, BN>(cs, a.M, a.N, m0, n0, [&](int gr, int gc, float v) {
    v *= fin;
    if (a.alpha != 1.f) v *= a.alpha;
    const long long idx = (long long)gr * a.N + gc;
    v = epilogue_apply(v, a.act, a.bias, a.bias_dt, gc, a.res, a.res_dt,
                       rbase + idx);
    store_f(a.out, a.out_dt, obase + idx, v);
    if (ck) cs[(gr - m0) * LDC + gc - n0] = v;
  });
  if (ck) {
    __syncthreads();
    const int gm = (a.M + BM - 1) / BM, gn = (a.N + BN - 1) / BN;
    tile_checksums<float>(cs, LDC, min(BM, a.M - m0), min(BN, a.N - n0),
                          a.ck_col + ((long long)bz * gm + m0 / BM) * a.N + n0,
                          a.ck_row + ((long long)bz * a.M + m0) * gn + n0 / BN,
                          gn, threadIdx.x, blockDim.x);
  }
}

// bf16 / f16 on the tensor cores (tile_gemm.cuh's wmma_tile).
template <typename T, int BM, int BN, int BK, int WM, int WN, bool MASKED>
__global__ void __launch_bounds__(WM* WN * 32)
    gemm_wmma_kernel(GemmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  const int bz = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (a.c) prime_tile<BM, BN>(cs, a, bz, m0, n0);
  const T* x = reinterpret_cast<const T*>(a.x) + (long long)bz * a.sxb;
  const T* y = reinterpret_cast<const T*>(a.y) + (long long)bz * a.syb;
  if constexpr (MASKED) {
    const MaskedRowMajorA<T> ld{x, a.M, a.K, m0, a.vec_x != 0, a.mk};
    const MaskedRowMajorB<T> bl{y, a.K, a.N, n0, a.vec_y != 0, a.mk};
    wmma_tile_ab<T, BM, BN, BK, WM, WN>(smem, ld, bl, a.K, a.c != nullptr);
  } else {
    const RowMajorA<T> ld{x, a.M, a.K, m0, a.vec_x != 0};
    wmma_tile<T, BM, BN, BK, WM, WN>(smem, ld, y, a.K, a.N, n0, a.vec_y != 0,
                                     a.c != nullptr);
  }
  store_tile<BM, BN>(cs, a, bz, m0, n0);
}

// F32GER: true fp32 FMAs (tile_gemm.cuh's f32_tile).
template <bool MASKED>
__global__ void __launch_bounds__(256) gemm_f32_kernel(GemmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  const int bz = blockIdx.z, m0 = blockIdx.y * F32_BM, n0 = blockIdx.x * F32_BN;
  if (a.c) prime_tile<F32_BM, F32_BN>(cs, a, bz, m0, n0);
  const float* x = reinterpret_cast<const float*>(a.x) + (long long)bz * a.sxb;
  const float* y = reinterpret_cast<const float*>(a.y) + (long long)bz * a.syb;
  if constexpr (MASKED) {
    const MaskedRowMajorA<float> ld{x, a.M, a.K, m0, false, a.mk};
    const MaskedRowMajorB<float> bl{y, a.K, a.N, n0, false, a.mk};
    f32_tile_ab(smem, ld, bl, a.K, a.c != nullptr);
  } else {
    const RowMajorA<float> ld{x, a.M, a.K, m0, false};
    f32_tile(smem, ld, y, a.K, a.N, n0, a.c != nullptr);
  }
  store_tile<F32_BM, F32_BN>(cs, a, bz, m0, n0);
}

template <bool MASKED>
static int launch_f32(const GemmArgs& a, int batch, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t smem = f32_smem_bytes();
  auto kernel = gemm_f32_kernel<MASKED>;
  cudaError_t e = allow_smem(kernel, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + F32_BN - 1) / F32_BN, (a.M + F32_BM - 1) / F32_BM, batch);
  kernel<<<grid, 256, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BN, int BK, int WM, int WN, bool MASKED>
static int launch_wmma(const GemmArgs& a, int batch, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t smem = wmma_smem_bytes<T, BM, BN, BK>();
  auto kernel = gemm_wmma_kernel<T, BM, BN, BK, WM, WN, MASKED>;
  cudaError_t e = allow_smem(kernel, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, batch);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool MASKED>
static int launch_16bit(const GemmArgs& a, int batch, int bm, int bn, int bk,
                        cudaStream_t stream) {
  // The tiles core/tiling.py GEMM_TILES lists for BF16GER2 / F16GER2.
  if (bm == 128 && bn == 128 && bk == 32)
    return launch_wmma<T, 128, 128, 32, 2, 4, MASKED>(a, batch, stream);
  if (bm == 64 && bn == 64 && bk == 64)
    return launch_wmma<T, 64, 64, 64, 2, 2, MASKED>(a, batch, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_16bit_any(const GemmArgs& a, bool masked, int batch, int bm,
                            int bn, int bk, cudaStream_t stream) {
  return masked ? launch_16bit<T, true>(a, batch, bm, bn, bk, stream)
                : launch_16bit<T, false>(a, batch, bm, bn, bk, stream);
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// xm, ym, pm: the pm* byte masks over M, N and K, each null or one byte a
// lane; any non-null one selects the MASKED kernels.  ck_col / ck_row: the
// sidecar's ((B,) ceil(M / bm), N) and ((B,) M, ceil(N / bn)) fp32 outputs,
// or null.
extern "C" int mma_gemm_launch(
    const void* x, const void* y, const void* xm, const void* ym,
    const void* pm, const void* c, const void* bias,
    const void* res, void* out, int in_dt, int c_dt, int bias_dt, int res_dt,
    int out_dt, int batch, int M, int N, int K, long long sxb, long long syb,
    long long scb, long long srb, long long sob, float alpha, float beta,
    int neg_product, int neg_acc, int act, int bm, int bn, int bk,
    float* ck_col, float* ck_row, void* stream) {
  GemmArgs a;
  a.x = x; a.y = y; a.c = c; a.bias = bias; a.res = res; a.out = out;
  a.c_dt = c_dt; a.bias_dt = bias_dt; a.res_dt = res_dt; a.out_dt = out_dt;
  a.M = M; a.N = N; a.K = K;
  a.sxb = sxb; a.syb = syb; a.scb = scb; a.srb = srb; a.sob = sob;
  a.alpha = alpha; a.beta = beta;
  a.neg_product = neg_product; a.neg_acc = neg_acc; a.act = act;
  a.vec_x = (K % 8 == 0) && aligned16(x) && (sxb % 8 == 0);
  a.vec_y = (N % 8 == 0) && aligned16(y) && (syb % 8 == 0);
  a.mk.xm = reinterpret_cast<const uint8_t*>(xm);
  a.mk.ym = reinterpret_cast<const uint8_t*>(ym);
  a.mk.pm = reinterpret_cast<const uint8_t*>(pm);
  a.ck_col = ck_col; a.ck_row = ck_row;
  const bool masked = xm || ym || pm;
  for (const void* m : {xm, ym, pm})   // 8-byte mask loads
    if (m && !aligned16(m)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_BF16)
    return launch_16bit_any<__nv_bfloat16>(a, masked, batch, bm, bn, bk, s);
  if (in_dt == DT_F16)
    return launch_16bit_any<__half>(a, masked, batch, bm, bn, bk, s);
  if (in_dt == DT_F32) {
    if (bm != F32_BM || bn != F32_BN || bk != F32_BK)
      return (int)cudaErrorInvalidValue;
    return masked ? launch_f32<true>(a, batch, s)
                  : launch_f32<false>(a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}
