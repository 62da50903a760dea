// Accumulator-resident blocked GEMM for Hopper (sm_90a): the WMMA tiles.
//
// Replaces the TPU kernel K1a: repro/kernels/mma_gemm.py, mma_gemm
// (kernel body _make_kernel), restricted to the F32GER / BF16GER2 / F16GER2
// families, 2-D and batched operands, the accumulate forms and the fused
// epilogue:
//
//     out = cast(residual + act(bias + alpha * ([-](X @ Y) + s * beta * C)))
//
// with s = -1 for the neg_acc form.  The pm* masks, int8/int4/int16/f64
// families, prepacked panels and the ABFT sidecar (K1b-f) are not here.
//
// Which products run here.  core/tiling.py's choose_gemm_path sends M <=
// 64 to the weight stream (gemm_stream.cu) and larger M with 16-byte
// pitches to the TMA + wgmma tile (gemm_wgmma.cu).  This kernel takes the
// rest: pitches TMA cannot describe at large M (whisper's 51865-column
// logits over a prompt), K below one MMA step (the SSD's K = 1 outer
// product), F32GER, which stays true fp32 (never TF32), and an explicit
// Plan.block naming one of core/tiling.py's GEMM_TILES.
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

// deprime: alpha, epilogue, cast; every in-bounds element stored once.
template <int BM, int BN>
__device__ void store_tile(const float* cs, const GemmArgs& a, int bz, int m0,
                           int n0) {
  const float fin = a.neg_product ? -1.f : 1.f;
  const long long rbase = (long long)bz * a.srb;
  const long long obase = (long long)bz * a.sob;
  for_each_in_tile<BM, BN>(cs, a.M, a.N, m0, n0, [&](int gr, int gc, float v) {
    v *= fin;
    if (a.alpha != 1.f) v *= a.alpha;
    const long long idx = (long long)gr * a.N + gc;
    v = epilogue_apply(v, a.act, a.bias, a.bias_dt, gc, a.res, a.res_dt,
                       rbase + idx);
    store_f(a.out, a.out_dt, obase + idx, v);
  });
}

// bf16 / f16 on the tensor cores (tile_gemm.cuh's wmma_tile).
template <typename T, int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(WM* WN * 32)
    gemm_wmma_kernel(GemmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  const int bz = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (a.c) prime_tile<BM, BN>(cs, a, bz, m0, n0);
  const RowMajorA<T> ld{reinterpret_cast<const T*>(a.x) + (long long)bz * a.sxb,
                        a.M, a.K, m0, a.vec_x != 0};
  wmma_tile<T, BM, BN, BK, WM, WN>(
      smem, ld, reinterpret_cast<const T*>(a.y) + (long long)bz * a.syb, a.K,
      a.N, n0, a.vec_y != 0, a.c != nullptr);
  store_tile<BM, BN>(cs, a, bz, m0, n0);
}

// F32GER: true fp32 FMAs (tile_gemm.cuh's f32_tile).
__global__ void __launch_bounds__(256) gemm_f32_kernel(GemmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  const int bz = blockIdx.z, m0 = blockIdx.y * F32_BM, n0 = blockIdx.x * F32_BN;
  if (a.c) prime_tile<F32_BM, F32_BN>(cs, a, bz, m0, n0);
  const RowMajorA<float> ld{
      reinterpret_cast<const float*>(a.x) + (long long)bz * a.sxb, a.M, a.K,
      m0, false};
  f32_tile(smem, ld, reinterpret_cast<const float*>(a.y) + (long long)bz * a.syb,
           a.K, a.N, n0, a.c != nullptr);
  store_tile<F32_BM, F32_BN>(cs, a, bz, m0, n0);
}

template <typename T, int BM, int BN, int BK, int WM, int WN>
static int launch_wmma(const GemmArgs& a, int batch, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t smem = wmma_smem_bytes<T, BM, BN, BK>();
  auto kernel = gemm_wmma_kernel<T, BM, BN, BK, WM, WN>;
  cudaError_t e = allow_smem(kernel, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, batch);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_16bit(const GemmArgs& a, int batch, int bm, int bn, int bk,
                        cudaStream_t stream) {
  // The tiles core/tiling.py GEMM_TILES lists for BF16GER2 / F16GER2.
  if (bm == 128 && bn == 128 && bk == 32)
    return launch_wmma<T, 128, 128, 32, 2, 4>(a, batch, stream);
  if (bm == 64 && bn == 64 && bk == 64)
    return launch_wmma<T, 64, 64, 64, 2, 2>(a, batch, stream);
  return (int)cudaErrorInvalidValue;
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

extern "C" int mma_gemm_launch(
    const void* x, const void* y, const void* c, const void* bias,
    const void* res, void* out, int in_dt, int c_dt, int bias_dt, int res_dt,
    int out_dt, int batch, int M, int N, int K, long long sxb, long long syb,
    long long scb, long long srb, long long sob, float alpha, float beta,
    int neg_product, int neg_acc, int act, int bm, int bn, int bk,
    void* stream) {
  GemmArgs a;
  a.x = x; a.y = y; a.c = c; a.bias = bias; a.res = res; a.out = out;
  a.c_dt = c_dt; a.bias_dt = bias_dt; a.res_dt = res_dt; a.out_dt = out_dt;
  a.M = M; a.N = N; a.K = K;
  a.sxb = sxb; a.syb = syb; a.scb = scb; a.srb = srb; a.sob = sob;
  a.alpha = alpha; a.beta = beta;
  a.neg_product = neg_product; a.neg_acc = neg_acc; a.act = act;
  a.vec_x = (K % 8 == 0) && aligned16(x) && (sxb % 8 == 0);
  a.vec_y = (N % 8 == 0) && aligned16(y) && (syb % 8 == 0);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_BF16) return launch_16bit<__nv_bfloat16>(a, batch, bm, bn, bk, s);
  if (in_dt == DT_F16) return launch_16bit<__half>(a, batch, bm, bn, bk, s);
  if (in_dt == DT_F32) {
    if (bm != F32_BM || bn != F32_BN || bk != F32_BK)
      return (int)cudaErrorInvalidValue;
    static bool smem_ok = false;
    constexpr size_t smem = f32_smem_bytes();
    cudaError_t e = allow_smem(gemm_f32_kernel, smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((N + F32_BN - 1) / F32_BN, (M + F32_BM - 1) / F32_BM, batch);
    gemm_f32_kernel<<<grid, 256, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
