// TMA + wgmma GEMM tile for large M on Hopper (sm_90a): prefill.
//
// Replaces the TPU kernel K1a (repro/kernels/mma_gemm.py, mma_gemm, kernel
// body _make_kernel) for the products whose M is a prompt or a batch of
// prompts (deepseek's M = 256, qwen2-vl's 1024-4352, whisper's encoder
// 6000, the SSD's batched chunk products):
//
//     out = cast(residual + act(bias + alpha * ([-](X @ Y) [+/- beta * C])))
//
// X (M, K) and Y (K, N) row-major, bf16 or f16, fp32 accumulation, 2-D or
// batched; K and N multiples of 8 (16-byte pitches, TMA's rule).
//
// What bounds it on an H100.  At these M every weight byte meets hundreds
// of rows: the bound is the bf16 tensor cores (989 TFLOP/s dense), which
// only wgmma reaches; the old WMMA tile reached 87 TFLOP/s at M = 4352.
//
// Design.
//   * One block owns a (128, BN) output tile, BN = 128 or 256, and walks
//     K in steps of 64.  Tiles are rastered in groups of 8 tile rows so
//     that the blocks on the card at one time share their Y panels in L2.
//   * Warp specialisation: warpgroup 0 is the producer (one thread issues
//     every TMA load; setmaxnreg gives its registers away); warpgroups 1
//     and 2 are consumers, each owning 64 rows of the tile as m64nBNk16
//     wgmma accumulators in registers (setmaxnreg 232).
//   * A ring of 4 (BN = 256) or 6 (BN = 128) stages in shared memory, each
//     a (128 x 64) X box (K-major) and BN / 64 (64 x 64) Y boxes (Y is
//     row-major: MN-major for wgmma, tnspB), all 128-byte swizzled, with a
//     full and an empty mbarrier per stage.  Consumers keep one wgmma
//     group in flight and release a stage when the group after it is
//     issued.
//   * TMA zero-fills the M, N and K fringes; batch is the third
//     coordinate of 3-D tensor maps.  Maps are encoded on the host through
//     the runtime's driver entry point, on every call (hopper.cuh).
//   * The epilogue runs from the accumulators, staged through the idle
//     ring as an fp32 tile: the seed C is added at the store (not primed),
//     then alpha, bias, activation, residual and the cast, eight columns
//     a thread with 16-byte loads and stores, each element once.

#include "gemm_common.cuh"
#include "hopper.cuh"

constexpr int WG_BM = 128, WG_BK = 64, WG_THREADS = 384, WG_GROUP_M = 8;

template <int BN>
struct WgCfg {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;  // 16 KB
  static constexpr int B_BYTES = WG_BK * BN * 2;     // 16 or 32 KB
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static_assert(STAGES * STAGE >= WG_BM * (BN + 8) * 4, "epilogue tile");
  static constexpr size_t smem = (size_t)STAGES * STAGE + 1024 + 2 * STAGES * 8;
};

template <typename T, int BN, bool BATCHED>
__global__ void __launch_bounds__(WG_THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma,
                      const __grid_constant__ CUtensorMap tmb, GemmEpi e,
                      int K) {
  using C = WgCfg<BN>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;

  const int M = e.M, N = e.N;
  const int num_m = (M + WG_BM - 1) / WG_BM, num_n = (N + BN - 1) / BN;
  const int id = blockIdx.x, per_group = WG_GROUP_M * num_n;
  const int first_m = (id / per_group) * WG_GROUP_M;
  const int gsize = min(num_m - first_m, WG_GROUP_M);
  const int m0 = (first_m + (id % per_group) % gsize) * WG_BM;
  const int n0 = ((id % per_group) / gsize) * BN;
  const int bz = blockIdx.y;
  const int kiters = (K + WG_BK - 1) / WG_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int it = 0; it < kiters; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], C::STAGE);
        unsigned char* as = smem + s * C::STAGE;
        unsigned char* bs = as + C::A_BYTES;
        const int k0 = it * WG_BK;
        if (BATCHED) {
          tma_load_3d(as, &tma, &full[s], k0, m0, bz);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_3d(bs + p * 64 * 128, &tmb, &full[s], n0 + 64 * p, k0, bz);
        } else {
          tma_load_2d(as, &tma, &full[s], k0, m0);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_2d(bs + p * 64 * 128, &tmb, &full[s], n0 + 64 * p, k0);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each, accumulator in registers ----
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int it = 0; it < kiters; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* as = smem + s * C::STAGE + c * 64 * 128;
      const unsigned char* bs = smem + s * C::STAGE + C::A_BYTES;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t da = wgmma_desc(as + kk * 32, 16, 1024, 128);
        const uint64_t db = wgmma_desc(bs + kk * 16 * 128, 64 * 128, 1024, 128);
        Wgmma<BN, T>::template ss<1>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(acc);
      if (it > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    reg_fence(acc);

    // Through shared memory (the ring, once both consumers are done with
    // it) as an fp32 tile: coalesced, paired stores from one loop.
    named_bar_sync(1, 256);
    constexpr int LDC = BN + 8;
    float* ct = reinterpret_cast<float*>(smem) + c * 64 * LDC;
    const int wl = threadIdx.x % 128, lane = wl % 32;
    const int r = (wl / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(ct + r * LDC + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(ct + (r + 8) * LDC + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_bar_sync(2 + c, 128);
    for (int i = wl; i < 64 * (BN / 8); i += 128) {
      const int rr = i / (BN / 8), col = 8 * (i % (BN / 8));
      const float4 lo = *reinterpret_cast<const float4*>(ct + rr * LDC + col);
      const float4 hi =
          *reinterpret_cast<const float4*>(ct + rr * LDC + col + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      gemm_store8(e, bz, m0 + c * 64 + rr, n0 + col, v);
    }
  }
}

template <typename T, int BN>
static int launch_wgmma(const void* x, const void* y, const GemmEpi& e, int K,
                        int batch, bool batched, cudaStream_t stream) {
  const uint64_t M = e.M, N = e.N, Kk = K, B = batch;
  CUtensorMap ta, tb;
  const uint64_t a_dims[3] = {Kk, M, B}, a_str[2] = {Kk * 2, M * Kk * 2};
  const uint64_t b_dims[3] = {N, Kk, B}, b_str[2] = {N * 2, Kk * N * 2};
  const uint32_t a_box[3] = {64, WG_BM, 1}, b_box[3] = {64, 64, 1};
  const int rank = batched ? 3 : 2;
  int rc = tmap_16bit(&ta, x, rank, a_dims, a_str, a_box, 128);
  if (rc) return rc;
  rc = tmap_16bit(&tb, y, rank, b_dims, b_str, b_box, 128);
  if (rc) return rc;
  constexpr size_t smem = WgCfg<BN>::smem;
  const int tiles = (int)(((M + WG_BM - 1) / WG_BM) * ((N + BN - 1) / BN));
  dim3 grid(tiles, batch);
  if (batched) {
    static bool ok = false;
    auto kernel = gemm_wgmma_kernel<T, BN, true>;
    cudaError_t err = allow_smem(kernel, smem, &ok);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, WG_THREADS, smem, stream>>>(ta, tb, e, K);
  } else {
    static bool ok = false;
    auto kernel = gemm_wgmma_kernel<T, BN, false>;
    cudaError_t err = allow_smem(kernel, smem, &ok);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, WG_THREADS, smem, stream>>>(ta, tb, e, K);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_wgmma_t(const void* x, const void* y, const GemmEpi& e,
                          int K, int batch, bool batched, int bn,
                          cudaStream_t s) {
  if (bn == 256) return launch_wgmma<T, 256>(x, y, e, K, batch, batched, s);
  if (bn == 128) return launch_wgmma<T, 128>(x, y, e, K, batch, batched, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gemm_wgmma_launch(
    const void* x, const void* y, const void* c, const void* bias,
    const void* res, void* out, int in_dt, int c_dt, int bias_dt, int res_dt,
    int out_dt, int batch, int batched, int M, int N, int K, float alpha,
    float beta, int neg_product, int neg_acc, int act, int bn, void* stream) {
  if (K % 8 || N % 8 || K < 1 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(y) & 15))
    return (int)cudaErrorInvalidValue;  // TMA: 16-byte bases and pitches
  GemmEpi e;
  e.c = c; e.bias = bias; e.res = res; e.out = out;
  e.c_dt = c_dt; e.bias_dt = bias_dt; e.res_dt = res_dt; e.out_dt = out_dt;
  e.M = M; e.N = N;
  e.alpha = alpha; e.beta = beta;
  e.neg_product = neg_product; e.neg_acc = neg_acc; e.act = act;
  e.vec8 = 1;
  for (const void* p : {c, bias, res, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) & 15) e.vec8 = 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_BF16)
    return launch_wgmma_t<__nv_bfloat16>(x, y, e, K, batch, batched != 0, bn, s);
  if (in_dt == DT_F16)
    return launch_wgmma_t<__half>(x, y, e, K, batch, batched != 0, bn, s);
  return (int)cudaErrorInvalidValue;
}
