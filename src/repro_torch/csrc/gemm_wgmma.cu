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
//   * The ring's layout, the tile order, the consumers and the epilogue
//     are wgmma_tile.cuh's, shared with K3's wgmma conv (mma_conv.cu);
//     only the producer is this file's.
//   * The ABFT checksum sidecar (K1e: repro/kernels/mma_gemm.py's
//     checksum=True): with ck_col / ck_row set, the consumers write the
//     finished fp32 values back over the staged tile after their 16-byte
//     stores and sum its columns (one a thread) and rows (one a warp) in a
//     fixed order, one write per tile column and row; the stores are
//     untouched, so the output is the same bit for bit.
//   * Prepacked weights (K1d: repro/kernels/mma_gemm.py's packed_spec):
//     through gemm_wgmma_packed_launch, Y arrives as core/packing.py's
//     Y-side panels, (gn, gk,
//     64, 64) per batch element, zero-padded past K and N.  Its tensor map
//     is 4-D, [64, 64, gk, gn] (5-D with the batch), box [64, 64, 1, 1] at
//     (0, 0, k0 / 64, n0 / 64 + p): each box is one contiguous 8 KB panel,
//     and it lands in shared memory as the same swizzled bytes as the
//     natural 2-D box, so the consumers do not change and the result is
//     the natural launch's bit for bit.

#include "wgmma_tile.cuh"

template <typename T, int BN, bool BATCHED, bool PACKED>
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

  int m0, n0;
  wg_tile_origin<BN>(blockIdx.x, e.M, e.N, m0, n0);
  const int bz = blockIdx.y;
  const int kiters = (K + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
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
        if (PACKED && BATCHED) {
          tma_load_3d(as, &tma, &full[s], k0, m0, bz);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_5d(bs + p * 64 * 128, &tmb, &full[s], 0, 0, it,
                        n0 / 64 + p, bz);
        } else if (PACKED) {
          tma_load_2d(as, &tma, &full[s], k0, m0);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_4d(bs + p * 64 * 128, &tmb, &full[s], 0, 0, it,
                        n0 / 64 + p);
        } else if (BATCHED) {
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
    wg_consume<T, BN>(smem, full, empty, kiters, e, bz, m0, n0);
  }
}

template <typename T, int BN, bool BATCHED, bool PACKED>
static int run_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                     const GemmEpi& e, int K, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = WgCfg<BN>::smem;
  static bool ok = false;
  auto kernel = gemm_wgmma_kernel<T, BN, BATCHED, PACKED>;
  cudaError_t err = allow_smem(kernel, smem, &ok);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, WG_THREADS, smem, stream>>>(ta, tb, e, K);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
static int launch_wgmma(const void* x, const void* y, const GemmEpi& e, int K,
                        int batch, bool batched, bool y_packed,
                        cudaStream_t stream) {
  const uint64_t M = e.M, N = e.N, Kk = K, B = batch;
  CUtensorMap ta, tb;
  const uint64_t a_dims[3] = {Kk, M, B}, a_str[2] = {Kk * 2, M * Kk * 2};
  const uint32_t a_box[3] = {64, WG_BM, 1};
  const int rank = batched ? 3 : 2;
  int rc = tmap_16bit(&ta, x, rank, a_dims, a_str, a_box, 128);
  if (rc) return rc;
  if (y_packed) {
    // (B,) gn, gk, 64, 64 panels: one box a panel
    const uint64_t gk = (Kk + 63) / 64, gn = (N + 63) / 64;
    const uint64_t p_dims[5] = {64, 64, gk, gn, B};
    const uint64_t p_str[4] = {64 * 2, 64 * 64 * 2, gk * 64 * 64 * 2,
                               gn * gk * 64 * 64 * 2};
    const uint32_t p_box[5] = {64, 64, 1, 1, 1};
    rc = tmap_16bit(&tb, y, batched ? 5 : 4, p_dims, p_str, p_box, 128);
  } else {
    const uint64_t b_dims[3] = {N, Kk, B}, b_str[2] = {N * 2, Kk * N * 2};
    const uint32_t b_box[3] = {64, 64, 1};
    rc = tmap_16bit(&tb, y, rank, b_dims, b_str, b_box, 128);
  }
  if (rc) return rc;
  const int tiles = (int)(((M + WG_BM - 1) / WG_BM) * ((N + BN - 1) / BN));
  dim3 grid(tiles, batch);
  if (y_packed)
    return batched ? run_wgmma<T, BN, true, true>(ta, tb, e, K, grid, stream)
                   : run_wgmma<T, BN, false, true>(ta, tb, e, K, grid, stream);
  return batched ? run_wgmma<T, BN, true, false>(ta, tb, e, K, grid, stream)
                 : run_wgmma<T, BN, false, false>(ta, tb, e, K, grid, stream);
}

template <typename T>
static int launch_wgmma_t(const void* x, const void* y, const GemmEpi& e,
                          int K, int batch, bool batched, bool y_packed,
                          int bn, cudaStream_t s) {
  if (bn == 256)
    return launch_wgmma<T, 256>(x, y, e, K, batch, batched, y_packed, s);
  if (bn == 128)
    return launch_wgmma<T, 128>(x, y, e, K, batch, batched, y_packed, s);
  return (int)cudaErrorInvalidValue;
}

static int wgmma_launch(
    const void* x, const void* y, const void* c, const void* bias,
    const void* res, void* out, int in_dt, int c_dt, int bias_dt, int res_dt,
    int out_dt, int batch, int batched, int M, int N, int K, float alpha,
    float beta, int neg_product, int neg_acc, int act, int bn, float* ck_col,
    float* ck_row, void* stream, int y_packed) {
  if (K % 8 || N % 8 || K < 1 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(y) & 15))
    return (int)cudaErrorInvalidValue;  // TMA: 16-byte bases and pitches
  GemmEpi e;
  e.c = c; e.bias = bias; e.res = res; e.out = out;
  e.c_dt = c_dt; e.bias_dt = bias_dt; e.res_dt = res_dt; e.out_dt = out_dt;
  e.M = M; e.N = N;
  e.alpha = alpha; e.beta = beta;
  e.neg_product = neg_product; e.neg_acc = neg_acc; e.act = act;
  e.ck_col = ck_col; e.ck_row = ck_row;
  e.vec8 = 1;
  for (const void* p : {c, bias, res, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) & 15) e.vec8 = 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_BF16)
    return launch_wgmma_t<__nv_bfloat16>(x, y, e, K, batch, batched != 0,
                                         y_packed != 0, bn, s);
  if (in_dt == DT_F16)
    return launch_wgmma_t<__half>(x, y, e, K, batch, batched != 0,
                                  y_packed != 0, bn, s);
  return (int)cudaErrorInvalidValue;
}

// The launchers, one argument list: y as natural (K, N) rows, or as
// core/packing.py's Y-side panels; ck_col / ck_row the sidecar's outputs,
// ((B,) ceil(M / 128), N) and ((B,) M, ceil(N / bn)) fp32, or null.
extern "C" int gemm_wgmma_launch(
    const void* x, const void* y, const void* c, const void* bias,
    const void* res, void* out, int in_dt, int c_dt, int bias_dt, int res_dt,
    int out_dt, int batch, int batched, int M, int N, int K, float alpha,
    float beta, int neg_product, int neg_acc, int act, int bn, float* ck_col,
    float* ck_row, void* stream) {
  return wgmma_launch(x, y, c, bias, res, out, in_dt, c_dt, bias_dt, res_dt,
                      out_dt, batch, batched, M, N, K, alpha, beta,
                      neg_product, neg_acc, act, bn, ck_col, ck_row, stream,
                      0);
}

extern "C" int gemm_wgmma_packed_launch(
    const void* x, const void* y, const void* c, const void* bias,
    const void* res, void* out, int in_dt, int c_dt, int bias_dt, int res_dt,
    int out_dt, int batch, int batched, int M, int N, int K, float alpha,
    float beta, int neg_product, int neg_acc, int act, int bn, float* ck_col,
    float* ck_row, void* stream) {
  return wgmma_launch(x, y, c, bias, res, out, in_dt, c_dt, bias_dt, res_dt,
                      out_dt, batch, batched, M, N, K, alpha, beta,
                      neg_product, neg_acc, act, bn, ck_col, ck_row, stream,
                      1);
}
