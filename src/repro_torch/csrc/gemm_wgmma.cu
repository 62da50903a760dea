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
// At deepseek-7b's serving prefill (M = 256) it is the weight's bytes,
// and the grid decides how much of the card reads them: 128-column tiles
// left 68 of 132 SMs idle at N = 4096.
//
// Design.
//   * One block owns a (128, BN) output tile, BN = 64, 128, 192 or 256
//     (core/tiling.py's wgmma_plan: the narrow tiles fill the card at M =
//     256), and walks K in steps of 64.  Tiles are rastered in groups of
//     8 tile rows so that the blocks on the card at one time share their
//     Y panels in L2.  Persistent blocks that overlap a tile's epilogue
//     with the next tile's loads were built and timed on the H100 against
//     this grid (PERF.md): they won at no timed shape.
//   * Warp specialisation: warpgroup 0 is the producer (one thread issues
//     every TMA load; setmaxnreg gives its registers away); warpgroups 1
//     and 2 are consumers, each owning 64 rows of the tile as m64nBNk16
//     wgmma accumulators in registers (setmaxnreg 232).
//   * A ring of 8 (BN = 64), 7 (128), 5 (192) or 4 (256) stages in
//     shared memory (wgmma_tile.cuh's WgCfg), each
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
//   * Prepacked operands (K1d: repro/kernels/mma_gemm.py's packed_spec):
//     with `panels` set, Y arrives as core/packing.py's Y-side panels,
//     (gn, gk, 64, 64) per batch element, and/or X as its X-side panels,
//     (gm, gk, 128, 64), zero-padded past M, K and N.  Y's
//     tensor map is 4-D, [64, 64, gk, gn] (5-D with the batch), box
//     [64, 64, 1, 1] at (0, 0, k0 / 64, n0 / 64 + p); X's is [64, 128, gk,
//     gm] (5-D with the batch), box [64, 128, 1, 1] at (0, 0, k0 / 64,
//     m0 / 128), since a tile's 128 rows (WG_BM) are one X panel.  Each
//     box is one contiguous panel (8 or 16 KB), and it lands in shared
//     memory as the same swizzled bytes as the natural 2-D box, so the
//     consumers do not change and the result (and the sidecar) is the
//     natural launch's bit for bit.  A packed operand without a batch axis
//     beside a batched one is shared: its map has no batch coordinate.
//     How each operand is addressed (rows or panels, batched or not) is
//     the producer's AMAP / BMAP template arguments for the natural
//     launches and the Y-panel forms of prepacked serving (Y panels beside
//     X rows, both batched or neither), as before X panels existed, and a
//     runtime argument of its one thread for every form with X panels or a
//     shared operand (MAPS_ANY).

#include "wgmma_tile.cuh"

// How the producer addresses an operand's tensor map: natural rows (2-D,
// or 3-D with the batch) or core/packing.py's panels (4-D, or 5-D).
// MAPS_ANY: the operand's map is the kernel's a_map / b_map argument.
enum { MAP_ROWS = 0, MAP_ROWS_B = 1, MAP_PANELS = 2, MAP_PANELS_B = 3,
       MAPS_ANY = -1 };

template <typename T, int BN, int AMAP, int BMAP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma,
                      const __grid_constant__ CUtensorMap tmb, GemmEpi e,
                      int K, int a_map, int b_map) {
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
      const int am = AMAP == MAPS_ANY ? a_map : AMAP;
      const int bm = BMAP == MAPS_ANY ? b_map : BMAP;
      for (int it = 0; it < kiters; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], C::STAGE);
        unsigned char* as = smem + s * C::STAGE;
        unsigned char* bs = as + C::A_BYTES;
        const int k0 = it * WG_BK;
        if (am == MAP_ROWS)
          tma_load_2d(as, &tma, &full[s], k0, m0);
        else if (am == MAP_ROWS_B)
          tma_load_3d(as, &tma, &full[s], k0, m0, bz);
        else if (am == MAP_PANELS)
          tma_load_4d(as, &tma, &full[s], 0, 0, it, m0 / WG_BM);
        else
          tma_load_5d(as, &tma, &full[s], 0, 0, it, m0 / WG_BM, bz);
#pragma unroll
        for (int p = 0; p < BN / 64; ++p) {
          unsigned char* bp = bs + p * 64 * 128;
          if (bm == MAP_ROWS)
            tma_load_2d(bp, &tmb, &full[s], n0 + 64 * p, k0);
          else if (bm == MAP_ROWS_B)
            tma_load_3d(bp, &tmb, &full[s], n0 + 64 * p, k0, bz);
          else if (bm == MAP_PANELS)
            tma_load_4d(bp, &tmb, &full[s], 0, 0, it, n0 / 64 + p);
          else
            tma_load_5d(bp, &tmb, &full[s], 0, 0, it, n0 / 64 + p, bz);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each, accumulator in registers ----
    setmaxnreg_inc<232>();
    wg_consume<T, BN>(smem, full, empty, kiters, e, bz, m0, n0);
  }
}

// One operand's tensor map: natural rows (rows, cols) row-major, box
// (box_rows, 64) of the 64-element column block; or core/packing.py's
// panels (g_rows, gk, prow, 64), one box a panel.  `map` is a MAP_* code.
static int operand_map(CUtensorMap* t, const void* p, int map, uint64_t rows,
                       uint64_t cols, uint32_t box_rows, uint64_t prow,
                       uint64_t g_rows, uint64_t gk, uint64_t B) {
  if (map >= MAP_PANELS) {
    const uint64_t dims[5] = {64, prow, gk, g_rows, B};
    const uint64_t str[4] = {64 * 2, prow * 64 * 2, gk * prow * 64 * 2,
                             g_rows * gk * prow * 64 * 2};
    const uint32_t box[5] = {64, (uint32_t)prow, 1, 1, 1};
    return tmap_16bit(t, p, map == MAP_PANELS ? 4 : 5, dims, str, box, 128);
  }
  const uint64_t dims[3] = {cols, rows, B}, str[2] = {cols * 2,
                                                      rows * cols * 2};
  const uint32_t box[3] = {64, box_rows, 1};
  return tmap_16bit(t, p, map == MAP_ROWS ? 2 : 3, dims, str, box, 128);
}

template <typename T, int BN>
static int launch_wgmma(const void* x, const void* y, const GemmEpi& e, int K,
                        int batch, int a_map, int b_map, cudaStream_t stream) {
  const uint64_t M = e.M, N = e.N, Kk = K, B = batch;
  const uint64_t gk = (Kk + 63) / 64;
  CUtensorMap ta, tb;
  // X (M, K): 128-row boxes, or its (gm, gk, 128, 64) panels
  int rc = operand_map(&ta, x, a_map, M, Kk, WG_BM, WG_BM,
                       (M + WG_BM - 1) / WG_BM, gk, B);
  if (rc) return rc;
  // Y (K, N): 64 x 64 boxes of its rows, or its (gn, gk, 64, 64) panels
  rc = operand_map(&tb, y, b_map, Kk, N, 64, 64, (N + 63) / 64, gk, B);
  if (rc) return rc;
  const int tiles = (int)(((M + WG_BM - 1) / WG_BM) * ((N + BN - 1) / BN));
  constexpr size_t smem = WgCfg<BN>::smem;
  // natural rows and Y panels beside X rows, both batched or neither: a
  // producer with its maps fixed; every other form chooses at run time
  static bool ok[5] = {};
  int which = 4;
  if (a_map == MAP_ROWS && (b_map == MAP_ROWS || b_map == MAP_PANELS))
    which = b_map == MAP_ROWS ? 0 : 1;
  else if (a_map == MAP_ROWS_B && (b_map == MAP_ROWS_B ||
                                   b_map == MAP_PANELS_B))
    which = b_map == MAP_ROWS_B ? 2 : 3;
  auto kernel =
      which == 0   ? gemm_wgmma_kernel<T, BN, MAP_ROWS, MAP_ROWS>
      : which == 1 ? gemm_wgmma_kernel<T, BN, MAP_ROWS, MAP_PANELS>
      : which == 2 ? gemm_wgmma_kernel<T, BN, MAP_ROWS_B, MAP_ROWS_B>
      : which == 3 ? gemm_wgmma_kernel<T, BN, MAP_ROWS_B, MAP_PANELS_B>
                   : gemm_wgmma_kernel<T, BN, MAPS_ANY, MAPS_ANY>;
  cudaError_t err = allow_smem(kernel, smem, &ok[which]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles, batch), WG_THREADS, smem, stream>>>(ta, tb, e, K,
                                                          a_map, b_map);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_wgmma_t(const void* x, const void* y, const GemmEpi& e,
                          int K, int batch, int a_map, int b_map, int bn,
                          cudaStream_t s) {
  if (bn == 256)
    return launch_wgmma<T, 256>(x, y, e, K, batch, a_map, b_map, s);
  if (bn == 192)
    return launch_wgmma<T, 192>(x, y, e, K, batch, a_map, b_map, s);
  if (bn == 128)
    return launch_wgmma<T, 128>(x, y, e, K, batch, a_map, b_map, s);
  if (bn == 64)
    return launch_wgmma<T, 64>(x, y, e, K, batch, a_map, b_map, s);
  return (int)cudaErrorInvalidValue;
}

// The launcher: x and y as natural (M, K) and (K, N) rows (batched or
// not, as `batched` says), or either or both as core/packing.py's panels
// (panels: PANELS_X, PANELS_Y; 0: natural rows; a packed operand's batch
// stride sxb / syb in elements, 0 where it is shared across the batch);
// ck_col / ck_row the sidecar's outputs, ((B,) ceil(M / 128), N) and
// ((B,) M, ceil(N / bn)) fp32, or null.
extern "C" int gemm_wgmma_launch(
    const void* x, const void* y, const void* c, const void* bias,
    const void* res, void* out, int in_dt, int c_dt, int bias_dt, int res_dt,
    int out_dt, int batch, int batched, int M, int N, int K, float alpha,
    float beta, int neg_product, int neg_acc, int act, int bn, float* ck_col,
    float* ck_row, void* stream, int panels, long long sxb, long long syb) {
  if (K % 8 || N % 8 || K < 1 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(y) & 15))
    return (int)cudaErrorInvalidValue;  // TMA: 16-byte bases and pitches
  // a natural operand is batched with the launch, a packed one where its
  // batch stride is not 0 (else it is shared)
  const int a_map = (panels & PANELS_X) ? (sxb ? MAP_PANELS_B : MAP_PANELS)
                                        : (batched ? MAP_ROWS_B : MAP_ROWS);
  const int b_map = (panels & PANELS_Y) ? (syb ? MAP_PANELS_B : MAP_PANELS)
                                        : (batched ? MAP_ROWS_B : MAP_ROWS);
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
    return launch_wgmma_t<__nv_bfloat16>(x, y, e, K, batch, a_map, b_map, bn,
                                         s);
  if (in_dt == DT_F16)
    return launch_wgmma_t<__half>(x, y, e, K, batch, a_map, b_map, bn, s);
  return (int)cudaErrorInvalidValue;
}
