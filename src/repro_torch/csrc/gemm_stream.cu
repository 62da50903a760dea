// Split-K weight-stream GEMM for small M on Hopper (sm_90a): decode.
//
// Replaces the TPU kernel K1a (repro/kernels/mma_gemm.py, mma_gemm, kernel
// body _make_kernel) for the products whose M is a batch of tokens (decode
// M = 4, whisper's decoder prefill M = 16, the SSD's M = 1 products, the
// MoE expert banks: 64 products of up to 30 rows):
//
//     out = cast(residual + act(bias + alpha * ([-](X @ W) [+/- beta * C])))
//
// X (M <= 64, K) and W (K, N) in bf16 or f16 on the tensor cores, or in
// fp32 (F32GER) on the CUDA cores, fp32 accumulation, 2-D or batched.
//
// What bounds it on an H100.  The whole (K, N) weight is read once per
// call and each weight element meets M <= 64 rows of X: ~M flops per
// weight byte, far below the ~295 the tensor cores need, so the bound is
// bytes at 3.35 TB/s.  Reaching it needs every SM streaming with many
// bytes in flight, whatever the batch: a grid sized for one product ran
// the b = 64 expert banks as 16896 blocks of 5-6 stages, each paying a
// prologue, a partial and a ticket (0.30 of the bound at a prefill's cap
// of 30 rows; PERF.md).
//
// Design.
//   * The plan (core/tiling.py, stream_plan) fixes one product's K
//     partition: BN = 64 or 128 columns a tile and `split` K slices of
//     BK = 32-row stages, slice s owning stages [s * stages / split,
//     (s + 1) * stages / split), sized so that a single product at batch
//     1 holds at least two blocks per SM.  The partition, and so every
//     output bit, depends neither on b nor on M within a row bucket.
//   * Which block computes which slice does not fix a bit: the work is
//     (batch, N tile, run of `run` consecutive slices) units, and the grid
//     is sized to the card whatever b is (core/tiling.py, stream_run).  A
//     unit that owns every slice of its tile folds the slices' fp32
//     accumulators in split order in registers, 0 + p0 + p1 + ..., the
//     sum the parent's last block formed from its partials, and stores
//     the tile: no partial, no ticket, no workspace.  That is every unit
//     of a batch of products that fills the card alone (deepseek-moe-16b's
//     expert banks, b = 64).  Units of a tile whose slices span blocks
//     write one fp32 partial a slice into a (B, split, M, N) workspace
//     that the wrapper allocates per call; the last to arrive (an atomic
//     ticket) sums them in split order -- no float atomics, so a result
//     does not change from run to run -- and applies the seed, alpha and
//     the fused epilogue once.  It then sets the ticket back to 0: the
//     tickets are the wrapper's, one zeroed buffer a CUDA stream, so no
//     launch is preceded by a memset and no two streams share one.
//   * gemm_stream_tma_kernel (bf16/f16 where TMA reads both operands:
//     16-byte bases and pitches, or packed panels): persistent blocks of
//     four consumer warps and one producer warp.  One thread of the
//     producer keeps TMA copies in flight into a ring of 5-13 stages (50-88
//     KB a block, two to four blocks an SM), each stage the (32 k, BN)
//     weight panel as BN / 64 boxes in the 128-byte swizzled layout and
//     the (MP, 32 k) X panel in the 64-byte swizzled one, behind full and
//     empty mbarriers: the consumers wait on a stage's full barrier and
//     release it with one arrive a warp, so no block-wide barrier is
//     taken a stage.  TMA zero-fills the K, N and M fringes.
//   * The product runs on the tensor cores with the operands swapped:
//     out^T = W^T X^T, so W^T supplies mma.sync m16n8k16's 16-row side
//     (ldmatrix.trans from the row-major panel) and X its 8-column side:
//     M is padded only to a multiple of 8, not to a 64-row tile.  Each
//     slice's k16 steps run in ascending k, as in every earlier design.
//   * gemm_stream_kernel keeps the rows TMA cannot read (an unaligned
//     base or a pitch off 16 bytes, such as whisper's bf16 logits at N =
//     51865): a grid of (N tiles, split, batch) blocks, one slice each,
//     fed through a ring of 8 cp.async stages (16-byte chunks, a scalar
//     path for unaligned rows), one __syncthreads a stage.  It writes the
//     same partials and sums them the same way, so both kernels give the
//     same bits.
//   * The accumulators go through shared memory as an fp32 tile, so that
//     stores are coalesced and the epilogue is one loop.
//   * The ABFT checksum sidecar (K1e: repro/kernels/mma_gemm.py's
//     checksum=True): with ck_col / ck_row set, the block that stores an
//     N tile -- the one that folded it, or the last to arrive after it has
//     reduced the partials, never a partial -- writes the finished fp32
//     values back over its staged tile and sums the tile's M rows by
//     column (one column a thread) and its columns by row (one row a warp)
//     in a fixed order: ck_col (B, 1, N), ck_row (B, M, N tiles).  The
//     stores are untouched, so the output is the same bit for bit.
//   * Prepacked operands (K1d: repro/kernels/mma_gemm.py's packed_spec):
//     with `panels` set, the weight arrives as core/packing.py's Y-side
//     panels, (gn, gk, 64, 64) per batch element, and/or X as its X-side
//     panels, (gm, gk, 128, 64), both zero-padded past M, K and N
//     (common.cuh's y_panel_at / x_panel_at).  A 32-row stage of a 64-column
//     tile is half of one 8 KB panel: the TMA kernel's box at (0, k % 64,
//     k / 64, n / 64) of the panels' 4-D map (5-D with the batch), X's at
//     (k % 64, 0, k / 64, 0) of its own (X's M <= 64 rows lie in one
//     panel row block); the cp.async kernel reads the same 16-byte chunks
//     through y_panel_at / x_panel_at.  Either way the shared-memory
//     stages hold the natural layout's bytes, so the result (split or not,
//     with the sidecar or not) is the natural launch's bit for bit.  A
//     packed operand without a batch axis beside a batched one is shared:
//     its batch stride is 0 and its map has no batch coordinate.
//
// F32GER (fp32 X and W, true fp32 FMAs on the CUDA cores, never TF32): the
// same grid, ring, fringes, split-K reduction, sidecar and panels, with
// 4-byte elements (a 16-byte chunk holds 4 of them, so the chunked path needs
// K and N multiples of 4; whisper's 51865 fp32 columns take 4-byte
// copies).  Only the product differs (gemm_stream_f32_kernel): each thread
// owns CW adjacent output columns by RW rows of the row bucket, reads its
// columns of a staged weight row as one 4-, 8- or 16-byte shared load and 4 k
// of each of its X rows as one float4 (the threads of a load phase share one
// X row: a broadcast), and runs one fmaf chain an output in ascending k.  A
// split's partial of a row is thus the fmaf chain over that split's K rows,
// whatever M is, and F32GER's split does not depend on M
// (tiling.stream_plan), so a row is the same bits at every M <= 64: at batch
// 1 and batch 4 too.  What bounds it: the weight's bytes up to a bucket of 32
// rows (0.0539 ms for 4 x 4096 x 11008 at 3.35 TB/s), the FMAs at 64 (2 * 64
// * 4096 * 11008 / 67 TFLOP/s = 86 us); the stages are sized per bucket
// (StreamSmemF32) so that three blocks fit an SM.  Rows that are not 16-byte
// aligned go through 4-byte cp.async copies (an fp32 element is always 4-byte
// aligned), in flight with the ring as the chunks are.

#include "gemm_common.cuh"
#include "hopper.cuh"

constexpr int ST_BK = 32, ST_STAGES = 8, ST_THREADS = 128;

template <typename T, int BN, int MT>
struct StreamSmem {
  static constexpr int MP = 8 * MT;          // M padded to the mma's 8
  static constexpr int LDW = BN + 8;         // conflict-free ldmatrix.trans
  static constexpr int LDX = ST_BK + 8;
  static constexpr int W_ELEMS = ST_BK * LDW;
  static constexpr int X_ELEMS = MP * LDX;
  static constexpr int STAGE = W_ELEMS + X_ELEMS;
  static constexpr size_t ring = (size_t)ST_STAGES * STAGE * sizeof(T);
  static constexpr size_t ctile = (size_t)MP * (BN + 4) * sizeof(float);
  static constexpr size_t bytes = ring > ctile ? ring : ctile;
};

// The fp32 ring: W stages of (BK, BN) floats, unpadded (a load phase reads
// one contiguous run of a row), X stages of (MP, BK) floats.  STAGES per tile
// and bucket keep a block at 52-74 KB, so that three blocks fit an SM (the
// grid of two blocks an SM plus K's splits runs in one wave), four of the
// 128-column tile at buckets 8 and 16 (the logits' unsplit grids of 406-800
// tiles), with 32-56 KB of weight in flight a block.  A thread owns CW
// adjacent columns (COLT threads across the BN columns) by RW rows: RW is 4
// at bucket 8, 8 above, 16 at (128, 64).
template <int BN, int MT>
struct StreamSmemF32 {
  static constexpr int MP = 8 * MT;
  static constexpr int LDW = BN;
  static constexpr int LDX = ST_BK;
  static constexpr int W_ELEMS = ST_BK * LDW;
  static constexpr int X_ELEMS = MP * LDX;
  static constexpr int STAGE = W_ELEMS + X_ELEMS;
  static constexpr int STAGES =
      BN == 128 ? 3 : (MP == 8 ? 8 : MP == 16 ? 7 : MP == 32 ? 6 : 4);
  static constexpr size_t ring = (size_t)STAGES * STAGE * sizeof(float);
  static constexpr size_t ctile = (size_t)MP * (BN + 4) * sizeof(float);
  static constexpr size_t bytes = ring > ctile ? ring : ctile;
  static constexpr int CW0 = MP * BN / (ST_THREADS * 8);
  static constexpr int CW = CW0 < 1 ? 1 : (CW0 > 4 ? 4 : CW0);
  static constexpr int COLT = BN / CW;
  static constexpr int RW = MP / (ST_THREADS / COLT);
  static_assert(RW >= 4 && RW % 4 == 0 && COLT >= 16, "fp32 stream layout");
};

struct StreamArgs {
  const void* x;
  const void* w;
  float* ws;     // (B, split, M, N) fp32 partials, where slices span blocks
  int* tickets;  // (B, N tiles), 0 at launch; the last block resets its own
  GemmEpi e;
  int K, split, stages;
  int vec;       // 16-byte aligned rows of X and W: cp.async
  int vec_x;     // X alone (packed weights are always chunked)
  int w_gk, x_gk;          // panels along K (0: natural rows)
  long long sxb, swb;      // batch strides in elements (0: shared)
};

// One stage of the ring: the (BK, BN) weight panel and the (MP, BK) X
// panel, in 16-byte chunks of E = 16 / sizeof(T) elements (8 bf16/f16, 4
// fp32), into the layout L's rows.
template <typename T, int BN, typename L>
__device__ __forceinline__ void stream_load_stage(T* ws_, T* xs_,
                                                  const T* x, const T* w,
                                                  int M, int N, int K, int n0,
                                                  int k0, bool vec,
                                                  bool vec_x, int w_gk,
                                                  int x_gk) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int WCH = BN / E;  // 16-byte chunks per weight row
  constexpr int XCH = ST_BK / E;
  if (w_gk > 0) {
    // packed panels: every chunk lies inside one zero-padded panel row
    for (int i = threadIdx.x; i < ST_BK * WCH; i += ST_THREADS) {
      const int r = i / WCH, c = (i % WCH) * E;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < K && gn < N;
      cp_async16(ws_ + r * L::LDW + c, in ? w + y_panel_at(gk, gn, w_gk) : w,
                 in);
    }
  } else if (vec) {
    for (int i = threadIdx.x; i < ST_BK * WCH; i += ST_THREADS) {
      const int r = i / WCH, c = (i % WCH) * E;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < K && gn < N;
      cp_async16(ws_ + r * L::LDW + c, in ? w + (long long)gk * N + gn : w, in);
    }
  } else if constexpr (sizeof(T) == 4) {
    // fp32 rows that are not 16-byte aligned (whisper's N = 51865): one
    // 4-byte cp.async an element, consecutive threads on consecutive
    // columns, in flight with the ring like the chunks
    for (int i = threadIdx.x; i < ST_BK * BN; i += ST_THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < K && gn < N;
      cp_async4(ws_ + r * L::LDW + c, in ? w + (long long)gk * N + gn : w,
                in);
    }
  } else {
    // Rows that are not 16-byte aligned: element loads.  A thread owns one
    // column of the panel and every RSTEP-th row; all its loads are issued
    // before any is stored, so that they are in flight together.
    constexpr int RSTEP = ST_THREADS / BN, ROWS = ST_BK / RSTEP;
    const int c = threadIdx.x % BN, r0 = threadIdx.x / BN;
    const bool col_in = n0 + c < N;
    const T* p = w + (long long)(k0 + r0) * N + n0 + c;
    const long long step = (long long)RSTEP * N;
    T v[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
      v[u] = (col_in && k0 + r0 + u * RSTEP < K) ? __ldg(p + u * step)
                                                 : zero_of<T>();
#pragma unroll
    for (int u = 0; u < ROWS; ++u) ws_[(r0 + u * RSTEP) * L::LDW + c] = v[u];
  }
  if (x_gk > 0) {
    // X panels: each chunk lies inside one zero-padded panel row
    for (int i = threadIdx.x; i < L::MP * XCH; i += ST_THREADS) {
      const int r = i / XCH, c = (i % XCH) * E;
      const int gk = k0 + c;
      const bool in = r < M && gk < K;
      cp_async16(xs_ + r * L::LDX + c, in ? x + x_panel_at(r, gk, x_gk) : x,
                 in);
    }
  } else if (w_gk > 0 ? vec_x : vec) {
    for (int i = threadIdx.x; i < L::MP * XCH; i += ST_THREADS) {
      const int r = i / XCH, c = (i % XCH) * E;
      const int gk = k0 + c;
      const bool in = r < M && gk < K;
      cp_async16(xs_ + r * L::LDX + c, in ? x + (long long)r * K + gk : x, in);
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int i = threadIdx.x; i < L::MP * ST_BK; i += ST_THREADS) {
      const int r = i / ST_BK, c = i % ST_BK;
      const int gk = k0 + c;
      const bool in = r < M && gk < K;
      cp_async4(xs_ + r * L::LDX + c, in ? x + (long long)r * K + gk : x,
                in);
    }
  } else {
    for (int i = threadIdx.x; i < L::MP * ST_BK; i += ST_THREADS) {
      const int r = i / ST_BK, c = i % ST_BK;
      const int gk = k0 + c;
      xs_[r * L::LDX + c] =
          (r < M && gk < K) ? x[(long long)r * K + gk] : zero_of<T>();
    }
  }
}

// The sidecar of one (M, BN) N tile from its finished fp32 values, staged
// in ct (row pitch BN + 4): gm = 1, gn = the grid's N tiles.
template <int BN>
__device__ __forceinline__ void stream_checksums(const float* ct,
                                                 const GemmEpi& e, int bz,
                                                 int nt, int gn) {
  __syncthreads();  // every finished value is in ct
  const int n0 = nt * BN;
  tile_checksums<float>(ct, BN + 4, e.M, min(BN, e.N - n0),
                        e.ck_col + (long long)bz * e.N + n0,
                        e.ck_row + (long long)bz * e.M * gn + nt, gn,
                        threadIdx.x, ST_THREADS);
}

// The store of one N tile from its fp32 accumulators, staged in ct (row
// pitch BN + 4): with one split, finished and stored straight from ct;
// with K split, the partial written to the workspace, and the last block
// of the N tile to arrive (the atomic ticket) sums the partials in split
// order and finishes them.  With the sidecar, the finished values go back
// over ct and the block that stores the tile sums it.
template <int BN>
__device__ __forceinline__ void stream_store(float* ct, const StreamArgs& a,
                                             int bz, int nt, int s,
                                             int* last_block) {
  constexpr int LDC = BN + 4;
  const GemmEpi& e = a.e;
  const int M = e.M, N = e.N;
  const int n0 = nt * BN;
  const bool ck = e.ck_col != nullptr;
  if (a.split == 1) {
    for (int i = threadIdx.x; i < M * BN; i += ST_THREADS) {
      const int m = i / BN, c = i % BN;
      if (n0 + c >= N) continue;
      const float v = gemm_finish(e, bz, m, n0 + c, ct[m * LDC + c]);
      store_f(e.out, e.out_dt, ((long long)bz * M + m) * N + n0 + c, v);
      if (ck) ct[m * LDC + c] = v;
    }
    if (ck) stream_checksums<BN>(ct, e, bz, nt, gridDim.x);
    return;
  }
  float* part = a.ws + ((long long)bz * a.split + s) * M * N;
  for (int i = threadIdx.x; i < M * BN; i += ST_THREADS) {
    const int m = i / BN, c = i % BN;
    if (n0 + c < N) part[(long long)m * N + n0 + c] = ct[m * LDC + c];
  }
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (long long)bz * gridDim.x + nt;
  if (threadIdx.x == 0) {
    *last_block = atomicAdd(ticket, 1) == a.split - 1;
    if (*last_block) *ticket = 0;  // zero again for the stream's next launch
  }
  __syncthreads();
  if (!*last_block) return;
  __threadfence();
  const float* base = a.ws + (long long)bz * a.split * M * N;
  for (int i = threadIdx.x; i < M * BN; i += ST_THREADS) {
    const int m = i / BN, n = n0 + i % BN;
    if (n >= N) continue;
    const float* src = base + (long long)m * N + n;
    const long long pitch = (long long)M * N;
    float v = 0.f;
    for (int p0 = 0; p0 < a.split; p0 += 8) {
      float pv[8];  // eight loads in flight, then summed in split order
#pragma unroll
      for (int u = 0; u < 8; ++u)
        pv[u] = p0 + u < a.split ? __ldcg(src + (p0 + u) * pitch) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (p0 + u < a.split) v += pv[u];
    }
    v = gemm_finish(e, bz, m, n, v);
    store_f(e.out, e.out_dt, ((long long)bz * M + m) * N + n, v);
    if (ck) ct[m * LDC + i % BN] = v;
  }
  if (ck) stream_checksums<BN>(ct, e, bz, nt, gridDim.x);
}

template <typename T, int BN, int MT>
__global__ void __launch_bounds__(ST_THREADS)
    gemm_stream_kernel(StreamArgs a) {
  using L = StreamSmem<T, BN, MT>;
  constexpr int WN = BN / 4;    // weight columns per warp
  constexpr int FM = WN / 16;   // m16 tiles (of W^T rows) per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int last_block;

  const GemmEpi& e = a.e;
  const int M = e.M, N = e.N, K = a.K;
  const int nt = blockIdx.x, s = blockIdx.y, bz = blockIdx.z;
  const int n0 = nt * BN;
  const T* x = reinterpret_cast<const T*>(a.x) + (long long)bz * a.sxb;
  const T* w = reinterpret_cast<const T*>(a.w) + (long long)bz * a.swb;
  const int st0 = (int)((long long)s * a.stages / a.split);
  const int st1 = (int)((long long)(s + 1) * a.stages / a.split);
  const int nst = st1 - st0;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float acc[FM][MT][4];
#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[f][j][q] = 0.f;

  // prologue: stages 0 .. ST_STAGES - 2 in flight (not unrolled: each
  // stage's loads would hold their own address registers)
#pragma unroll 1
  for (int i = 0; i < ST_STAGES - 1; ++i) {
    if (i < nst) {
      T* st = smem + i * L::STAGE;
      stream_load_stage<T, BN, L>(st, st + L::W_ELEMS, x, w, M, N, K, n0,
                                   (st0 + i) * ST_BK, vec, a.vec_x != 0,
                                   a.w_gk, a.x_gk);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  for (int i = 0; i < nst; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(ST_STAGES - 2) : "memory");
    __syncthreads();  // stage i landed; stage i - 1's buffer is free
    {
      const int nxt = i + ST_STAGES - 1;
      if (nxt < nst) {
        T* st = smem + (nxt % ST_STAGES) * L::STAGE;
        stream_load_stage<T, BN, L>(st, st + L::W_ELEMS, x, w, M, N, K, n0,
                                     (st0 + nxt) * ST_BK, vec, a.vec_x != 0,
                                     a.w_gk, a.x_gk);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const T* ws_ = smem + (i % ST_STAGES) * L::STAGE;
    const T* xs_ = ws_ + L::W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < ST_BK; kk += 16) {
      uint32_t af[FM][4];
#pragma unroll
      for (int f = 0; f < FM; ++f) {
        // W^T (16 x 16) from the row-major (k, n) panel, transposed
        const int q = lane / 8, r = lane % 8;
        const T* p = ws_ + (kk + (q >> 1) * 8 + r) * L::LDW + warp * WN +
                     f * 16 + (q & 1) * 8;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(af[f][0]), "=r"(af[f][1]), "=r"(af[f][2]), "=r"(af[f][3])
            : "r"(smem_u32(p)));
      }
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        // X^T (16 x 8) from X's (m, k) rows
        const int q = (lane / 8) & 1, r = lane % 8;
        const T* p = xs_ + (j * 8 + r) * L::LDX + kk + q * 8;
        uint32_t b0, b1;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
            : "=r"(b0), "=r"(b1)
            : "r"(smem_u32(p)));
#pragma unroll
        for (int f = 0; f < FM; ++f) mma16816<T>(acc[f][j], af[f], b0, b1);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the ring is free: the tile goes through it

  // acc[f][j]: out^T rows n = warp*WN + f*16 + g (+8), columns
  // m = j*8 + 2t (+1); into a (MP, BN) fp32 tile for coalesced stores
  constexpr int LDC = BN + 4;
  float* ct = reinterpret_cast<float*>(smem_raw);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ct[(j * 8 + 2 * t + (q & 1)) * LDC + warp * WN + f * 16 + g +
           (q >= 2 ? 8 : 0)] = acc[f][j][q];
  __syncthreads();

  stream_store<BN>(ct, a, bz, nt, s, &last_block);
}

// ---------------------------------------------------------------------
// The 16-bit stream on Hopper: a TMA producer and persistent work units
// (head comment).
// ---------------------------------------------------------------------

// Four consumer warps (each BN / 4 weight columns, as in
// gemm_stream_kernel) and one producer warp.  OCC blocks an SM: four at
// BN = 64 on one row block, two at 64 rows of BN = 128, else three (as many
// as the instance's registers allow at 160 threads: ptxas puts them at
// 94-143, 110-167 at BN = 128).  The ring fills the rest of a block's
// share of the SM's shared memory, at most S2_MAX_STAGES stages: 10-13
// stages (50-88 KB) at BN = 64, 5-7 (50-72 KB) at BN = 128 (core/tiling.py
// mirrors it: stream_tma_stages, stream_tma_smem_bytes).
constexpr int S2_CONSUMER_WARPS = 4;
constexpr int S2_CONSUMERS = 32 * S2_CONSUMER_WARPS;
constexpr int S2_THREADS = S2_CONSUMERS + 32;
constexpr int S2_MAX_STAGES = 16;
constexpr int SM_SMEM_BYTES = 233472;  // an SM's shared memory (228 KB)

template <int BN, int MT>
struct StreamTmaCfg {
  static constexpr int MP = 8 * MT;
  static constexpr int W_BOX = ST_BK * 128;          // (32 k, 64 n): 4 KB
  static constexpr int W_BYTES = BN / 64 * W_BOX;
  static constexpr int X_BYTES = MP * ST_BK * 2;     // MP rows of 64 bytes
  static constexpr int STAGE = (W_BYTES + X_BYTES + 1023) / 1024 * 1024;
  static constexpr int LDC = BN + 4;
  static constexpr int CT = MP * LDC * 4;             // the fp32 tile
  static constexpr int OCC =
      BN == 64 && MT == 1 ? 4 : (BN == 128 && MT == 8 ? 2 : 3);
  // a block's share, less 1 KB the SM reserves a block, 1 KB of alignment
  // slack, the tile and the barriers
  static constexpr int FIT = (SM_SMEM_BYTES / OCC - 2048 - CT -
                              2 * S2_MAX_STAGES * 8) / STAGE;
  static constexpr int STAGES = FIT < S2_MAX_STAGES ? FIT : S2_MAX_STAGES;
  static constexpr int smem = STAGES * STAGE + CT + 2 * STAGES * 8 + 1024;
};

// How an operand's tensor map is addressed: natural rows (2-D, or 3-D
// with the batch) or core/packing.py's panels (4-D, or 5-D).
enum { SMAP_ROWS = 0, SMAP_ROWS_B = 1, SMAP_PANELS = 2, SMAP_PANELS_B = 3 };

// A launch's work: `units` (batch, N tile, slice run) units, a tile's
// slices cut into `runs` runs of `run` (the last may be shorter), `tiles`
// N tiles a product; the operands' map kinds.
struct StreamWork {
  int units, run, runs, tiles;
  int w_map, x_map;
};

__device__ __forceinline__ int stream_cut(int s, const StreamArgs& a) {
  return (int)((long long)s * a.stages / a.split);
}

// Unit u: product bz, N tile nt, slices [s0, s1).
__device__ __forceinline__ void stream_unit(int u, const StreamWork& w,
                                            int split, int& bz, int& nt,
                                            int& s0, int& s1) {
  const int r = u % w.runs, t = u / w.runs;
  nt = t % w.tiles;
  bz = t / w.tiles;
  s0 = r * w.run;
  s1 = min(split, s0 + w.run);
}

// The producer's one thread: every stage of every unit of this block, in
// the consumers' order, into the ring.
template <int BN, typename C>
__device__ __forceinline__ void stream_tma_produce(
    const CUtensorMap* tw, const CUtensorMap* tx, unsigned char* ring,
    uint64_t* full, uint64_t* empty, const StreamArgs& a,
    const StreamWork& w) {
  int it = 0;
  for (int u = blockIdx.x; u < w.units; u += gridDim.x) {
    int bz, nt, s0, s1;
    stream_unit(u, w, a.split, bz, nt, s0, s1);
    const int st1 = stream_cut(s1, a);
    for (int st = stream_cut(s0, a); st < st1; ++st, ++it) {
      const int slot = it % C::STAGES;
      if (it >= C::STAGES) mbar_wait(&empty[slot], ((it / C::STAGES) - 1) & 1);
      unsigned char* sb = ring + slot * C::STAGE;
      mbar_expect_tx(&full[slot], C::W_BYTES + C::X_BYTES);
      const int k0 = st * ST_BK;
#pragma unroll
      for (int p = 0; p < BN / 64; ++p) {
        unsigned char* wp = sb + p * C::W_BOX;
        const int n64 = nt * (BN / 64) + p;
        if (w.w_map == SMAP_ROWS)
          tma_load_2d(wp, tw, &full[slot], n64 * 64, k0);
        else if (w.w_map == SMAP_ROWS_B)
          tma_load_3d(wp, tw, &full[slot], n64 * 64, k0, bz);
        else if (w.w_map == SMAP_PANELS)
          tma_load_4d(wp, tw, &full[slot], 0, k0 % 64, k0 / 64, n64);
        else
          tma_load_5d(wp, tw, &full[slot], 0, k0 % 64, k0 / 64, n64, bz);
      }
      unsigned char* xp = sb + C::W_BYTES;
      if (w.x_map == SMAP_ROWS)
        tma_load_2d(xp, tx, &full[slot], k0, 0);
      else if (w.x_map == SMAP_ROWS_B)
        tma_load_3d(xp, tx, &full[slot], k0, 0, bz);
      else if (w.x_map == SMAP_PANELS)
        tma_load_4d(xp, tx, &full[slot], k0 % 64, 0, k0 / 64, 0);
      else
        tma_load_5d(xp, tx, &full[slot], k0 % 64, 0, k0 / 64, 0, bz);
    }
  }
}

// acc[f][j] (out^T rows n = warp*WN + f*16 + g (+8), columns m = j*8 + 2t
// (+1)) into the (MP, BN) fp32 tile ct, after the consumers are done with
// its last contents.
template <int BN, int MT, typename C>
__device__ __forceinline__ void stream_tma_stage_tile(
    float* ct, const float (&acc)[BN / 64][MT][4], int warp, int lane) {
  constexpr int WN = BN / 4, FM = WN / 16;
  const int g = lane / 4, t = lane % 4;
  named_bar_sync(1, S2_CONSUMERS);
#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ct[(j * 8 + 2 * t + (q & 1)) * C::LDC + warp * WN + f * 16 + g +
           (q >= 2 ? 8 : 0)] = acc[f][j][q];
  named_bar_sync(1, S2_CONSUMERS);
}

// The finished tile (fp32 sums staged in ct, or, with `parts`, read from
// the workspace and summed in split order) stored with the seed, alpha and
// the epilogue; with the sidecar, its sums.
template <int BN, typename C>
__device__ __forceinline__ void stream_tma_finish(float* ct,
                                                  const StreamArgs& a,
                                                  const StreamWork& w, int bz,
                                                  int nt, bool parts) {
  const GemmEpi& e = a.e;
  const int M = e.M, N = e.N, n0 = nt * BN, tid = threadIdx.x;
  const bool ck = e.ck_col != nullptr;
  const float* base = a.ws + (long long)bz * a.split * M * N;
  const long long pitch = (long long)M * N;
  for (int i = tid; i < M * BN; i += S2_CONSUMERS) {
    const int m = i / BN, c = i % BN, n = n0 + c;
    if (n >= N) continue;
    float v;
    if (parts) {
      const float* src = base + (long long)m * N + n;
      v = 0.f;
      for (int p0 = 0; p0 < a.split; p0 += 8) {
        float pv[8];  // eight loads in flight, then summed in split order
#pragma unroll
        for (int q = 0; q < 8; ++q)
          pv[q] = p0 + q < a.split ? __ldcg(src + (p0 + q) * pitch) : 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (p0 + q < a.split) v += pv[q];
      }
    } else {
      v = ct[m * C::LDC + c];
    }
    v = gemm_finish(e, bz, m, n, v);
    store_f(e.out, e.out_dt, ((long long)bz * M + m) * N + n, v);
    if (ck) ct[m * C::LDC + c] = v;
  }
  if (ck) {
    named_bar_sync(1, S2_CONSUMERS);  // every finished value is in ct
    tile_checksums<float>(ct, C::LDC, M, min(BN, N - n0),
                          e.ck_col + (long long)bz * N + n0,
                          e.ck_row + (long long)bz * M * w.tiles + nt,
                          w.tiles, tid, S2_CONSUMERS);
  }
}

template <typename T, int BN, int MT>
__global__ void __launch_bounds__(S2_THREADS, (StreamTmaCfg<BN, MT>::OCC))
    gemm_stream_tma_kernel(const __grid_constant__ CUtensorMap tw,
                           const __grid_constant__ CUtensorMap tx,
                           StreamArgs a, StreamWork w) {
  using C = StreamTmaCfg<BN, MT>;
  constexpr int STAGES = C::STAGES, WN = BN / 4, FM = WN / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* ct = reinterpret_cast<float*>(ring + STAGES * C::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE +
                                               C::CT);
  uint64_t* empty = full + STAGES;
  __shared__ int last_unit;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S2_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == S2_CONSUMER_WARPS) {
    if (lane == 0) stream_tma_produce<BN, C>(&tw, &tx, ring, full, empty, a, w);
    return;
  }

  const int M = a.e.M, N = a.e.N;
  int it = 0;
  for (int u = blockIdx.x; u < w.units; u += gridDim.x) {
    int bz, nt, s0, s1;
    stream_unit(u, w, a.split, bz, nt, s0, s1);
    const int n0 = nt * BN;
    const bool whole = w.runs == 1;
    float tot[FM][MT][4];
    for (int s = s0; s < s1; ++s) {
      float acc[FM][MT][4];
#pragma unroll
      for (int f = 0; f < FM; ++f)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[f][j][q] = 0.f;
      const int st1 = stream_cut(s + 1, a);
      for (int st = stream_cut(s, a); st < st1; ++st, ++it) {
        const int slot = it % STAGES;
        mbar_wait(&full[slot], (it / STAGES) & 1);
        const unsigned char* ws_ = ring + slot * C::STAGE;
        const unsigned char* xs_ = ws_ + C::W_BYTES;
#pragma unroll
        for (int kk = 0; kk < ST_BK; kk += 16) {
          uint32_t af[FM][4];
#pragma unroll
          for (int f = 0; f < FM; ++f) {
            // W^T (16 x 16) from the swizzled row-major (k, n) boxes
            const int q = lane / 8, r = lane % 8;
            const int k = kk + (q >> 1) * 8 + r;
            const int n = warp * WN + f * 16 + (q & 1) * 8;
            const unsigned char* p = ws_ + (n / 64) * C::W_BOX + k * 128 +
                                     ((((n % 64) / 8) ^ (k & 7)) << 4);
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
                "%3}, [%4];\n"
                : "=r"(af[f][0]), "=r"(af[f][1]), "=r"(af[f][2]),
                  "=r"(af[f][3])
                : "r"(smem_u32(p)));
          }
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            // X^T (16 x 8) from X's swizzled (m, k) rows
            const int q = (lane / 8) & 1, r = lane % 8;
            const int m = j * 8 + r, c = kk / 8 + q;
            const unsigned char* p = xs_ + m * 64 + ((c ^ ((m >> 1) & 3)) << 4);
            uint32_t b0, b1;
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                : "=r"(b0), "=r"(b1)
                : "r"(smem_u32(p)));
#pragma unroll
            for (int f = 0; f < FM; ++f) mma16816<T>(acc[f][j], af[f], b0, b1);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
      if (whole) {
        // the split-order sum, 0 + p0 + p1 + ..., as the parent's last
        // block formed it; one slice is stored as it is
#pragma unroll
        for (int f = 0; f < FM; ++f)
#pragma unroll
          for (int j = 0; j < MT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              tot[f][j][q] = a.split == 1 ? acc[f][j][q]
                             : __fadd_rn(s == 0 ? 0.f : tot[f][j][q],
                                         acc[f][j][q]);
      } else {
        // slice s's partial
        stream_tma_stage_tile<BN, MT, C>(ct, acc, warp, lane);
        float* part = a.ws + ((long long)bz * a.split + s) * M * N;
        for (int i = threadIdx.x; i < M * BN; i += S2_CONSUMERS) {
          const int m = i / BN, c = i % BN;
          if (n0 + c < N) part[(long long)m * N + n0 + c] = ct[m * C::LDC + c];
        }
      }
    }
    if (whole) {
      stream_tma_stage_tile<BN, MT, C>(ct, tot, warp, lane);
      stream_tma_finish<BN, C>(ct, a, w, bz, nt, false);
      continue;
    }
    __threadfence();
    named_bar_sync(1, S2_CONSUMERS);
    if (threadIdx.x == 0) {
      int* ticket = a.tickets + (long long)bz * w.tiles + nt;
      last_unit = atomicAdd(ticket, 1) == w.runs - 1;
      if (last_unit) *ticket = 0;  // zero again for the stream's next launch
    }
    named_bar_sync(1, S2_CONSUMERS);
    if (last_unit) {
      __threadfence();
      stream_tma_finish<BN, C>(ct, a, w, bz, nt, true);
    }
  }
}

// CW adjacent floats of a staged weight row as one 4-, 8- or 16-byte load.
template <int CW>
__device__ __forceinline__ void load_cols(float (&v)[CW], const float* p) {
  if constexpr (CW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (CW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// F32GER on the weight stream: the ring of gemm_stream_kernel with fp32
// stages, and the product as fmaf chains on the CUDA cores (head comment).
template <int BN, int MT>
__global__ void __launch_bounds__(ST_THREADS)
    gemm_stream_f32_kernel(StreamArgs a) {
  using L = StreamSmemF32<BN, MT>;
  constexpr int CW = L::CW, RW = L::RW, STAGES = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  __shared__ int last_block;

  const GemmEpi& e = a.e;
  const int M = e.M, N = e.N, K = a.K;
  const int nt = blockIdx.x, s = blockIdx.y, bz = blockIdx.z;
  const int n0 = nt * BN;
  const float* x = reinterpret_cast<const float*>(a.x) + (long long)bz * a.sxb;
  const float* w = reinterpret_cast<const float*>(a.w) + (long long)bz * a.swb;
  const int st0 = (int)((long long)s * a.stages / a.split);
  const int st1 = (int)((long long)(s + 1) * a.stages / a.split);
  const int nst = st1 - st0;
  const bool vec = a.vec != 0;
  // this thread's outputs: columns cg * CW .., rows rg * RW ..
  const int cg = threadIdx.x % L::COLT, rg = threadIdx.x / L::COLT;

  float acc[RW][CW];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;

#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) {
      float* st = smem + i * L::STAGE;
      stream_load_stage<float, BN, L>(st, st + L::W_ELEMS, x, w, M, N, K,
                                      n0, (st0 + i) * ST_BK, vec,
                                      a.vec_x != 0, a.w_gk, a.x_gk);
    }
    cp_async_commit();
  }

  for (int i = 0; i < nst; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed; stage i - 1's buffer is free
    {
      const int nxt = i + STAGES - 1;
      if (nxt < nst) {
        float* st = smem + (nxt % STAGES) * L::STAGE;
        stream_load_stage<float, BN, L>(st, st + L::W_ELEMS, x, w, M, N, K,
                                        n0, (st0 + nxt) * ST_BK, vec,
                                        a.vec_x != 0, a.w_gk, a.x_gk);
      }
      cp_async_commit();
    }
    const float* wp = smem + (i % STAGES) * L::STAGE + cg * CW;
    const float* xp = smem + (i % STAGES) * L::STAGE + L::W_ELEMS +
                      rg * RW * L::LDX;
#pragma unroll
    for (int kq = 0; kq < ST_BK; kq += 4) {
      float4 xv[RW];  // 4 k of each of this thread's rows
#pragma unroll
      for (int r = 0; r < RW; ++r)
        xv[r] = *reinterpret_cast<const float4*>(xp + r * L::LDX + kq);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float wv[CW];
        load_cols<CW>(wv, wp + (kq + u) * L::LDW);
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
          for (int j = 0; j < CW; ++j)
            acc[r][j] = fmaf(lane4(xv[r], u), wv[j], acc[r][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the tile goes through it

  constexpr int LDC = BN + 4;
  float* ct = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int j = 0; j < CW; ++j)
      ct[(rg * RW + r) * LDC + cg * CW + j] = acc[r][j];
  __syncthreads();
  stream_store<BN>(ct, a, bz, nt, s, &last_block);
}

template <int BN, int MT>
static int launch_stream_f32(const StreamArgs& a, int batch,
                             cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t smem = StreamSmemF32<BN, MT>::bytes;
  auto kernel = gemm_stream_f32_kernel<BN, MT>;
  cudaError_t err = allow_smem(kernel, smem, &smem_ok);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.e.N + BN - 1) / BN, a.split, batch);
  kernel<<<grid, ST_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BN>
static int launch_stream_f32_m(const StreamArgs& a, int batch,
                               cudaStream_t s) {
  const int M = a.e.M;
  if (M <= 8) return launch_stream_f32<BN, 1>(a, batch, s);
  if (M <= 16) return launch_stream_f32<BN, 2>(a, batch, s);
  if (M <= 32) return launch_stream_f32<BN, 4>(a, batch, s);
  if (M <= 64) return launch_stream_f32<BN, 8>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int BN, int MT>
static int launch_stream(const StreamArgs& a, int batch, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t smem = StreamSmem<T, BN, MT>::bytes;
  auto kernel = gemm_stream_kernel<T, BN, MT>;
  cudaError_t err = allow_smem(kernel, smem, &smem_ok);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.e.N + BN - 1) / BN, a.split, batch);
  kernel<<<grid, ST_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
static int launch_stream_m(const StreamArgs& a, int batch, cudaStream_t s) {
  const int M = a.e.M;
  if (M <= 8) return launch_stream<T, BN, 1>(a, batch, s);
  if (M <= 16) return launch_stream<T, BN, 2>(a, batch, s);
  if (M <= 32) return launch_stream<T, BN, 4>(a, batch, s);
  if (M <= 64) return launch_stream<T, BN, 8>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_stream_t(const StreamArgs& a, int batch, int bn,
                           cudaStream_t s) {
  if (bn == 128) return launch_stream_m<T, 128>(a, batch, s);
  if (bn == 64) return launch_stream_m<T, 64>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

// The TMA kernel's tensor maps: W (K, N) natural rows, box (64, 32) of a
// 64-column block, or its (gn, gk, 64, 64) panels, box (64, 32, 1, 1);
// X (M, K) natural rows, box (32, MP), or its (gm, gk, 128, 64) panels,
// box (32, MP, 1, 1); the batch last where the operand is batched (its
// batch stride, in elements, is not 0).  W's boxes land 128-byte
// swizzled, X's 64-byte swizzled.
static int stream_maps(CUtensorMap* tw, CUtensorMap* tx, const StreamArgs& a,
                       int batch, int mp, int& w_map, int& x_map) {
  const uint64_t K = a.K, M = a.e.M, N = a.e.N, B = batch;
  const uint64_t gk = (K + 63) / 64, gn = (N + 63) / 64, gm = (M + 127) / 128;
  int rc;
  if (a.w_gk) {
    w_map = a.swb ? SMAP_PANELS_B : SMAP_PANELS;
    const uint64_t dims[5] = {64, 64, gk, gn, B};
    const uint64_t str[4] = {64 * 2, 64 * 64 * 2, gk * 64 * 64 * 2,
                             (uint64_t)a.swb * 2};
    const uint32_t box[5] = {64, (uint32_t)ST_BK, 1, 1, 1};
    rc = tmap_16bit(tw, a.w, a.swb ? 5 : 4, dims, str, box, 128);
  } else {
    w_map = a.swb ? SMAP_ROWS_B : SMAP_ROWS;
    const uint64_t dims[3] = {N, K, B};
    const uint64_t str[2] = {N * 2, (uint64_t)a.swb * 2};
    const uint32_t box[3] = {64, (uint32_t)ST_BK, 1};
    rc = tmap_16bit(tw, a.w, a.swb ? 3 : 2, dims, str, box, 128);
  }
  if (rc) return rc;
  if (a.x_gk) {
    x_map = a.sxb ? SMAP_PANELS_B : SMAP_PANELS;
    const uint64_t dims[5] = {64, 128, gk, gm, B};
    const uint64_t str[4] = {64 * 2, 128 * 64 * 2, gk * 128 * 64 * 2,
                             (uint64_t)a.sxb * 2};
    const uint32_t box[5] = {(uint32_t)ST_BK, (uint32_t)mp, 1, 1, 1};
    return tmap_16bit(tx, a.x, a.sxb ? 5 : 4, dims, str, box, 64);
  }
  x_map = a.sxb ? SMAP_ROWS_B : SMAP_ROWS;
  const uint64_t dims[3] = {K, M, B};
  const uint64_t str[2] = {K * 2, (uint64_t)a.sxb * 2};
  const uint32_t box[3] = {(uint32_t)ST_BK, (uint32_t)mp, 1};
  return tmap_16bit(tx, a.x, a.sxb ? 3 : 2, dims, str, box, 64);
}

// One launch of the TMA kernel: `run` slices a unit.  The grid is the
// units where the card holds them all at once (cudaOccupancy..., once a
// thread and instance), else the fewest blocks that run them in the same
// number of rounds, so that every block walks as many units: 1408 bank
// tiles on 396 slots run as 352 blocks of 4, not 396 of 3 or 4.
template <typename T, int BN, int MT>
static int launch_stream_tma(const StreamArgs& a, int batch, int run,
                             cudaStream_t stream) {
  using C = StreamTmaCfg<BN, MT>;
  static bool smem_ok = false;
  static thread_local int slots = 0;
  auto kernel = gemm_stream_tma_kernel<T, BN, MT>;
  cudaError_t err = allow_smem(kernel, C::smem, &smem_ok);
  if (err != cudaSuccess) return (int)err;
  if (slots == 0) {
    int dev = 0, sms = 0, per = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                          S2_THREADS, C::smem);
    if (err != cudaSuccess) return (int)err;
    if (per < 1) return (int)cudaErrorInvalidConfiguration;
    slots = per * sms;
  }
  CUtensorMap tw, tx;
  StreamWork w;
  int rc = stream_maps(&tw, &tx, a, batch, C::MP, w.w_map, w.x_map);
  if (rc) return rc;
  w.tiles = (a.e.N + BN - 1) / BN;
  w.run = run;
  w.runs = (a.split + run - 1) / run;
  const long long units = (long long)batch * w.tiles * w.runs;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  w.units = (int)units;
  const int rounds = (w.units + slots - 1) / slots;
  const int grid = (w.units + rounds - 1) / rounds;
  kernel<<<grid, S2_THREADS, C::smem, stream>>>(tw, tx, a, w);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
static int launch_stream_tma_m(const StreamArgs& a, int batch, int run,
                               cudaStream_t s) {
  const int M = a.e.M;
  if (M <= 8) return launch_stream_tma<T, BN, 1>(a, batch, run, s);
  if (M <= 16) return launch_stream_tma<T, BN, 2>(a, batch, run, s);
  if (M <= 32) return launch_stream_tma<T, BN, 4>(a, batch, run, s);
  if (M <= 64) return launch_stream_tma<T, BN, 8>(a, batch, run, s);
  return (int)cudaErrorInvalidValue;
}

// bf16/f16: the TMA kernel where TMA reads both operands, else the
// cp.async kernel (head comment).
template <typename T>
static int launch_stream_16(const StreamArgs& a, int batch, int bn, int run,
                            bool tma, cudaStream_t s) {
  if (!tma) return launch_stream_t<T>(a, batch, bn, s);
  if (bn == 128) return launch_stream_tma_m<T, 128>(a, batch, run, s);
  if (bn == 64) return launch_stream_tma_m<T, 64>(a, batch, run, s);
  return (int)cudaErrorInvalidValue;
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The launcher: x and w as natural rows, or either or both as
// core/packing.py's panels (panels: PANELS_X, PANELS_Y; 0: natural rows),
// with each operand's batch stride in elements (0: shared across the
// batch); `run` the slices a unit of the TMA kernel (core/tiling.py's
// StreamConfig.run; the cp.async kernels run one slice a block); ws the
// (B, split, M, N) fp32 partials where the chosen kernel writes them, else
// null; tickets the stream's zeroed (B, N tiles) counters; ck_col / ck_row
// the sidecar's outputs, (B, 1, N) and (B, M, ceil(N / bn)) fp32, or null.
extern "C" int gemm_stream_launch(
    const void* x, const void* w, const void* c, const void* bias,
    const void* res, void* out, float* ws, int* tickets, int in_dt, int c_dt,
    int bias_dt, int res_dt, int out_dt, int batch, int M, int N, int K,
    float alpha, float beta, int neg_product, int neg_acc, int act, int bn,
    int split, int run, float* ck_col, float* ck_row, void* stream,
    int panels, long long sxb, long long swb) {
  StreamArgs a;
  a.x = x; a.w = w; a.ws = ws; a.tickets = tickets;
  a.e.c = c; a.e.bias = bias; a.e.res = res; a.e.out = out;
  a.e.c_dt = c_dt; a.e.bias_dt = bias_dt; a.e.res_dt = res_dt;
  a.e.out_dt = out_dt;
  a.e.M = M; a.e.N = N;
  a.e.alpha = alpha; a.e.beta = beta;
  a.e.neg_product = neg_product; a.e.neg_acc = neg_acc; a.e.act = act;
  a.e.vec8 = 0;  // element stores (the tile is at most 64 rows)
  a.e.ck_col = ck_col; a.e.ck_row = ck_row;
  a.K = K;
  a.stages = (K + ST_BK - 1) / ST_BK;
  a.split = split;
  if (split < 1 || split > a.stages) return (int)cudaErrorInvalidValue;
  // elements a 16-byte chunk holds: 8 bf16/f16, 4 fp32
  const int ch = in_dt == DT_F32 ? 4 : 8;
  a.vec = (K % ch == 0) && (N % ch == 0) && aligned16(x) && aligned16(w);
  a.vec_x = (K % ch == 0) && aligned16(x);
  const int gk = (K + PANEL_C - 1) / PANEL_C;
  a.w_gk = (panels & PANELS_Y) ? gk : 0;
  a.x_gk = (panels & PANELS_X) ? gk : 0;
  a.sxb = sxb; a.swb = swb;
  if ((a.w_gk && (!aligned16(w) || swb % ch)) ||
      (a.x_gk && (!aligned16(x) || sxb % ch)))
    return (int)cudaErrorInvalidValue;
  // the TMA kernel (bf16/f16): 16-byte bases and pitches (X's K, W's N)
  // or panels; partials where a tile's slices span units, and on the
  // cp.async kernels wherever K is split
  const bool tma = (in_dt == DT_BF16 || in_dt == DT_F16) &&
                   (a.w_gk || (N % 8 == 0 && aligned16(w) && swb % 8 == 0)) &&
                   (a.x_gk || (K % 8 == 0 && aligned16(x) && sxb % 8 == 0));
  const bool parts = tma ? run < split : split > 1;
  if (run < 1 || run > split || (parts && (!ws || !tickets)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_BF16)
    return launch_stream_16<__nv_bfloat16>(a, batch, bn, run, tma, s);
  if (in_dt == DT_F16)
    return launch_stream_16<__half>(a, batch, bn, run, tma, s);
  if (in_dt == DT_F32) {
    if (bn == 128) return launch_stream_f32_m<128>(a, batch, s);
    if (bn == 64) return launch_stream_f32_m<64>(a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}
