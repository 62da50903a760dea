// Split-K weight-stream GEMM for small M on Hopper (sm_90a): decode.
//
// Replaces the TPU kernel K1a (repro/kernels/mma_gemm.py, mma_gemm, kernel
// body _make_kernel) for the products whose M is a batch of tokens (decode
// M = 4, whisper's decoder prefill M = 16, the SSD's M = 1 products):
//
//     out = cast(residual + act(bias + alpha * ([-](X @ W) [+/- beta * C])))
//
// X (M <= 64, K) and W (K, N) in bf16 or f16, fp32 accumulation, 2-D or
// batched.
//
// What bounds it on an H100.  The whole (K, N) weight is read once per
// call and each weight element meets M <= 64 rows of X: ~M flops per
// weight byte, far below the ~295 the tensor cores need, so the bound is
// bytes at 3.35 TB/s.  Reaching it needs every SM streaming with many
// bytes in flight: the old 64 x 64 tile put 64 blocks on 132 SMs for an
// N = 4096 product and loaded synchronously (0.23 TB/s).
//
// Design.
//   * Grid (N tiles of BN = 64 or 128 columns, K splits, batch): the
//     wrapper (core/tiling.py, stream_plan) splits K so that the grid holds
//     at least two blocks per SM.  Split s owns K stages
//     [s * stages / split, (s + 1) * stages / split) of BK = 32 rows.
//   * Each block streams its (BK, BN) weight panels, and the matching
//     (M, BK) panels of X, through a ring of 8 cp.async stages (16-byte
//     chunks, zero-filled past the K, N and M fringes; a scalar path for
//     rows that are not 16-byte aligned, such as whisper's N = 51865), one
//     __syncthreads per stage: up to 64 KB of weight in flight per block.
//   * The product runs on the tensor cores with the operands swapped:
//     out^T = W^T X^T, so W^T supplies mma.sync m16n8k16's 16-row side
//     (ldmatrix.trans from the row-major panel) and X its 8-column side:
//     M is padded only to a multiple of 8, not to a 64-row tile.
//   * The accumulators go through the (then idle) ring as an fp32 tile, so
//     that stores are coalesced and the epilogue is one loop.
//   * Split-K partials are fp32, in a (B, split, M, N) workspace that the
//     wrapper allocates per call.  The last block of an N tile to finish
//     (an atomic ticket, zeroed on the launch's stream just before it, so
//     no call depends on another) sums them in split order -- no float
//     atomics, so a result does not change from run to run -- and applies
//     the seed, alpha and the fused epilogue once.  With one split the
//     block stores straight from its staged tile.
//   * The ABFT checksum sidecar (K1e: repro/kernels/mma_gemm.py's
//     checksum=True): with ck_col / ck_row set, the block that stores an
//     N tile -- with K split, the last to arrive, after it has reduced the
//     partials and applied the seed and epilogue, never a partial -- writes
//     the finished fp32 values back over its staged tile and sums the
//     tile's M rows by column (one column a thread) and its columns by row
//     (one row a warp) in a fixed order: ck_col (B, 1, N), ck_row (B, M,
//     N tiles).  The stores are untouched, so the output is the same bit
//     for bit.
//   * Prepacked weights (K1d: repro/kernels/mma_gemm.py's packed_spec):
//     through gemm_stream_packed_launch (w_packed) the weight arrives as
//     core/packing.py's Y-side panels,
//     (gn, gk, 64, 64) per batch element, zero-padded past K and N.  A
//     16-byte chunk at (k, n) is read from panel (n / 64, k / 64) at
//     (k % 64) * 64 + n % 64, so a 32-row stage of a 64-column tile is 4 KB
//     contiguous (BN = 128 reads two panels) instead of 32 rows 2 N bytes
//     apart; the panels are always 16-byte aligned, so the chunked path
//     serves every N.  The shared-memory stages hold the same bytes as in
//     the natural layout, so the result is the natural launch's bit for
//     bit.

#include "gemm_common.cuh"

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

struct StreamArgs {
  const void* x;
  const void* w;
  float* ws;     // (B, split, M, N) fp32 partials, split > 1
  int* tickets;  // (B, N tiles), zeroed before each launch
  GemmEpi e;
  int K, split, stages;
  int vec;       // 16-byte aligned rows of X and W: cp.async
  int vec_x;     // X alone (packed weights are always chunked)
  int w_packed;  // W is (gn, gk, 64, 64) panels per batch element
};

constexpr int ST_PANEL = 64;  // rows and columns of a packed weight panel

// The element offset of weight (k, n) in the (gn, gk, 64, 64) panels.
__device__ __forceinline__ long long packed_w_at(int k, int n, int gk) {
  return ((long long)(n / ST_PANEL) * gk + k / ST_PANEL) *
             (ST_PANEL * ST_PANEL) +
         (k % ST_PANEL) * ST_PANEL + n % ST_PANEL;
}

template <typename T, int BN, int MT>
__device__ __forceinline__ void stream_load_stage(T* ws_, T* xs_,
                                                  const T* x, const T* w,
                                                  int M, int N, int K, int n0,
                                                  int k0, bool vec,
                                                  bool vec_x, int gk_panels) {
  using L = StreamSmem<T, BN, MT>;
  constexpr int WCH = BN / 8;  // 16-byte chunks per weight row
  if (gk_panels > 0) {
    // packed panels: every chunk lies inside one zero-padded panel row
    for (int i = threadIdx.x; i < ST_BK * WCH; i += ST_THREADS) {
      const int r = i / WCH, c = (i % WCH) * 8;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < K && gn < N;
      cp_async16(ws_ + r * L::LDW + c, in ? w + packed_w_at(gk, gn, gk_panels)
                                          : w,
                 in);
    }
    if (vec_x) {
      for (int i = threadIdx.x; i < L::MP * (ST_BK / 8); i += ST_THREADS) {
        const int r = i / (ST_BK / 8), c = (i % (ST_BK / 8)) * 8;
        const int gk = k0 + c;
        const bool in = r < M && gk < K;
        cp_async16(xs_ + r * L::LDX + c, in ? x + (long long)r * K + gk : x,
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
    return;
  }
  if (vec) {
    for (int i = threadIdx.x; i < ST_BK * WCH; i += ST_THREADS) {
      const int r = i / WCH, c = (i % WCH) * 8;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < K && gn < N;
      cp_async16(ws_ + r * L::LDW + c, in ? w + (long long)gk * N + gn : w, in);
    }
    for (int i = threadIdx.x; i < L::MP * (ST_BK / 8); i += ST_THREADS) {
      const int r = i / (ST_BK / 8), c = (i % (ST_BK / 8)) * 8;
      const int gk = k0 + c;
      const bool in = r < M && gk < K;
      cp_async16(xs_ + r * L::LDX + c, in ? x + (long long)r * K + gk : x, in);
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
    for (int i = threadIdx.x; i < L::MP * ST_BK; i += ST_THREADS) {
      const int r = i / ST_BK, c = i % ST_BK;
      const int gk = k0 + c;
      xs_[r * L::LDX + c] =
          (r < M && gk < K) ? x[(long long)r * K + gk] : zero_of<T>();
    }
  }
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4],
                                                        const uint32_t (&a)[4],
                                                        uint32_t b0,
                                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  const T* x = reinterpret_cast<const T*>(a.x) + (long long)bz * M * K;
  const int gk_panels = a.w_packed ? (K + ST_PANEL - 1) / ST_PANEL : 0;
  const long long w_batch =
      a.w_packed ? (long long)((N + ST_PANEL - 1) / ST_PANEL) * gk_panels *
                       (ST_PANEL * ST_PANEL)
                 : (long long)K * N;
  const T* w = reinterpret_cast<const T*>(a.w) + (long long)bz * w_batch;
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
      stream_load_stage<T, BN, MT>(st, st + L::W_ELEMS, x, w, M, N, K, n0,
                                   (st0 + i) * ST_BK, vec, a.vec_x != 0,
                                   gk_panels);
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
        stream_load_stage<T, BN, MT>(st, st + L::W_ELEMS, x, w, M, N, K, n0,
                                     (st0 + nxt) * ST_BK, vec, a.vec_x != 0,
                                     gk_panels);
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
  if (threadIdx.x == 0) last_block = atomicAdd(ticket, 1) == a.split - 1;
  __syncthreads();
  if (!last_block) return;
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
static int launch_stream(const StreamArgs& a, int batch, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t smem = StreamSmem<T, BN, MT>::bytes;
  auto kernel = gemm_stream_kernel<T, BN, MT>;
  cudaError_t err = allow_smem(kernel, smem, &smem_ok);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.e.N + BN - 1) / BN, a.split, batch);
  if (a.split > 1) {
    err = cudaMemsetAsync(a.tickets, 0, sizeof(int) * grid.x * batch, stream);
    if (err != cudaSuccess) return (int)err;
  }
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

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

static int stream_launch(
    const void* x, const void* w, const void* c, const void* bias,
    const void* res, void* out, float* ws, int* tickets, int in_dt, int c_dt,
    int bias_dt, int res_dt, int out_dt, int batch, int M, int N, int K,
    float alpha, float beta, int neg_product, int neg_acc, int act, int bn,
    int split, float* ck_col, float* ck_row, void* stream, int w_packed) {
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
  if (split < 1 || split > a.stages || (split > 1 && (!ws || !tickets)))
    return (int)cudaErrorInvalidValue;
  a.vec = (K % 8 == 0) && (N % 8 == 0) && aligned16(x) && aligned16(w);
  a.vec_x = (K % 8 == 0) && aligned16(x);
  a.w_packed = w_packed;
  if (w_packed && !aligned16(w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_BF16) return launch_stream_t<__nv_bfloat16>(a, batch, bn, s);
  if (in_dt == DT_F16) return launch_stream_t<__half>(a, batch, bn, s);
  return (int)cudaErrorInvalidValue;
}

// The launchers, one argument list: w as natural (K, N) rows, or as
// core/packing.py's Y-side panels; ck_col / ck_row the sidecar's outputs,
// (B, 1, N) and (B, M, ceil(N / bn)) fp32, or null.
extern "C" int gemm_stream_launch(
    const void* x, const void* w, const void* c, const void* bias,
    const void* res, void* out, float* ws, int* tickets, int in_dt, int c_dt,
    int bias_dt, int res_dt, int out_dt, int batch, int M, int N, int K,
    float alpha, float beta, int neg_product, int neg_acc, int act, int bn,
    int split, float* ck_col, float* ck_row, void* stream) {
  return stream_launch(x, w, c, bias, res, out, ws, tickets, in_dt, c_dt,
                       bias_dt, res_dt, out_dt, batch, M, N, K, alpha, beta,
                       neg_product, neg_acc, act, bn, split, ck_col, ck_row,
                       stream, 0);
}

extern "C" int gemm_stream_packed_launch(
    const void* x, const void* w, const void* c, const void* bias,
    const void* res, void* out, float* ws, int* tickets, int in_dt, int c_dt,
    int bias_dt, int res_dt, int out_dt, int batch, int M, int N, int K,
    float alpha, float beta, int neg_product, int neg_acc, int act, int bn,
    int split, float* ck_col, float* ck_row, void* stream) {
  return stream_launch(x, w, c, bias, res, out, ws, tickets, in_dt, c_dt,
                       bias_dt, res_dt, out_dt, batch, M, N, K, alpha, beta,
                       neg_product, neg_acc, act, bn, split, ck_col, ck_row,
                       stream, 1);
}
