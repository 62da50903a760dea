// One (BM, BN) output tile of a GEMM-shaped product and its whole K loop,
// shared by K1a (mma_gemm.cu) and K3's implicit GEMM (mma_conv.cu).  The
// two differ only in where the A panel comes from, so the tile loops take
// an A loader and a B loader.  For the 16-bit tile (wmma_tile_ab, named
// for its path, "wmma"), every thread calls
//
//   ld.template copies<NT, BM, BK, LDA>()  /  bl.template copies<NT, BK,
//   BN, LDB>()
//       once a tile: this thread's copies of the row-major (BM, BK) A
//       panel / (BK, BN) B panel, their sources worked out, whose
//       issue(T* stage, int t) issues the cp.async copies of K step t into
//       a ring stage and land(T* stage, int t), once they have landed,
//       fixes them up before the block's barrier (realigns rows copied as
//       whole words, selects the pm* lanes; mostly nothing).
//
// For F32GER, the fp32 SIMT tile (f32_simt_tile: K1's fp32 products and
// K3's fp32 conv) reads
//
//   ld.chunk4(int r, int k)  /  bl.chunk4(int k, int c)
//       the 4 fp32 values of tile row r at k .. k + 3 (k a multiple of 4)
//       / of row k at tile columns c .. c + 3.
//
// Each stages zeros past the M, N and K fringes: RowMajorA over natural rows, PackedA over
// core/packing.py's X-side panels (K1d), MaskedRowMajorA / MaskedPackedA
// for the pm* forms; B is a (K, N) matrix: RowMajorB over natural rows,
// PackedB over core/packing.py's 64-column panels (K1d, and K3's packed
// filter stream), or MaskedRowMajorB / MaskedPackedB.
// Both tiles leave the fp32 tile in shared memory (row pitch BN + 4,
// aliasing the panels) for the caller's store; with `seeded` that tile
// holds the fp32 seed on entry.
//
// The pm* predicates (K1b, paper eq. 3) are byte masks over M, N and K
// (PmMasks; a null pointer enables every lane).  The masked loaders apply
// them to the staged panels: a disabled row of A or rank of B (a row of
// the (K, N) panel) is not copied (the copy zero-fills it, as it does past
// the fringes), and a disabled rank of A or column of B is selected to
// +0.0 in land(): a NaN there leaves no trace.  The masks' bytes that a
// K step needs are read a step ahead.  K3's loaders (mma_conv.cu) take
// the unmasked ones.
#pragma once

#include "common.cuh"

// Four fp32 values at p[0..3], each zero at or past `lim` lanes from p
// (element loads: the row is not 16-byte aligned).
__device__ __forceinline__ float4 load4_upto(const float* p, int lim) {
  return make_float4(lim > 0 ? p[0] : 0.f, lim > 1 ? p[1] : 0.f,
                     lim > 2 ? p[2] : 0.f, lim > 3 ? p[3] : 0.f);
}

// The lanes of a staged fp32 chunk at indices i .. i + 3 kept where `on`
// says, else +0.0 (a select: NaN or Inf there leaves no trace).
template <typename On>
__device__ __forceinline__ float4 select4(float4 v, int i, const On& on) {
  v.x = on(i) ? v.x : 0.f;
  v.y = on(i + 1) ? v.y : 0.f;
  v.z = on(i + 2) ? v.z : 0.f;
  v.w = on(i + 3) ? v.w : 0.f;
  return v;
}

// ---- staging 16-bit panels with cp.async ----
//
// A chunk is 8 elements (16 bytes) of one panel row at a column that is a
// multiple of 8.  Thread t of the tile's NT copies chunks t, t + NT, ...
// of each panel (Chunks): one to four, all in one column of the window,
// and a row's chunks are one warp's.  Where each chunk comes from is
// worked out once a tile (a loader's copies()); a K step moves every
// source by one offset, so the step's copies cost an add, a clamp and the
// copy.
//
// Natural rows: every chunk of a row lies at the row's offset in 16 bytes,
// which picks the copy row by row (core/tiling.py's tile16_row_shift
// mirrors the rule): at 0, one 16-byte copy a chunk; else the aligned
// 16-byte word under the chunk's first element goes to the chunk's place
// as it is, and the row's last chunk in the window also copies the word
// after it into the row's 16 bytes of padding, and once they have landed,
// land() shifts each chunk into place from its word and the next
// (whisper's 51865-column logits: seven rows in eight).  Bytes past a
// row's last column, and whole chunks of rows past the matrix or disabled,
// are zero-filled by the copies themselves.

template <int NT, int ROWS, int COLS>
struct Chunks {
  static constexpr int CH = COLS / 8, PER = ROWS * CH / NT, RSTEP = NT / CH;
  static_assert(PER >= 1 && PER <= 4 && (ROWS * CH) % NT == 0 &&
                    NT % CH == 0 && 32 % CH == 0,
                "Chunks: 1-4 chunks a thread in one column, rows a warp's");
  __device__ static int row(int j) { return threadIdx.x / CH + j * RSTEP; }
  __device__ static int col() { return 8 * (threadIdx.x % CH); }
  __device__ static bool last() { return threadIdx.x % CH == CH - 1; }
};

constexpr int OFF = -1024;  // a chunk's valid bytes where its row is off

// The 16 bytes at byte `mis` of the 32 bytes lo:hi.
__device__ __forceinline__ uint4 shift_bytes(uint4 lo, uint4 hi, int mis) {
  const uint32_t u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int j = mis >> 2;
  uint32_t w[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    w[i] = j == 0 ? u[i] : j == 1 ? u[i + 1] : j == 2 ? u[i + 2] : u[i + 3];
  const uint32_t sh = (mis & 3) * 8;
  return make_uint4(__funnelshift_r(w[0], w[1], sh),
                    __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh),
                    __funnelshift_r(w[3], w[4], sh));
}

// A pm* mask's bytes [c, c + 8) as one 8-byte word (c is a multiple of 8
// and the masks are 16-byte aligned); bytes at or past n read as 0 (their
// lanes are zero already).
__device__ __forceinline__ uint2 mask_word(const uint8_t* mask, int c, int n) {
  if (c + 8 <= n) return *reinterpret_cast<const uint2*>(mask + c);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (c + e < n && mask[c + e]) w[e / 4] |= 1u << (8 * (e % 4));
  return make_uint2(w[0], w[1]);
}

// The 16-bit lanes of a chunk whose mask byte is 0, set to +0.0 (a NaN or
// Inf there leaves no trace).
__device__ __forceinline__ void select_chunk(uint4& v, uint2 m) {
  const uint32_t lo = __vcmpne4(m.x, 0u), hi = __vcmpne4(m.y, 0u);
  v.x &= __byte_perm(lo, 0u, 0x1100);
  v.y &= __byte_perm(lo, 0u, 0x3322);
  v.z &= __byte_perm(hi, 0u, 0x1100);
  v.w &= __byte_perm(hi, 0u, 0x3322);
}

// Once this thread's copies of a stage have landed: with `realign`, each
// chunk of a realigned row (its source q_j = p + j pitch off a 16-byte
// boundary) shifted into place from its word and the next (the next one
// is another lane's: a __syncwarp before the reads and one before the
// writes); with a mask word, its lanes selected.
template <typename T, typename C, int LD>
__device__ __forceinline__ void land_chunks(T* s, const char* p,
                                            long long pitch, bool realign,
                                            const uint2* m) {
  if (realign) __syncwarp();
  uint4 v[C::PER];
#pragma unroll
  for (int j = 0; j < C::PER; ++j) {
    const T* d = s + C::row(j) * LD + C::col();
    v[j] = *reinterpret_cast<const uint4*>(d);
    const int mis = (int)(reinterpret_cast<uintptr_t>(p + j * pitch) & 15);
    if (realign && mis)
      v[j] = shift_bytes(v[j], *reinterpret_cast<const uint4*>(d + 8), mis);
    if (m) select_chunk(v[j], *m);
  }
  if (realign) __syncwarp();
#pragma unroll
  for (int j = 0; j < C::PER; ++j)
    *reinterpret_cast<uint4*>(s + C::row(j) * LD + C::col()) = v[j];
}

// How far a K step moves a source, in bytes: natural rows and Y panels by
// a fixed stride; X panels (core/packing.py's (gm, gk, 128, 64), element
// (m, k) at x_panel_at) from column c8 of panel 0 to column t BK + c8.
struct StepBytes {
  long long bytes;
  __device__ long long operator()(int t) const { return bytes * t; }
};
template <typename T, int BK>
struct PanelStep {
  int c8;
  __device__ long long operator()(int t) const {
    const int k = t * BK + c8;
    return (long long)sizeof(T) *
           ((long long)(k / PANEL_C) * (PANEL_XR * PANEL_C) + k % PANEL_C -
            c8);
  }
};

// One chunk's copies from q with `avail` bytes valid from q (clamped to
// 0 .. 16): as it lies, or with `realign`, from the aligned word under q,
// and where it is its row's last chunk in the window, the next word too.
template <typename T>
__device__ __forceinline__ void copy_from(T* dst, const char* q, int avail,
                                          bool realign, bool last) {
  if (!realign) {
    cp_async16_upto(dst, q, avail);
    return;
  }
  const int mis = (int)(reinterpret_cast<uintptr_t>(q) & 15);
  cp_async16_upto(dst, q - mis, avail + mis);  // the word is allocated
  if (mis && last) cp_async16_upto(dst + 8, q - mis + 16, avail + mis - 16);
}

// An A panel's copies, (BM, BK): its rows fixed, each K step moves the
// window BK columns on.  Chunk j's source at step t is p + j pitch +
// step(t) (its row RSTEP j rows below chunk 0's), `cols` - sizeof(T) BK t
// bytes of its row valid from there where bit j of `live` is set (its row
// lies in M and is enabled).  `pm` (or null) selects the rank predicates'
// lanes in land(), its word for step t read a step ahead.
template <typename T, int NT, int BM, int BK, int LDA, typename Step>
struct ACopies {
  using C = Chunks<NT, BM, BK>;
  const char* p;
  long long pitch;
  uint32_t live;
  int cols;
  Step step;
  bool realign;  // some row is off a 16-byte boundary
  const uint8_t* pm;
  int K;
  uint2 ranks;  // pm's word for the next step to land

  __device__ void issue(T* as, int t) {
    const char* base = p + step(t);
    const int avail = cols - (int)sizeof(T) * BK * t;
#pragma unroll
    for (int j = 0; j < C::PER; ++j)
      copy_from(as + C::row(j) * LDA + C::col(), base + j * pitch,
                (live >> j) & 1 ? avail : OFF, realign, C::last());
  }

  __device__ void land(T* as, int t) {
    if (!realign && pm == nullptr) return;
    uint2 m = ranks;
    if (pm) {
      const int c = t * BK + C::col();
      if (t == 0) m = mask_word(pm, c, K);
      ranks = mask_word(pm, c + BK, K);
    }
    land_chunks<T, C, LDA>(as, p, pitch, realign, pm ? &m : nullptr);
  }
};

// A B panel's copies, (BK, BN): its columns fixed, each K step moves the
// window BK rows on.  Chunk j's source at step t is p + j pitch + step(t),
// `cols` bytes of its row valid from there while its row (left0 above K
// at step 0 for chunk 0) lies above K and its rank's `pm` byte (or null)
// is set, the bytes for step t read a step ahead; `ym` (or null) selects
// the column predicates' lanes in land(), one word a thread.
template <typename T, int NT, int BK, int BN, int LDB, typename Step>
struct BCopies {
  using C = Chunks<NT, BK, BN>;
  const char* p;
  long long pitch;
  int cols, left0;
  Step step;
  bool realign;
  const uint8_t* pm;
  const uint8_t* ym;
  uint2 word;               // ym's word for this thread's column
  uint32_t ranks[C::PER];   // pm's bytes for the next step's rows

  __device__ void issue(T* bs, int t) {
    const char* base = p + step(t);
#pragma unroll
    for (int j = 0; j < C::PER; ++j) {
      bool on = BK * t + j * C::RSTEP < left0;
      if (pm) on = on && (t == 0 ? pm[C::row(j)] : ranks[j]) != 0;
      copy_from(bs + C::row(j) * LDB + C::col(), base + j * pitch,
                on ? cols : OFF, realign, C::last());
    }
    if (pm) {
#pragma unroll
      for (int j = 0; j < C::PER; ++j)
        ranks[j] = BK * (t + 1) + j * C::RSTEP < left0
                       ? pm[BK * (t + 1) + C::row(j)]
                       : 0;
    }
  }

  __device__ void land(T* bs, int) {
    if (realign || ym)
      land_chunks<T, C, LDB>(bs, p, pitch, realign, ym ? &word : nullptr);
  }
};

// The copies of natural rows: A (rows m0.. of a row-major (M, K)
// matrix, rows off where xm says) and B (columns n0.. of a row-major (K,
// N) matrix), each with its pm* predicates.
template <typename T, int NT, int BM, int BK, int LDA>
__device__ ACopies<T, NT, BM, BK, LDA, StepBytes> natural_a(
    const T* x, int M, int K, int m0, const uint8_t* xm, const uint8_t* pm) {
  using C = Chunks<NT, BM, BK>;
  ACopies<T, NT, BM, BK, LDA, StepBytes> a;
  a.p = reinterpret_cast<const char*>(x + (long long)(m0 + C::row(0)) * K +
                                      C::col());
  a.pitch = (long long)sizeof(T) * C::RSTEP * K;
  a.live = 0;
#pragma unroll
  for (int j = 0; j < C::PER; ++j) {
    const int gr = m0 + C::row(j);
    if (gr < M && lane_on(xm, gr)) a.live |= 1u << j;
  }
  a.cols = (int)sizeof(T) * (K - C::col());
  a.step = StepBytes{(long long)sizeof(T) * BK};
  a.realign = ((reinterpret_cast<uintptr_t>(x) | (uintptr_t)K * sizeof(T)) &
               15) != 0;
  a.pm = pm;
  a.K = K;
  return a;
}

template <typename T, int NT, int BK, int BN, int LDB>
__device__ BCopies<T, NT, BK, BN, LDB, StepBytes> natural_b(
    const T* y, int K, int N, int n0, const uint8_t* pm, const uint8_t* ym) {
  using C = Chunks<NT, BK, BN>;
  BCopies<T, NT, BK, BN, LDB, StepBytes> b;
  const int gc = n0 + C::col();
  b.p = reinterpret_cast<const char*>(y + (long long)C::row(0) * N + gc);
  b.pitch = (long long)sizeof(T) * C::RSTEP * N;
  b.cols = (int)sizeof(T) * (N - gc);
  b.left0 = K - C::row(0);
  b.step = StepBytes{(long long)sizeof(T) * BK * N};
  b.realign = ((reinterpret_cast<uintptr_t>(y) | (uintptr_t)N * sizeof(T)) &
               15) != 0;
  b.pm = pm;
  b.ym = ym;
  if (ym) b.word = mask_word(ym, gc, N);
  return b;
}

// The GEMM's A: rows m0.. of a row-major (M, K) matrix.
template <typename T>
struct RowMajorA {
  const T* x;
  int M, K, m0;
  bool vec;  // fp32 rows 16-byte aligned (chunk4)

  template <int NT, int BM, int BK, int LDA>
  __device__ auto copies() const {
    return natural_a<T, NT, BM, BK, LDA>(x, M, K, m0, nullptr, nullptr);
  }

  __device__ __forceinline__ float4 chunk4(int r, int k) const {
    const int gr = m0 + r;
    if (gr >= M || k >= K) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = x + (long long)gr * K + k;
    return vec ? __ldg(reinterpret_cast<const float4*>(src))
               : load4_upto(src, K - k);
  }
};

// The GEMM's B: columns n0.. of a row-major (K, N) matrix.
template <typename T>
struct RowMajorB {
  const T* y;
  int K, N, n0;
  bool vec;  // fp32 rows 16-byte aligned (chunk4)

  template <int NT, int BK, int BN, int LDB>
  __device__ auto copies() const {
    return natural_b<T, NT, BK, BN, LDB>(y, K, N, n0, nullptr, nullptr);
  }

  __device__ __forceinline__ float4 chunk4(int k, int c) const {
    const int gc = n0 + c;
    if (k >= K || gc >= N) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = y + (long long)k * N + gc;
    return vec ? __ldg(reinterpret_cast<const float4*>(src))
               : load4_upto(src, N - gc);
  }
};

// pm* predicates: xm over M (rows of A), ym over N (columns of B), pm over
// K (both panels); each null or one byte a lane.
struct PmMasks {
  const uint8_t* xm;
  const uint8_t* ym;
  const uint8_t* pm;
};

// A with the row and rank predicates: a disabled row is not copied, a
// disabled rank's lanes are selected to 0 once the stage has landed.
template <typename T>
struct MaskedRowMajorA {
  const T* x;
  int M, K, m0;
  bool vec;
  PmMasks mk;

  template <int NT, int BM, int BK, int LDA>
  __device__ auto copies() const {
    return natural_a<T, NT, BM, BK, LDA>(x, M, K, m0, mk.xm, mk.pm);
  }

  __device__ __forceinline__ float4 chunk4(int r, int k) const {
    const int gr = m0 + r;
    if (gr >= M || k >= K) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = x + (long long)gr * K + k;
    const float4 v = vec ? __ldg(reinterpret_cast<const float4*>(src))
                         : load4_upto(src, K - k);
    const bool row = lane_on(mk.xm, gr);
    return select4(v, k, [&](int gk) {
      return row && gk < K && lane_on(mk.pm, gk);
    });
  }
};

// B with the rank and column predicates, staged as MaskedRowMajorA is: a
// disabled rank (a row of B) is not copied, a disabled column selected.
template <typename T>
struct MaskedRowMajorB {
  const T* y;
  int K, N, n0;
  bool vec;
  PmMasks mk;

  template <int NT, int BK, int BN, int LDB>
  __device__ auto copies() const {
    return natural_b<T, NT, BK, BN, LDB>(y, K, N, n0, mk.pm, mk.ym);
  }

  __device__ __forceinline__ float4 chunk4(int k, int c) const {
    const int gc = n0 + c;
    if (k >= K || gc >= N) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = y + (long long)k * N + gc;
    const float4 v = vec ? __ldg(reinterpret_cast<const float4*>(src))
                         : load4_upto(src, N - gc);
    const bool rank = lane_on(mk.pm, k);
    return select4(v, gc, [&](int n) {
      return rank && n < N && lane_on(mk.ym, n);
    });
  }
};

// B from prepacked panels (K1d: repro/kernels/mma_gemm.py's packed_spec;
// K3's packed filters: repro/kernels/mma_conv.py's w_layout): columns n0..
// of a (K, N) matrix kept as 64-column slabs, slab s holding columns
// [64 s, 64 s + 64) of rows 0.. row-major, zero-padded past N (and past K
// where the slab runs on).  Element (k, n) sits at
//     (n / 64) * slab + k * 64 + n % 64:
// the GEMM's (gn, gk, 64, 64) Y panels are such slabs (slab = gk * 64 * 64:
// the gk panels of a column block lie one after another, so their rows
// run on), and so is K3's (gf, KH, KW, C, 64) filter stream (slab = K *
// 64).  Each stage row of a chunk (8 16-bit or 4 fp32 values) lies in one
// slab row, contiguous and 16-byte aligned, so it is one 16-byte copy at
// any N: whisper's 51865-column lm_head too, whose natural rows are
// realigned.  A chunk that starts past N or a row past K stages as 0, as
// RowMajorB's fringe does, and a chunk across N reads the zero padding:
// the staged panel, and so the result, is the natural loader's bit for
// bit.  The tiles read (BK, BN) stages out of the fixed panels: (32, 128)
// is two panels' columns, half a panel deep; (64, 64) exactly one panel;
// F32GER's (16, 64) a quarter of one, (16, 128) a quarter of two.
constexpr int PANEL_COLS = 64;

template <typename T>
struct PackedB {
  const T* y;
  int K, N, n0;
  long long slab;  // elements of one 64-column slab

  __device__ __forceinline__ const T* at(int k, int n) const {
    return y + (long long)(n / PANEL_COLS) * slab + (long long)k * PANEL_COLS +
           n % PANEL_COLS;
  }

  // The 16-bit tile's copies, with the rank and column predicates.
  template <int NT, int BK, int BN, int LDB>
  __device__ BCopies<T, NT, BK, BN, LDB, StepBytes> masked_copies(
      const uint8_t* pm, const uint8_t* ym) const {
    using C = Chunks<NT, BK, BN>;
    BCopies<T, NT, BK, BN, LDB, StepBytes> b;
    const int gc = n0 + C::col();
    b.p = reinterpret_cast<const char*>(at(C::row(0), gc));
    b.pitch = (long long)sizeof(T) * C::RSTEP * PANEL_COLS;
    b.cols = (int)sizeof(T) * (N - gc);
    b.left0 = K - C::row(0);
    b.step = StepBytes{(long long)sizeof(T) * BK * PANEL_COLS};
    b.realign = false;
    b.pm = pm;
    b.ym = ym;
    if (ym) b.word = mask_word(ym, gc, N);
    return b;
  }

  template <int NT, int BK, int BN, int LDB>
  __device__ auto copies() const {
    return masked_copies<NT, BK, BN, LDB>(nullptr, nullptr);
  }

  __device__ __forceinline__ float4 chunk4(int k, int c) const {
    const int gc = n0 + c;
    if (k >= K || gc >= N) return make_float4(0.f, 0.f, 0.f, 0.f);
    return __ldg(reinterpret_cast<const float4*>(at(k, gc)));
  }
};

// Packed B with the rank and column predicates, as MaskedRowMajorB: a
// disabled rank's row is not copied, a disabled column's lanes are
// selected to 0 once landed (so NaN or Inf there gives exact zeros).  A
// chunk across N reads no mask byte past N: its lanes there are 0 by the
// fringe rule.
template <typename T>
struct MaskedPackedB {
  PackedB<T> p;
  PmMasks mk;

  template <int NT, int BK, int BN, int LDB>
  __device__ auto copies() const {
    return p.template masked_copies<NT, BK, BN, LDB>(mk.pm, mk.ym);
  }

  __device__ __forceinline__ float4 chunk4(int k, int c) const {
    const int gc = p.n0 + c;
    if (k >= p.K || gc >= p.N || !lane_on(mk.pm, k))
      return make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 v = __ldg(reinterpret_cast<const float4*>(p.at(k, gc)));
    return select4(v, gc, [&](int n) {
      return n < p.N && lane_on(mk.ym, n);
    });
  }
};

// A from prepacked X panels (K1d: repro/kernels/mma_gemm.py's
// packed_spec): rows m0.. of an (M, K) matrix kept as core/packing.py's
// (gm, gk, 128, 64) panels (common.cuh's x_panel_at), zero-padded past M
// and K.  A stage row's chunk (8 16-bit or 4 fp32 values at a k that is a
// multiple of their count) lies in one panel row, contiguous and 16-byte
// aligned, so it is one 16-byte copy at any K.  A chunk that starts past
// K or a row past M stages as 0, as RowMajorA's fringe does, and a chunk
// across K reads the zero padding: the staged panel, and so the result,
// is the natural loader's bit for bit.  The tiles' (BM, BK) stages:
// (128, 32) is one panel's 128 rows, half its depth; (64, 64) half its
// rows, all its depth; F32GER's (64 or 128 rows, 16) a quarter of its
// depth.
template <typename T>
struct PackedA {
  const T* x;
  int M, K, m0, gk;

  __device__ __forceinline__ const T* at(int m, int k) const {
    return x + x_panel_at(m, k, gk);
  }

  // The 16-bit tile's copies, with the row and rank predicates (a
  // stage's rows lie in one 128-row panel: m0 is a multiple of BM).
  template <int NT, int BM, int BK, int LDA>
  __device__ ACopies<T, NT, BM, BK, LDA, PanelStep<T, BK>> masked_copies(
      const uint8_t* xm, const uint8_t* pm) const {
    using C = Chunks<NT, BM, BK>;
    static_assert(PANEL_XR % BM == 0, "PackedA: a stage in one panel");
    ACopies<T, NT, BM, BK, LDA, PanelStep<T, BK>> a;
    a.p = reinterpret_cast<const char*>(at(m0 + C::row(0), C::col()));
    a.pitch = (long long)sizeof(T) * C::RSTEP * PANEL_C;
    a.live = 0;
#pragma unroll
    for (int j = 0; j < C::PER; ++j) {
      const int gr = m0 + C::row(j);
      if (gr < M && lane_on(xm, gr)) a.live |= 1u << j;
    }
    a.cols = (int)sizeof(T) * (K - C::col());
    a.step = PanelStep<T, BK>{C::col()};
    a.realign = false;
    a.pm = pm;
    a.K = K;
    return a;
  }

  template <int NT, int BM, int BK, int LDA>
  __device__ auto copies() const {
    return masked_copies<NT, BM, BK, LDA>(nullptr, nullptr);
  }

  __device__ __forceinline__ float4 chunk4(int r, int k) const {
    const int gr = m0 + r;
    if (gr >= M || k >= K) return make_float4(0.f, 0.f, 0.f, 0.f);
    return __ldg(reinterpret_cast<const float4*>(at(gr, k)));
  }
};

// Packed A with the row and rank predicates, as MaskedRowMajorA: a
// disabled row is not copied, a disabled rank's lanes are selected to 0
// once landed (so NaN or Inf there gives exact zeros).  A chunk across K
// reads no mask byte past K: its lanes there are 0 by the fringe rule.
template <typename T>
struct MaskedPackedA {
  PackedA<T> p;
  PmMasks mk;

  template <int NT, int BM, int BK, int LDA>
  __device__ auto copies() const {
    return p.template masked_copies<NT, BM, BK, LDA>(mk.xm, mk.pm);
  }

  __device__ __forceinline__ float4 chunk4(int r, int k) const {
    const int gr = p.m0 + r;
    if (gr >= p.M || k >= p.K || !lane_on(mk.xm, gr))
      return make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 v = __ldg(reinterpret_cast<const float4*>(p.at(gr, k)));
    return select4(v, k, [&](int gk) {
      return gk < p.K && lane_on(mk.pm, gk);
    });
  }
};

// ---- the 16-bit tensor-core tile ----
//
// bf16 / f16 on the tensor cores: WM x WN warps, each owning a (BM / WM,
// BN / WN) slice of the fp32 accumulator in registers as m16n8 fragments.
// The panels come through a ring of TILE16_STAGES cp.async stages.  Each
// K step t: wait for this thread's copies of stage t, land them (the
// loaders' fix-ups), one __syncthreads (stage t is whole; every warp is
// past stage t - 1, whose slot the next copies reuse), load the first
// 16-deep slice's fragments, issue stage t + STAGES - 1, then per slice
// ldmatrix (.trans for the row-major B panel) fragments into mma.sync
// m16n8k16, the next slice's fragments loaded before this slice's MMAs:
// the copies of three steps are in flight under the tensor cores.  Rows
// are padded by 8 elements (16 bytes: the 8 row addresses of an ldmatrix
// hit distinct banks, and a realigned row has room for its spare word).
// Each output is one chain of m16n8k16 products over its 16-deep K slices
// in ascending order, from the seed or +0.0, the K loop padded with zeros
// to a whole number of BK steps.
constexpr int TILE16_STAGES = 4;  // core/tiling.py's TILE16_STAGES

// The ring, or the fp32 tile that aliases it, whichever is larger
// (core/tiling.py's BlockConfig.smem_bytes).
template <typename T, int BM, int BN, int BK>
__host__ __device__ constexpr size_t wmma_smem_bytes() {
  constexpr size_t ring = (size_t)TILE16_STAGES *
                          ((size_t)BM * (BK + 8) + (size_t)BK * (BN + 8)) *
                          sizeof(T);
  constexpr size_t ctile = (size_t)BM * (BN + 4) * sizeof(float);
  return ring > ctile ? ring : ctile;
}

template <typename T, int BM, int BN, int BK, int WM, int WN, typename ALoader,
          typename BLoader>
__device__ void wmma_tile_ab(unsigned char* smem, const ALoader& ld,
                             const BLoader& bl, int K, bool seeded) {
  constexpr int NT = WM * WN * 32, S = TILE16_STAGES;
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  constexpr int TM = BM / WM, TN = BN / WN, FM = TM / 16, FN = TN / 8;
  constexpr int KS = BK / 16, STAGE = BM * LDA + BK * LDB;  // elements
  static_assert(TM % 16 == 0 && TN % 16 == 0 && BK % 16 == 0,
                "wmma_tile_ab: 16-row, 16-column warp slices, 16-deep steps");
  T* ring = reinterpret_cast<T*>(smem);
  float* cs = reinterpret_cast<float*>(smem);  // aliases the ring
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  // an accumulator fragment's rows g, g + 8 and columns 2q, 2q + 1
  const int g = lane / 4, q = lane % 4;
  const int r0 = wm * TM + g, c0 = wn * TN + 2 * q;

  float acc[FM][FN][4];
  if (seeded) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const float* p = cs + (r0 + 16 * i) * LDC + c0 + 8 * j;
        acc[i][j][0] = p[0];
        acc[i][j][1] = p[1];
        acc[i][j][2] = p[8 * LDC];
        acc[i][j][3] = p[8 * LDC + 1];
      }
    __syncthreads();  // the ring overwrites the seed tile next
  } else {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  auto ca = ld.template copies<NT, BM, BK, LDA>();
  auto cb = bl.template copies<NT, BK, BN, LDB>();
  const int nk = (K + BK - 1) / BK;
  auto issue = [&](int t) {
    T* as = ring + (t % S) * STAGE;
    ca.issue(as, t);
    cb.issue(as + BM * LDA, t);
  };
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nk) issue(t);
    cp_async_commit();
  }
  // lane l's ldmatrix rows: A rows l % 16 at k + 8 (l / 16); B (k, n) rows
  // k = l % 8 + 8 ((l / 8) % 2) at n + 8 (l / 16)
  const int a_off = (wm * TM + lane % 16) * LDA + 8 * (lane / 16);
  const int b_off = (lane % 8 + 8 * ((lane / 8) % 2)) * LDB + wn * TN +
                    8 * (lane / 16);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<S - 2>();
    T* as = ring + (t % S) * STAGE;
    T* bs = as + BM * LDA;
    ca.land(as, t);
    cb.land(bs, t);
    __syncthreads();  // stage t is whole; stage t - 1's slot is free

    uint32_t af[2][FM][4], bf[2][FN / 2][4];
    auto frags = [&](int buf, int kk) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldmatrix_x4(af[buf][i], as + a_off + 16 * i * LDA + kk);
#pragma unroll
      for (int j = 0; j < FN / 2; ++j)
        ldmatrix_x4_trans(bf[buf][j], bs + b_off + kk * LDB + 16 * j);
    };
    frags(0, 0);
    if (t + S - 1 < nk) issue(t + S - 1);
    cp_async_commit();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      if (s + 1 < KS) frags((s + 1) & 1, 16 * (s + 1));
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          mma16816<T>(acc[i][j], af[s & 1][i], bf[s & 1][j / 2][2 * (j % 2)],
                      bf[s & 1][j / 2][2 * (j % 2) + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the tile aliases it

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      float* p = cs + (r0 + 16 * i) * LDC + c0 + 8 * j;
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(p + 8 * LDC) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
}

// The tile over a row-major B (K3's implicit GEMM on natural filters).
template <typename T, int BM, int BN, int BK, int WM, int WN, typename ALoader>
__device__ void wmma_tile(unsigned char* smem, const ALoader& ld, const T* y,
                          int K, int N, int n0, bool seeded) {
  const RowMajorB<T> bl{y, K, N, n0, false};
  wmma_tile_ab<T, BM, BN, BK, WM, WN>(smem, ld, bl, K, seeded);
}

// F32GER's tile (mma_gemm.cu's gemm_f32_kernel, K3's conv_f32_kernel in
// mma_conv.cu): a register-blocked SIMT GEMM on the CUDA cores, true fp32
// FMAs (never TF32).  256 threads
// as 16 x 16 (a warp 4 x 8 of them); each owns (BM / 16) x (BN / 16)
// outputs in 4 x 4 quadrants 64 rows and 64 columns apart (8 x 8 on the
// 128 x 128 tile, 4 x 4 on the 64 x 64 one), so that a warp's float4
// shared loads are conflict-free:
// per k, BM / 64 + BN / 64 LDS.128 feed (BM / 16) * (BN / 16) FMAs (4
// feed 64 on the large tile).  Two stages of BK = 16: while the FMAs run
// on one, the next stage's chunks are in flight into registers (16-byte
// global loads where the rows allow, the loaders' chunk4), and go to the
// other stage after the FMAs: X k-major (transposed on the way, the pm*
// predicates selecting its disabled lanes to 0 there), Y row-major; one
// __syncthreads a K step.  Each output is one fmaf chain over k = 0 ..
// ceil(K / 16) * 16 - 1 in ascending order from the seed or +0.0 (the
// chain of the one-stage 64 x 64 tile that ran before it), so the result
// is the same bits at either tile size and with any loader.  The fp32 tile that the panels alias
// holds the seed on entry (`seeded`) and the accumulators on return.
constexpr int F32S_BK = 16, F32S_THREADS = 256;

template <int BM, int BN>
__host__ __device__ constexpr size_t f32_simt_smem_bytes() {
  constexpr size_t panels =
      2 * ((size_t)F32S_BK * (BM + 4) + (size_t)F32S_BK * (BN + 4)) * 4;
  constexpr size_t ctile = (size_t)BM * (BN + 4) * 4;
  return panels > ctile ? panels : ctile;
}

template <int BM, int BN, typename ALoader, typename BLoader>
__device__ void f32_simt_tile(unsigned char* smem, const ALoader& ld,
                              const BLoader& bl, int K, bool seeded) {
  constexpr int BK = F32S_BK, NT = F32S_THREADS;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int LDA = BM + 4, LDB = BN + 4, LDC = BN + 4;
  constexpr int CA = BK / 4, CB = BN / 4;          // chunks a panel row
  constexpr int CHA = BM * CA / NT, CHB = BK * CB / NT;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && CHA >= 1 && CHB >= 1,
                "f32_simt_tile: 64 or 128 rows and columns");
  float* as = reinterpret_cast<float*>(smem);  // 2 x (BK, LDA), k-major
  float* bs = as + 2 * BK * LDA;               // 2 x (BK, LDB)
  float* cs = reinterpret_cast<float*>(smem);  // aliases the panels
  // a warp is 4 x 8 of the 16 x 16 threads: its float4 loads of a k row
  // read 4 A and 8 B chunks
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = (warp % 2) * 8 + lane % 8, ty = (warp / 2) * 4 + lane / 8;

  float acc[TM][TN];
  if (seeded) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            cs + ((i / 4) * 64 + ty * 4 + i % 4) * LDC + q * 64 + tx * 4);
        acc[i][q * 4] = v.x; acc[i][q * 4 + 1] = v.y;
        acc[i][q * 4 + 2] = v.z; acc[i][q * 4 + 3] = v.w;
      }
    __syncthreads();  // the panels overwrite the seed tile next
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  float4 ra[CHA], rb[CHB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int c = 0; c < CHA; ++c) {
      const int i = threadIdx.x + c * NT;
      ra[c] = ld.chunk4(i / CA, k0 + (i % CA) * 4);
    }
#pragma unroll
    for (int c = 0; c < CHB; ++c) {
      const int i = threadIdx.x + c * NT;
      rb[c] = bl.chunk4(k0 + i / CB, (i % CB) * 4);
    }
  };
  auto put = [&](int buf) {
    float* a = as + buf * BK * LDA;
    float* b = bs + buf * BK * LDB;
#pragma unroll
    for (int c = 0; c < CHA; ++c) {
      const int i = threadIdx.x + c * NT;
      const int r = i / CA, kc = (i % CA) * 4;
      a[kc * LDA + r] = ra[c].x;
      a[(kc + 1) * LDA + r] = ra[c].y;
      a[(kc + 2) * LDA + r] = ra[c].z;
      a[(kc + 3) * LDA + r] = ra[c].w;
    }
#pragma unroll
    for (int c = 0; c < CHB; ++c) {
      const int i = threadIdx.x + c * NT;
      *reinterpret_cast<float4*>(b + (i / CB) * LDB + (i % CB) * 4) = rb[c];
    }
  };

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) {
    fetch(0);
    put(0);
  }
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) fetch((t + 1) * BK);  // in flight under the FMAs
    const float* a = as + (t & 1) * BK * LDA + ty * 4;
    const float* b = bs + (t & 1) * BK * LDB + tx * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + kk * LDA + q * 64);
        av[q * 4] = v.x; av[q * 4 + 1] = v.y;
        av[q * 4 + 2] = v.z; av[q * 4 + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(b + kk * LDB + q * 64);
        bv[q * 4] = v.x; bv[q * 4 + 1] = v.y;
        bv[q * 4 + 2] = v.z; bv[q * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < nk) put((t + 1) & 1);
    __syncthreads();  // the next stage is staged; this one is free
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN / 4; ++q)
      *reinterpret_cast<float4*>(
          cs + ((i / 4) * 64 + ty * 4 + i % 4) * LDC + q * 64 + tx * 4) =
          make_float4(acc[i][q * 4], acc[i][q * 4 + 1], acc[i][q * 4 + 2],
                      acc[i][q * 4 + 3]);
  __syncthreads();
}

// Each in-bounds element of the fp32 (BM, BN) shared tile, once:
// put(global row, global column, value).
template <int BM, int BN, typename Put>
__device__ void for_each_in_tile(const float* cs, int M, int N, int m0,
                                 int n0, const Put& put) {
  constexpr int LDC = BN + 4;
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = i / BN, cc = i % BN;
    const int gr = m0 + r, gc = n0 + cc;
    if (gr < M && gc < N) put(gr, gc, cs[r * LDC + cc]);
  }
}
