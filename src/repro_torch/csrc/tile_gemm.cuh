// One (BM, BN) output tile of a GEMM-shaped product and its whole K loop,
// shared by K1a (mma_gemm.cu) and K3's implicit GEMM (mma_conv.cu).  The
// two differ only in where the A panel comes from, so the tile loops take
// an A loader with two members, each called by every thread of the block:
//
//   ld.template panel<BM, BK, LDA>(T* as, int k0)
//       the (BM, BK) A panel of the K step at k0, row-major, row pitch LDA;
//   ld.template panel_kmajor<BM, BK, LDT>(float* as, int k0)
//       the same panel for F32GER, k-major: as[kk * LDT + r];
//
// and, for K1's fp32 SIMT tile (f32_simt_tile), one more:
//
//   ld.chunk4(int r, int k)
//       the 4 fp32 values of tile row r at k .. k + 3 (k a multiple of 4);
//
// each zero past the M and K fringes: RowMajorA over natural rows, PackedA
// over core/packing.py's X-side panels (K1d), MaskedRowMajorA /
// MaskedPackedA for the pm* forms.  B is a (K, N) matrix, read through
// a B loader with the same two members (panel<BK, BN, LDB> for the 16-bit
// tile, panel_f32<BK, BN, LDB> for F32GER, both row-major (BK, BN) at k0):
// (and chunk4(int k, int c) for the SIMT tile: row k, tile columns c ..
// c + 3), RowMajorB over natural rows, PackedB over core/packing.py's 64-column
// panels (K1d, and K3's packed filter stream), or MaskedRowMajorB /
// MaskedPackedB for the pm* forms.
// Both loops leave the fp32 tile in shared memory (row pitch BN + 4,
// aliasing the panels) for the caller's store; with `seeded` that tile
// holds the fp32 seed on entry.
//
// The pm* predicates (K1b, paper eq. 3) are byte masks over M, N and K
// (PmMasks; a null pointer enables every lane).  The masked loaders apply
// them while they stage a panel: a disabled row of A, column of B or rank
// (the k-slice of both panels) is written as 0 through the same branch
// that zero-fills the fringes, never multiplied, so a NaN there leaves no
// trace.  K3's loaders (mma_conv.cu) take the unmasked ones.
#pragma once

#include <mma.h>

#include "common.cuh"

// A (ROWS, COLS) window of a row-major (g_rows, g_cols) matrix into shared
// memory with row pitch LD, in 8-element (16-byte) chunks; zero past the
// fringe so partial products beyond M, N or K are exact zeros.
template <typename T, int ROWS, int COLS, int LD>
__device__ void load_panel(T* s, const T* g, int g_rows, int g_cols, int r0,
                           int c0, bool vec) {
  constexpr int CH = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c8 = (i % CH) * 8;
    const int gr = r0 + r, gc = c0 + c8;
    T* dst = s + r * LD + c8;
    const T* src = g + (long long)gr * g_cols + gc;
    if (vec && gr < g_rows && gc + 8 <= g_cols) {
      *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (gr < g_rows && gc + e < g_cols)
          dst[e] = src[e];
        else
          dst[e] = zero_of<T>();
      }
    }
  }
}

// The 16-bit lanes of an 8-element (16-byte) chunk selected by the mask
// bytes [c, c + 8), read as one 8-byte word (c is a multiple of 8 and the
// masks are 16-byte aligned): 0xffff where a byte is nonzero, else 0.
__device__ __forceinline__ void select_chunk16(uint4& v, const uint8_t* mask,
                                               int c) {
  const uint2 m = *reinterpret_cast<const uint2*>(mask + c);
  const uint32_t lo = __vcmpne4(m.x, 0u), hi = __vcmpne4(m.y, 0u);
  v.x &= __byte_perm(lo, 0u, 0x1100);
  v.y &= __byte_perm(lo, 0u, 0x3322);
  v.z &= __byte_perm(hi, 0u, 0x1100);
  v.w &= __byte_perm(hi, 0u, 0x3322);
}

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

// The GEMM's A: rows m0.. of a row-major (M, K) matrix.
template <typename T>
struct RowMajorA {
  const T* x;
  int M, K, m0;
  bool vec;

  template <int BM, int BK, int LDA>
  __device__ void panel(T* as, int k0) const {
    load_panel<T, BM, BK, LDA>(as, x, M, K, m0, k0, vec);
  }

  template <int BM, int BK, int LDT>
  __device__ void panel_kmajor(float* as, int k0) const {
    for (int i = threadIdx.x; i < BM * BK; i += blockDim.x) {
      const int r = i / BK, kk = i % BK;
      const int gr = m0 + r, gk = k0 + kk;
      as[kk * LDT + r] = (gr < M && gk < K) ? x[(long long)gr * K + gk] : 0.f;
    }
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
  bool vec;

  template <int BK, int BN, int LDB>
  __device__ void panel(T* bs, int k0) const {
    load_panel<T, BK, BN, LDB>(bs, y, K, N, k0, n0, vec);
  }

  template <int BK, int BN, int LDB>
  __device__ void panel_f32(float* bs, int k0) const {
    for (int i = threadIdx.x; i < BK * BN; i += blockDim.x) {
      const int kk = i / BN, cc = i % BN;
      const int gk = k0 + kk, gc = n0 + cc;
      bs[kk * LDB + cc] = (gk < K && gc < N) ? y[(long long)gk * N + gc] : 0.f;
    }
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

// A with the row and rank predicates: a disabled row or rank is staged as
// 0 where the fringe is.  The 16-byte vector load stays where the chunk
// lies inside the matrix and is issued beside the mask loads (no branch
// waits on a mask); its disabled lanes are then selected to 0.
template <typename T>
struct MaskedRowMajorA {
  const T* x;
  int M, K, m0;
  bool vec;
  PmMasks mk;

  template <int BM, int BK, int LDA>
  __device__ void panel(T* as, int k0) const {
    constexpr int CH = BK / 8;
    for (int i = threadIdx.x; i < BM * CH; i += blockDim.x) {
      const int r = i / CH, c8 = (i % CH) * 8;
      const int gr = m0 + r, gc = k0 + c8;
      T* dst = as + r * LDA + c8;
      const T* src = x + (long long)gr * K + gc;
      if (gr < M && vec && gc + 8 <= K) {
        uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        const uint32_t row = lane_on(mk.xm, gr) ? ~0u : 0u;
        if (mk.pm) select_chunk16(v, mk.pm, gc);
        v.x &= row; v.y &= row; v.z &= row; v.w &= row;
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const bool row = gr < M && lane_on(mk.xm, gr);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (row && gc + e < K && lane_on(mk.pm, gc + e))
            dst[e] = src[e];
          else
            dst[e] = zero_of<T>();
        }
      }
    }
  }

  template <int BM, int BK, int LDT>
  __device__ void panel_kmajor(float* as, int k0) const {
    for (int i = threadIdx.x; i < BM * BK; i += blockDim.x) {
      const int r = i / BK, kk = i % BK;
      const int gr = m0 + r, gk = k0 + kk;
      const bool in = gr < M && gk < K;
      const float v = in ? x[(long long)gr * K + gk] : 0.f;
      as[kk * LDT + r] =
          in && lane_on(mk.xm, gr) && lane_on(mk.pm, gk) ? v : 0.f;
    }
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

// B with the column and rank predicates, staged as MaskedRowMajorA is.
template <typename T>
struct MaskedRowMajorB {
  const T* y;
  int K, N, n0;
  bool vec;
  PmMasks mk;

  template <int BK, int BN, int LDB>
  __device__ void panel(T* bs, int k0) const {
    constexpr int CH = BN / 8;
    for (int i = threadIdx.x; i < BK * CH; i += blockDim.x) {
      const int r = i / CH, c8 = (i % CH) * 8;
      const int gk = k0 + r, gc = n0 + c8;
      T* dst = bs + r * LDB + c8;
      const T* src = y + (long long)gk * N + gc;
      if (gk < K && vec && gc + 8 <= N) {
        uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        const uint32_t row = lane_on(mk.pm, gk) ? ~0u : 0u;
        if (mk.ym) select_chunk16(v, mk.ym, gc);
        v.x &= row; v.y &= row; v.z &= row; v.w &= row;
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const bool row = gk < K && lane_on(mk.pm, gk);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (row && gc + e < N && lane_on(mk.ym, gc + e))
            dst[e] = src[e];
          else
            dst[e] = zero_of<T>();
        }
      }
    }
  }

  template <int BK, int BN, int LDB>
  __device__ void panel_f32(float* bs, int k0) const {
    for (int i = threadIdx.x; i < BK * BN; i += blockDim.x) {
      const int kk = i / BN, cc = i % BN;
      const int gk = k0 + kk, gc = n0 + cc;
      const bool in = gk < K && gc < N;
      const float v = in ? y[(long long)gk * N + gc] : 0.f;
      bs[kk * LDB + cc] =
          in && lane_on(mk.pm, gk) && lane_on(mk.ym, gc) ? v : 0.f;
    }
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
// slab row, contiguous and 16-byte aligned, so it is one 16-byte load at
// any N: whisper's 51865-column lm_head too, whose natural rows take
// RowMajorB's scalar path.  A chunk that starts past N or a row past K
// stages as 0, as RowMajorB's fringe does, and a chunk across N reads the
// zero padding: the staged panel, and so the result, is the natural
// loader's bit for bit.  The tiles read (BK, BN) stages out of the fixed
// panels: (32, 128) is two panels' columns, half a panel deep; (64, 64)
// exactly one panel; F32GER's (16, 64) a quarter of one, (16, 128) a
// quarter of two.
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

  template <int BK, int BN, int LDB>
  __device__ void panel(T* bs, int k0) const {
    constexpr int CH = BN / 8;
    for (int i = threadIdx.x; i < BK * CH; i += blockDim.x) {
      const int r = i / CH, c8 = (i % CH) * 8;
      const int gk = k0 + r, gc = n0 + c8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);  // +0.0 in bf16 and f16
      if (gk < K && gc < N)
        v = __ldg(reinterpret_cast<const uint4*>(at(gk, gc)));
      *reinterpret_cast<uint4*>(bs + r * LDB + c8) = v;
    }
  }

  template <int BK, int BN, int LDB>
  __device__ void panel_f32(float* bs, int k0) const {
    constexpr int CH = BN / 4;
    for (int i = threadIdx.x; i < BK * CH; i += blockDim.x) {
      const int r = i / CH, c4 = (i % CH) * 4;
      const int gk = k0 + r, gc = n0 + c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk < K && gc < N)
        v = __ldg(reinterpret_cast<const float4*>(at(gk, gc)));
      *reinterpret_cast<float4*>(bs + r * LDB + c4) = v;
    }
  }

  __device__ __forceinline__ float4 chunk4(int k, int c) const {
    const int gc = n0 + c;
    if (k >= K || gc >= N) return make_float4(0.f, 0.f, 0.f, 0.f);
    return __ldg(reinterpret_cast<const float4*>(at(k, gc)));
  }
};

// Packed B with the column and rank predicates, applied as the stage goes
// to shared memory, as MaskedRowMajorB does: a disabled rank's row is not
// loaded, a disabled column's lanes are selected to 0 from the loaded
// chunk (so NaN or Inf there gives exact zeros).  A chunk across N reads
// no mask byte past N: its lanes there are 0 by the fringe rule.
template <typename T>
struct MaskedPackedB {
  PackedB<T> p;
  PmMasks mk;

  template <int BK, int BN, int LDB>
  __device__ void panel(T* bs, int k0) const {
    constexpr int CH = BN / 8;
    for (int i = threadIdx.x; i < BK * CH; i += blockDim.x) {
      const int r = i / CH, c8 = (i % CH) * 8;
      const int gk = k0 + r, gc = p.n0 + c8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gk < p.K && gc < p.N && lane_on(mk.pm, gk)) {
        v = __ldg(reinterpret_cast<const uint4*>(p.at(gk, gc)));
        if (gc + 8 <= p.N) {
          if (mk.ym) select_chunk16(v, mk.ym, gc);
        } else {
          T* lanes = reinterpret_cast<T*>(&v);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (gc + e >= p.N || !lane_on(mk.ym, gc + e))
              lanes[e] = zero_of<T>();
        }
      }
      *reinterpret_cast<uint4*>(bs + r * LDB + c8) = v;
    }
  }

  template <int BK, int BN, int LDB>
  __device__ void panel_f32(float* bs, int k0) const {
    constexpr int CH = BN / 4;
    for (int i = threadIdx.x; i < BK * CH; i += blockDim.x) {
      const int r = i / CH, c4 = (i % CH) * 4;
      const int gk = k0 + r, gc = p.n0 + c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk < p.K && gc < p.N && lane_on(mk.pm, gk)) {
        v = __ldg(reinterpret_cast<const float4*>(p.at(gk, gc)));
        if (gc + 0 >= p.N || !lane_on(mk.ym, gc + 0)) v.x = 0.f;
        if (gc + 1 >= p.N || !lane_on(mk.ym, gc + 1)) v.y = 0.f;
        if (gc + 2 >= p.N || !lane_on(mk.ym, gc + 2)) v.z = 0.f;
        if (gc + 3 >= p.N || !lane_on(mk.ym, gc + 3)) v.w = 0.f;
      }
      *reinterpret_cast<float4*>(bs + r * LDB + c4) = v;
    }
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
// aligned, so it is one 16-byte load at any K: RowMajorA's natural rows
// take its element path wherever K is not a multiple of 8.  A chunk that
// starts past K or a row past M stages as 0, as RowMajorA's fringe does,
// and a chunk across K reads the zero padding: the staged panel, and so
// the result, is the natural loader's bit for bit.  The tiles' (BM, BK)
// stages: (128, 32) is one panel's 128 rows, half its depth; (64, 64)
// half its rows, all its depth; F32GER's k-major (64, 16) half its rows,
// a quarter of its depth, (128, 16) all its rows.
template <typename T>
struct PackedA {
  const T* x;
  int M, K, m0, gk;

  __device__ __forceinline__ const T* at(int m, int k) const {
    return x + x_panel_at(m, k, gk);
  }

  template <int BM, int BK, int LDA>
  __device__ void panel(T* as, int k0) const {
    constexpr int CH = BK / 8;
    for (int i = threadIdx.x; i < BM * CH; i += blockDim.x) {
      const int r = i / CH, c8 = (i % CH) * 8;
      const int gr = m0 + r, gc = k0 + c8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);  // +0.0 in bf16 and f16
      if (gr < M && gc < K)
        v = __ldg(reinterpret_cast<const uint4*>(at(gr, gc)));
      *reinterpret_cast<uint4*>(as + r * LDA + c8) = v;
    }
  }

  template <int BM, int BK, int LDT>
  __device__ void panel_kmajor(float* as, int k0) const {
    constexpr int CH = BK / 4;
    for (int i = threadIdx.x; i < BM * CH; i += blockDim.x) {
      const int r = i / CH, c4 = (i % CH) * 4;
      const int gr = m0 + r, gc = k0 + c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < M && gc < K)
        v = __ldg(reinterpret_cast<const float4*>(at(gr, gc)));
      as[c4 * LDT + r] = v.x;
      as[(c4 + 1) * LDT + r] = v.y;
      as[(c4 + 2) * LDT + r] = v.z;
      as[(c4 + 3) * LDT + r] = v.w;
    }
  }

  __device__ __forceinline__ float4 chunk4(int r, int k) const {
    const int gr = m0 + r;
    if (gr >= M || k >= K) return make_float4(0.f, 0.f, 0.f, 0.f);
    return __ldg(reinterpret_cast<const float4*>(at(gr, k)));
  }
};

// Packed A with the row and rank predicates, applied as the stage goes to
// shared memory, as MaskedRowMajorA does: a disabled row is not loaded, a
// disabled rank's lanes are selected to 0 from the loaded chunk (so NaN or
// Inf there gives exact zeros).  A chunk across K reads no mask byte past
// K: its lanes there are 0 by the fringe rule.
template <typename T>
struct MaskedPackedA {
  PackedA<T> p;
  PmMasks mk;

  template <int BM, int BK, int LDA>
  __device__ void panel(T* as, int k0) const {
    constexpr int CH = BK / 8;
    for (int i = threadIdx.x; i < BM * CH; i += blockDim.x) {
      const int r = i / CH, c8 = (i % CH) * 8;
      const int gr = p.m0 + r, gc = k0 + c8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < p.M && gc < p.K && lane_on(mk.xm, gr)) {
        v = __ldg(reinterpret_cast<const uint4*>(p.at(gr, gc)));
        if (gc + 8 <= p.K) {
          if (mk.pm) select_chunk16(v, mk.pm, gc);
        } else {
          T* lanes = reinterpret_cast<T*>(&v);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (gc + e >= p.K || !lane_on(mk.pm, gc + e))
              lanes[e] = zero_of<T>();
        }
      }
      *reinterpret_cast<uint4*>(as + r * LDA + c8) = v;
    }
  }

  template <int BM, int BK, int LDT>
  __device__ void panel_kmajor(float* as, int k0) const {
    constexpr int CH = BK / 4;
    for (int i = threadIdx.x; i < BM * CH; i += blockDim.x) {
      const int r = i / CH, c4 = (i % CH) * 4;
      const int gr = p.m0 + r, gc = k0 + c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < p.M && gc < p.K && lane_on(mk.xm, gr)) {
        v = __ldg(reinterpret_cast<const float4*>(p.at(gr, gc)));
        if (gc + 0 >= p.K || !lane_on(mk.pm, gc + 0)) v.x = 0.f;
        if (gc + 1 >= p.K || !lane_on(mk.pm, gc + 1)) v.y = 0.f;
        if (gc + 2 >= p.K || !lane_on(mk.pm, gc + 2)) v.z = 0.f;
        if (gc + 3 >= p.K || !lane_on(mk.pm, gc + 3)) v.w = 0.f;
      }
      as[c4 * LDT + r] = v.x;
      as[(c4 + 1) * LDT + r] = v.y;
      as[(c4 + 2) * LDT + r] = v.z;
      as[(c4 + 3) * LDT + r] = v.w;
    }
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

template <typename T, int BM, int BN, int BK>
__host__ __device__ constexpr size_t wmma_smem_bytes() {
  constexpr size_t panels =
      ((size_t)BM * (BK + 8) + (size_t)BK * (BN + 8)) * sizeof(T);
  constexpr size_t ctile = (size_t)BM * (BN + 4) * sizeof(float);
  return panels > ctile ? panels : ctile;
}

// bf16 / f16 tensor-core tile: WM x WN warps, each owning a
// (BM/WM, BN/WN) slice of the accumulator as 16x16 fp32 fragments.
template <typename T, int BM, int BN, int BK, int WM, int WN, typename ALoader,
          typename BLoader>
__device__ void wmma_tile_ab(unsigned char* smem, const ALoader& ld,
                             const BLoader& bl, int K, bool seeded) {
  namespace wmma = nvcuda::wmma;
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  constexpr int TM = BM / WM, TN = BN / WN;
  constexpr int FM = TM / 16, FN = TN / 16;
  T* as = reinterpret_cast<T*>(smem);
  T* bs = as + BM * LDA;
  float* cs = reinterpret_cast<float*>(smem);  // aliases the panels
  const int warp = threadIdx.x / 32;
  const int wm = warp / WN, wn = warp % WN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
  if (seeded) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(acc[i][j],
                               cs + (wm * TM + i * 16) * LDC + wn * TN + j * 16,
                               LDC, wmma::mem_row_major);
    __syncthreads();  // the panels overwrite the seed tile next
  } else {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    ld.template panel<BM, BK, LDA>(as, k0);
    bl.template panel<BK, BN, LDB>(bs, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * TM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * LDB + wn * TN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cs + (wm * TM + i * 16) * LDC + wn * TN + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
}

// The tile over a row-major B (K3's implicit GEMM, the unmasked GEMM).
template <typename T, int BM, int BN, int BK, int WM, int WN, typename ALoader>
__device__ void wmma_tile(unsigned char* smem, const ALoader& ld, const T* y,
                          int K, int N, int n0, bool vec_y, bool seeded) {
  const RowMajorB<T> bl{y, K, N, n0, vec_y};
  wmma_tile_ab<T, BM, BN, BK, WM, WN>(smem, ld, bl, K, seeded);
}

// F32GER: true fp32 FMAs on the CUDA cores (no TF32).  256 threads, each
// holding a 4x4 register accumulator strided over the (BM, BN) tile, one
// synchronous stage a K step: K3's fp32 conv (mma_conv.cu).  K1's fp32
// products run f32_simt_tile below.
constexpr int F32_BM = 64, F32_BN = 64, F32_BK = 16;

__host__ __device__ constexpr size_t f32_smem_bytes() {
  constexpr size_t panels =
      ((size_t)F32_BK * (F32_BM + 4) + (size_t)F32_BK * (F32_BN + 4)) * 4;
  constexpr size_t ctile = (size_t)F32_BM * (F32_BN + 4) * 4;
  return panels > ctile ? panels : ctile;
}

template <typename ALoader, typename BLoader>
__device__ void f32_tile_ab(unsigned char* smem, const ALoader& ld,
                            const BLoader& bl, int K, bool seeded) {
  constexpr int BM = F32_BM, BN = F32_BN, BK = F32_BK;
  constexpr int LDT = BM + 4, LDB = BN + 4, LDC = BN + 4;
  float* as = reinterpret_cast<float*>(smem);  // k-major: as[kk][row]
  float* bs = as + BK * LDT;
  float* cs = reinterpret_cast<float*>(smem);  // aliases the panels
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
  if (seeded) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = cs[(ty + 16 * i) * LDC + tx + 16 * j];
    __syncthreads();
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    ld.template panel_kmajor<BM, BK, LDT>(as, k0);
    bl.template panel_f32<BK, BN, LDB>(bs, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk * LDT + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();
}

template <typename ALoader>
__device__ void f32_tile(unsigned char* smem, const ALoader& ld,
                         const float* y, int K, int N, int n0, bool seeded) {
  f32_tile_ab(smem, ld, RowMajorB<float>{y, K, N, n0, false}, K, seeded);
}

// K1's F32GER tile (mma_gemm.cu's gemm_f32_kernel): a register-blocked
// SIMT GEMM on the CUDA cores, true fp32 FMAs (never TF32).  256 threads
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
// ceil(K / 16) * 16 - 1 in ascending order from the seed or +0.0 -- the
// chain of f32_tile_ab -- so the result is the same bits at either tile
// size and with either loader.  The fp32 tile that the panels alias
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
