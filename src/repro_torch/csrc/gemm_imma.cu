// Integer GEMM for Hopper (sm_90a): the IMMA kernel.
//
// Replaces the integer half of the TPU kernel K1: repro/kernels/mma_gemm.py,
// mma_gemm (kernel body _make_kernel: _unpack_int4 on the panels, int32
// panels and an int32 accumulator), for the families
//
//   I8GER4  (xvi8ger4):  int8 X times uint8 Y, int32 accumulator;
//   I4GER8  (xvi4ger8):  int4 X and Y packed two a byte along K (low
//                        nibble first), int32 accumulator;
//   I16GER2 (xvi16ger2): int16 X and Y, int32 accumulator;
//
// 2-D and batched operands (batch on the grid), the accumulate forms and
// the epilogues an integer accumulator admits:
//
//   out = cast(residual + relu?(bias + alpha * ([-](X @ Y) + s * beta * C)))
//
// all in int32 arithmetic that wraps modulo 2^32, as the reference's int32
// dot_general and its int32 alpha/beta (truncated to integers by the
// wrapper) do (deprime()).  Prepacked X and Y panels (K1d) are read in
// I8GER4 and I16GER2.  The ABFT sidecar (K1e) is not here.
//
// What bounds it on an H100: the int8 tensor cores (1979 TOP/s dense) for
// large products; the operands' bytes (3.35 TB/s) for skinny ones.
//
// Three forms, chosen up front by core/tiling.py's imma_plan (the launcher's
// `form`), never as a retry:
//   * the wgmma tile (form A, below: a pre-pass writes K-major byte planes,
//     TMA feeds wgmma from them) for every unmasked product whose pitches
//     TMA can read;
//   * I8GER4's weight stream (form B, below) for quant.qdot's decode: N <=
//     64 activation columns, X the int8 weight, K split over the card;
//   * the mma.sync kernel (here first) for the pm* masked forms
//     (K1b), pitches TMA cannot read and an explicit block.  Its masked
//     instances take row, column and rank predicates in I8GER4 and
//     I16GER2, a column one in I4GER8 (its row and rank predicates go
//     through ref.pm_ger, as the reference's kernel refuses them).
// Every form sums the same exact byte products modulo 2^32, so every form
// gives every output bit for bit.
//
// The mma.sync kernel.  mma.sync.aligned.m16n8k32 with s8/u8 operands and
// an s32
// accumulator, never .satfinite (it would clamp once per 32-deep
// instruction, which is neither gemm's wrap nor gemm.saturating's clamp
// per rank-r update).  The instruction wants both panels K-contiguous: X is,
// Y (K, N) is not, and sm_90 has no 8-bit ldmatrix .trans, so each thread
// stages 4 (k) x 4 (n) bytes of Y and transposes them in registers
// (__byte_perm) on their way to shared memory, where the Y^T rows are
// XOR-swizzled so that both the transposed stores and the fragment reads
// spread over the banks.
//   * I4GER8: the nibbles are unpacked to s8 while the panels are staged
//     (Hopper's tensor cores do no int4 work); logical K = 2 x packed K.
//   * I16GER2: Hopper has no int16 MMA.  Each int16 splits into a signed
//     high byte and an unsigned low byte, v = 256 h + l, and
//     x y = 2^16 (xh yh) + 2^8 (xh yl + xl yh) + xl yl: four IMMA products
//     into three accumulators (s8.s8, s8.u8 + u8.s8, u8.u8), combined by
//     shifts at the deprime.  Every step is exact modulo 2^32, so the
//     result is the wrapped int32 dot product bit for bit.
// One thread block owns one (BM, 128) output tile and runs the whole
// k-loop; global loads for the next 64-deep stage are issued into
// registers before the current stage's MMAs, and stored into the second
// of two shared-memory buffers after them (one barrier a stage).  The
// deprime goes through a shared int32 tile, so that each output element is
// stored once, coalesced, in the requested dtype.
//   * Prepacked operands (K1d: repro/kernels/mma_gemm.py's packed_spec;
//     quant.qdot's signed int8 weights are X panels, spec "kn,mk->mn"):
//     with `panels` set, X arrives as core/packing.py's X-side
//     (gm, gk, 128, 64) panels and/or Y as its Y-side (gn, gk, 64, 64)
//     panels (common.cuh's x_panel_at / y_panel_at), per batch element,
//     zero-padded past M, K and N, in I8GER4 (bytes) and I16GER2 (int16
//     elements).  A block's 64-deep stage is one panel deep: an X unit
//     (16 int8 or 8 int16 of a row) is one 16-byte load from a panel row
//     (I8GER4's 128 rows are one panel, I16GER2's 64 half of one), a Y
//     unit's row of 4 columns one 4- or 8-byte load (its 128 columns are
//     two panels), whatever K and N.  The loaded words then take the
//     natural path: the same transposes, the same I16GER2 byte split, the
//     same masks; a unit past M, K or N stages as 0, one across K or N
//     reads the zero padding.  So the staged registers, and the result,
//     are the natural launch's bit for bit.  Which operands are panels
//     is the kernels' PANELS template argument (common.cuh's PANELS_X |
//     PANELS_Y), so the natural instances are unchanged.  I4GER8 keeps its nibbles:
//     it takes no panels (the reference refuses packed int4 too).
//   * Masked (K1b): the MASKED instances load each unit's mask bytes (4 or
//     16 at a time) beside its data and clear the disabled lanes of the
//     staged registers when the stage goes to shared memory, after the
//     current stage's MMAs, so the masks wait on no load: a disabled row
//     or rank of X, or rank or column of Y, is staged as 0 as the fringe
//     lanes are (for I16GER2 both bytes of an int16, so it is 0 in all
//     four byte products).

#include "hopper.cuh"

namespace {

enum { FAM_I8 = 0, FAM_I4 = 1, FAM_I16 = 2 };

constexpr int BN = 128;       // output columns a block
constexpr int BK = 64;        // logical (unpacked) K a stage
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = WARPS_M * WARPS_N * 32;
constexpr int NT = 4;         // n8 tiles a warp (warp tile 16 MT x 32)
constexpr int XP = BK + 16;   // X plane row pitch in bytes (conflict-free)
constexpr int YP = BK;        // Y^T plane row pitch in bytes (swizzled)
constexpr int CP = BN + 4;    // int32 deprime tile pitch

struct ImmaArgs {
  const void* x;
  const void* y;
  const int* c;
  const int* bias;
  const int* res;
  void* out;
  int out_dt;
  int M, N, K;                         // K is logical: 2 x packed for I4GER8
  long long sxb, syb, scb, srb, sob;   // batch strides in stored elements
  int alpha, beta, neg_product, neg_acc, relu;
  int vec_x, vec_y;                    // vector global loads allowed
  int x_gk, y_gk;                      // panels along K (PANELS instances)
  const uint8_t* xm;                   // pm* byte masks over M, N and
  const uint8_t* ym;                   // logical K, each null or one byte
  const uint8_t* pm;                   // a lane (the MASKED instances)
};

template <int FAM>
struct Fam {
  static constexpr int planes = FAM == FAM_I16 ? 2 : 1;
  static constexpr int mt = FAM == FAM_I16 ? 2 : 4;   // m16 tiles a warp
  static constexpr int bm = WARPS_M * 16 * mt;
  static constexpr int accs = FAM == FAM_I16 ? 3 : 1;
  static constexpr int x_units = bm * (FAM == FAM_I16 ? 8 : 4) / THREADS;
  static constexpr int y_units = (BK / 4) * (BN / 4) / THREADS;
  static constexpr int plane_bytes = bm * XP + BN * YP;
  static constexpr int stage_bytes = planes * plane_bytes;
  static constexpr size_t smem() {
    const size_t panels = 2 * (size_t)stage_bytes;
    const size_t ctile = (size_t)bm * CP * 4;
    return panels > ctile ? panels : ctile;
  }
};

// XOR swizzle of the 4-byte word kw (0..15) of Y^T row n: the transposed
// stores (a warp over 32 column quads) hit 16 banks, the fragment reads
// (8 rows x 4 words) all 32.
__device__ __forceinline__ int ysw(int n, int kw) {
  const int s = ((((n >> 1) ^ (n >> 3)) & 3) << 2) | ((n >> 5) & 3);
  return n * YP + 4 * (kw ^ s);
}

// Sign-extended low / high nibbles of the four bytes of v, as four s8.
__device__ __forceinline__ uint32_t nib_lo(uint32_t v) {
  return __vsub4((v & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t nib_hi(uint32_t v) {
  return __vsub4(((v >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}

// 4 x 4 byte transpose: r[i] holds row i's bytes 0..3; w[j] gets byte j of
// every row.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&w)[4]) {
  const uint32_t a = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t b = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t c = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t d = __byte_perm(r[2], r[3], 0x7362);
  w[0] = __byte_perm(a, c, 0x5410);
  w[1] = __byte_perm(a, c, 0x7632);
  w[2] = __byte_perm(b, d, 0x5410);
  w[3] = __byte_perm(b, d, 0x7632);
}

template <bool AS, bool BS>
__device__ __forceinline__ void imma(int (&d)[4], const uint32_t* a,
                                     const uint32_t* b) {
  if constexpr (AS && BS) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else if constexpr (AS && !BS) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else if constexpr (!AS && BS) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// ---- staging: one 64-deep stage of X and Y into registers ----------------
// X unit: 16 k of one row (I8), 16 k unpacked from 8 packed bytes (I4) or
// 8 k split into their high and low bytes (I16).  Y unit: 4 k x 4 n.

template <int FAM>
struct Staged {
  uint32_t x[Fam<FAM>::x_units][4];
  uint32_t y[Fam<FAM>::y_units][FAM == FAM_I16 ? 8 : 4];
  // the MASKED instances: raw mask bytes of each unit (nonzero: enabled)
  uint32_t xr[Fam<FAM>::x_units];                      // its row (xm)
  uint32_t xp[Fam<FAM>::x_units][FAM == FAM_I16 ? 2 : 4];  // its ranks
  uint32_t yp[Fam<FAM>::y_units];                      // its 4 ranks (pm)
  uint32_t yc[Fam<FAM>::y_units];                      // its 4 columns
};

// Bytes [i, i + 4 * W) of a byte mask as W words, loaded whole where they
// lie inside [0, limit) (the masks are 16-byte aligned); past the limit a
// byte reads 0 (its lanes are zero-filled anyway).  A null mask enables
// every lane.
template <int W>
__device__ __forceinline__ void mask_words(uint32_t (&w)[W], const uint8_t* m,
                                           int i, int limit) {
  if (m == nullptr) {
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = ~0u;
  } else if (i + 4 * W <= limit) {
    if constexpr (W == 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(m + i);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (W == 2) {
      const uint2 q = *reinterpret_cast<const uint2*>(m + i);
      w[0] = q.x; w[1] = q.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(m + i);
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      w[j] = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (i + 4 * j + b < limit)
          w[j] |= (uint32_t)m[i + 4 * j + b] << (8 * b);
    }
  }
}

// 0xff in each byte whose mask byte is nonzero.
__device__ __forceinline__ uint32_t keep_bytes(uint32_t m) {
  return __vcmpne4(m, 0u);
}

template <int FAM, bool MASKED, int PANELS>
__device__ __forceinline__ void load_stage(Staged<FAM>& st, const ImmaArgs& a,
                                           const uint8_t* xb, const uint8_t* yb,
                                           int m0, int n0, int k0) {
  using F = Fam<FAM>;
  constexpr bool PX = (PANELS & PANELS_X) != 0, PY = (PANELS & PANELS_Y) != 0;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < F::x_units; ++i) {
    const int u = tid + i * THREADS;
    uint32_t* v = st.x[i];
    v[0] = v[1] = v[2] = v[3] = 0u;
    if constexpr (FAM == FAM_I8) {
      const int row = m0 + u / 4, k = k0 + 16 * (u % 4);
      if constexpr (PX) {
        // one 16-byte load from a zero-padded panel row
        if (row < a.M && k < a.K) {
          const uint4 q = *reinterpret_cast<const uint4*>(
              xb + x_panel_at(row, k, a.x_gk));
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        }
      } else if (row < a.M) {
        const uint8_t* p = xb + (long long)row * a.K + k;
        if (a.vec_x) {
          if (k < a.K) {
            const uint4 q = *reinterpret_cast<const uint4*>(p);
            v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (k + j < a.K) v[j / 4] |= (uint32_t)p[j] << (8 * (j % 4));
        }
      }
      if constexpr (MASKED) {
        st.xr[i] = (row < a.M && a.xm) ? (uint32_t)a.xm[row] : 1u;
        mask_words<4>(st.xp[i], a.pm, k, a.K);
      }
    } else if constexpr (FAM == FAM_I4) {
      const int kp_n = a.K / 2;
      const int row = m0 + u / 4, kp = k0 / 2 + 8 * (u % 4);
      uint32_t w0 = 0u, w1 = 0u;
      if (row < a.M) {
        const uint8_t* p = xb + (long long)row * kp_n + kp;
        if (a.vec_x) {
          if (kp < kp_n) {
            const uint2 q = *reinterpret_cast<const uint2*>(p);
            w0 = q.x; w1 = q.y;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (kp + j < kp_n) {
              if (j < 4) w0 |= (uint32_t)p[j] << (8 * j);
              else w1 |= (uint32_t)p[j] << (8 * (j - 4));
            }
        }
      }
      // zero bytes unpack to zero nibbles, so the K fringe stays zero
      const uint32_t l0 = nib_lo(w0), h0 = nib_hi(w0);
      const uint32_t l1 = nib_lo(w1), h1 = nib_hi(w1);
      v[0] = __byte_perm(l0, h0, 0x5140);
      v[1] = __byte_perm(l0, h0, 0x7362);
      v[2] = __byte_perm(l1, h1, 0x5140);
      v[3] = __byte_perm(l1, h1, 0x7362);
    } else {  // FAM_I16: 8 int16 -> 8 high bytes (v[0..1]), 8 low (v[2..3])
      const int row = m0 + u / 8, k = k0 + 8 * (u % 8);
      uint32_t q[4] = {0u, 0u, 0u, 0u};
      if constexpr (PX) {
        if (row < a.M && k < a.K) {   // one 16-byte load from a panel row
          const uint4 t = *reinterpret_cast<const uint4*>(
              reinterpret_cast<const uint16_t*>(xb) +
              x_panel_at(row, k, a.x_gk));
          q[0] = t.x; q[1] = t.y; q[2] = t.z; q[3] = t.w;
        }
      } else if (row < a.M) {
        const uint16_t* p =
            reinterpret_cast<const uint16_t*>(xb) + (long long)row * a.K + k;
        if (a.vec_x) {
          if (k < a.K) {
            const uint4 t = *reinterpret_cast<const uint4*>(p);
            q[0] = t.x; q[1] = t.y; q[2] = t.z; q[3] = t.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k + j < a.K) q[j / 2] |= (uint32_t)p[j] << (16 * (j % 2));
        }
      }
      if constexpr (MASKED) {
        st.xr[i] = (row < a.M && a.xm) ? (uint32_t)a.xm[row] : 1u;
        mask_words<2>(st.xp[i], a.pm, k, a.K);
      }
      v[0] = __byte_perm(q[0], q[1], 0x7531);
      v[1] = __byte_perm(q[2], q[3], 0x7531);
      v[2] = __byte_perm(q[0], q[1], 0x6420);
      v[3] = __byte_perm(q[2], q[3], 0x6420);
    }
  }
#pragma unroll
  for (int i = 0; i < F::y_units; ++i) {
    const int u = tid + i * THREADS;
    const int kq = u / 32, n = n0 + 4 * (u % 32);
    uint32_t* v = st.y[i];
    if constexpr (MASKED) {   // I4GER8 takes no rank predicate
      uint32_t w[1] = {~0u};
      if constexpr (FAM != FAM_I4) mask_words<1>(w, a.pm, k0 + 4 * kq, a.K);
      st.yp[i] = w[0];
      mask_words<1>(w, a.ym, n, a.N);
      st.yc[i] = w[0];
    }
    if constexpr (FAM == FAM_I8) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + 4 * kq + r;
        uint32_t w = 0u;
        if constexpr (PY) {
          if (k < a.K && n < a.N)
            w = *reinterpret_cast<const uint32_t*>(yb +
                                                   y_panel_at(k, n, a.y_gk));
        } else if (k < a.K && n < a.N) {
          const uint8_t* p = yb + (long long)k * a.N + n;
          if (a.vec_y) {
            w = *reinterpret_cast<const uint32_t*>(p);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < a.N) w |= (uint32_t)p[j] << (8 * j);
          }
        }
        v[r] = w;
      }
    } else if constexpr (FAM == FAM_I4) {
      const int kp_n = a.K / 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kp = k0 / 2 + 2 * kq + r;
        uint32_t w = 0u;
        if (kp < kp_n && n < a.N) {
          const uint8_t* p = yb + (long long)kp * a.N + n;
          if (a.vec_y) {
            w = *reinterpret_cast<const uint32_t*>(p);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < a.N) w |= (uint32_t)p[j] << (8 * j);
          }
        }
        v[2 * r] = nib_lo(w);       // logical k = 2 kp
        v[2 * r + 1] = nib_hi(w);   // logical k = 2 kp + 1
      }
    } else {  // FAM_I16: row r's 4 int16 -> high bytes v[r], low v[4 + r]
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + 4 * kq + r;
        uint32_t q0 = 0u, q1 = 0u;
        if constexpr (PY) {
          if (k < a.K && n < a.N) {
            const uint2 t = *reinterpret_cast<const uint2*>(
                reinterpret_cast<const uint16_t*>(yb) +
                y_panel_at(k, n, a.y_gk));
            q0 = t.x; q1 = t.y;
          }
        } else if (k < a.K && n < a.N) {
          const uint16_t* p =
              reinterpret_cast<const uint16_t*>(yb) + (long long)k * a.N + n;
          if (a.vec_y) {
            const uint2 t = *reinterpret_cast<const uint2*>(p);
            q0 = t.x; q1 = t.y;
          } else {
            if (n < a.N) q0 |= (uint32_t)p[0];
            if (n + 1 < a.N) q0 |= (uint32_t)p[1] << 16;
            if (n + 2 < a.N) q1 |= (uint32_t)p[2];
            if (n + 3 < a.N) q1 |= (uint32_t)p[3] << 16;
          }
        }
        v[r] = __byte_perm(q0, q1, 0x7531);
        v[4 + r] = __byte_perm(q0, q1, 0x6420);
      }
    }
  }
}

// The staged registers into shared memory (plane p of X at p * plane_bytes,
// Y^T after the X planes' rows).
// (The MASKED instances clear the disabled lanes here, on their way to
// shared memory: an X unit's bytes by its rank bytes and its row, a Y
// unit's 4 rows of 4 columns by their rank and column bytes.  For I16GER2
// byte e of a plane word is element e's high or low byte, so one keep word
// serves both planes.)
template <int FAM, bool MASKED>
__device__ __forceinline__ void store_stage(const Staged<FAM>& st,
                                            unsigned char* buf) {
  using F = Fam<FAM>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < F::x_units; ++i) {
    const int u = tid + i * THREADS;
    uint32_t v[4] = {st.x[i][0], st.x[i][1], st.x[i][2], st.x[i][3]};
    if constexpr (MASKED && FAM == FAM_I16) {
      const uint32_t row = st.xr[i] ? ~0u : 0u;
      const uint32_t k0 = keep_bytes(st.xp[i][0]) & row;
      const uint32_t k1 = keep_bytes(st.xp[i][1]) & row;
      v[0] &= k0; v[2] &= k0;
      v[1] &= k1; v[3] &= k1;
    } else if constexpr (MASKED && FAM == FAM_I8) {
      const uint32_t row = st.xr[i] ? ~0u : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] &= keep_bytes(st.xp[i][j]) & row;
    }
    if constexpr (FAM == FAM_I16) {
      const int row = u / 8, off = row * XP + 8 * (u % 8);
      *reinterpret_cast<uint2*>(buf + off) = make_uint2(v[0], v[1]);
      *reinterpret_cast<uint2*>(buf + F::plane_bytes + off) =
          make_uint2(v[2], v[3]);
    } else {
      const int row = u / 4, off = row * XP + 16 * (u % 4);
      *reinterpret_cast<uint4*>(buf + off) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < F::y_units; ++i) {
    const int u = tid + i * THREADS;
    const int kq = u / 32, nq = u % 32;
#pragma unroll
    for (int p = 0; p < F::planes; ++p) {
      uint32_t r[4] = {st.y[i][4 * p], st.y[i][4 * p + 1], st.y[i][4 * p + 2],
                       st.y[i][4 * p + 3]};
      if constexpr (MASKED) {
        const uint32_t cols = keep_bytes(st.yc[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] &= ((st.yp[i] >> (8 * j)) & 0xffu) ? cols : 0u;
      }
      uint32_t w[4];
      transpose4(r, w);
      unsigned char* yt = buf + p * F::plane_bytes + F::bm * XP;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(yt + ysw(4 * nq + j, kq)) = w[j];
    }
  }
}

// ---- the deprime: forms, epilogue, cast; int32 arithmetic wraps ----------

__device__ __forceinline__ void store_i(void* out, int dt, long long i, int v) {
  if (dt == DT_I32) {
    reinterpret_cast<int*>(out)[i] = v;
  } else if (dt == DT_F64) {
    reinterpret_cast<double*>(out)[i] = (double)v;
  } else {
    // int -> float -> 16-bit, as torch converts an int32 tensor
    store_f(out, dt, i, __int2float_rn(v));
  }
}

// Output (gr, gc) of batch element bz from its product sum v: neg, then
// beta * C, then alpha, bias, relu, residual and the store cast, every step
// in uint32 arithmetic that wraps as the reference's int32 does.  Every
// form of the kernel ends here.
__device__ __forceinline__ void deprime(const ImmaArgs& a, int bz, int gr,
                                        int gc, uint32_t v) {
  const long long idx = (long long)gr * a.N + gc;
  if (a.neg_product) v = 0u - v;
  if (a.c) {
    const uint32_t s =
        (uint32_t)a.c[(long long)bz * a.scb + idx] * (uint32_t)a.beta;
    v += a.neg_acc ? 0u - s : s;
  }
  v *= (uint32_t)a.alpha;
  if (a.bias) v += (uint32_t)a.bias[gc];
  int sv = (int)v;
  if (a.relu) sv = sv > 0 ? sv : 0;
  if (a.res) sv = (int)((uint32_t)sv + (uint32_t)a.res[(long long)bz * a.srb + idx]);
  store_i(a.out, a.out_dt, (long long)bz * a.sob + idx, sv);
}

template <int FAM, bool MASKED, int PANELS>
__global__ void __launch_bounds__(THREADS, 1) gemm_imma_kernel(ImmaArgs a) {
  using F = Fam<FAM>;
  constexpr int MT = F::mt;
  extern __shared__ __align__(128) unsigned char smem[];
  const int bz = blockIdx.z, m0 = blockIdx.y * F::bm, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, t = lane % 4;
  const int esz = FAM == FAM_I16 ? 2 : 1;
  const uint8_t* xb =
      reinterpret_cast<const uint8_t*>(a.x) + (long long)bz * a.sxb * esz;
  const uint8_t* yb =
      reinterpret_cast<const uint8_t*>(a.y) + (long long)bz * a.syb * esz;

  int acc[F::accs][MT][NT][4];
#pragma unroll
  for (int p = 0; p < F::accs; ++p)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[p][i][j][r] = 0;

  const int ktiles = (a.K + BK - 1) / BK;
  Staged<FAM> st;
  load_stage<FAM, MASKED, PANELS>(st, a, xb, yb, m0, n0, 0);
  store_stage<FAM, MASKED>(st, smem);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    unsigned char* cur = smem + (kt & 1) * F::stage_bytes;
    if (kt + 1 < ktiles)
      load_stage<FAM, MASKED, PANELS>(st, a, xb, yb, m0, n0, (kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[F::planes][MT][4], bf[F::planes][NT][2];
#pragma unroll
      for (int p = 0; p < F::planes; ++p) {
        const unsigned char* xp = cur + p * F::plane_bytes;
        const unsigned char* yt = xp + F::bm * XP;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r0 = wm * 16 * MT + i * 16 + g;
          const int w0 = ks * 8 + t;
          af[p][i][0] = *reinterpret_cast<const uint32_t*>(xp + r0 * XP + 4 * w0);
          af[p][i][1] =
              *reinterpret_cast<const uint32_t*>(xp + (r0 + 8) * XP + 4 * w0);
          af[p][i][2] =
              *reinterpret_cast<const uint32_t*>(xp + r0 * XP + 4 * (w0 + 4));
          af[p][i][3] = *reinterpret_cast<const uint32_t*>(
              xp + (r0 + 8) * XP + 4 * (w0 + 4));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wn * 8 * NT + j * 8 + g;
          bf[p][j][0] =
              *reinterpret_cast<const uint32_t*>(yt + ysw(n, ks * 8 + t));
          bf[p][j][1] =
              *reinterpret_cast<const uint32_t*>(yt + ysw(n, ks * 8 + 4 + t));
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (FAM == FAM_I8) {
            imma<true, false>(acc[0][i][j], af[0][i], bf[0][j]);
          } else if constexpr (FAM == FAM_I4) {
            imma<true, true>(acc[0][i][j], af[0][i], bf[0][j]);
          } else {  // planes: 0 = signed high bytes, 1 = unsigned low bytes
            imma<true, true>(acc[0][i][j], af[0][i], bf[0][j]);
            imma<true, false>(acc[1][i][j], af[0][i], bf[1][j]);
            imma<false, true>(acc[1][i][j], af[1][i], bf[0][j]);
            imma<false, false>(acc[2][i][j], af[1][i], bf[1][j]);
          }
        }
    }
    if (kt + 1 < ktiles)
      store_stage<FAM, MASKED>(st, smem + ((kt + 1) & 1) * F::stage_bytes);
    __syncthreads();
  }

  // deprime: the accumulators through a shared int32 tile (aliasing the
  // panels, all read by now), then one coalesced pass over the tile
  int* cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t v = (uint32_t)acc[0][i][j][r];
        if constexpr (FAM == FAM_I16)
          v = (v << 16) + ((uint32_t)acc[1][i][j][r] << 8) +
              (uint32_t)acc[2][i][j][r];
        const int row = wm * 16 * MT + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = wn * 8 * NT + j * 8 + 2 * t + (r & 1);
        cs[row * CP + col] = (int)v;
      }
  __syncthreads();
  for (int e = threadIdx.x; e < F::bm * BN; e += THREADS) {
    const int row = e / BN, col = e % BN;
    const int gr = m0 + row, gc = n0 + col;
    if (gr < a.M && gc < a.N)
      deprime(a, bz, gr, gc, (uint32_t)cs[row * CP + col]);
  }
}

template <int FAM, bool MASKED, int PANELS>
int launch_one(const ImmaArgs& a, int batch, cudaStream_t stream) {
  using F = Fam<FAM>;
  static bool smem_ok = false;
  auto kernel = gemm_imma_kernel<FAM, MASKED, PANELS>;
  cudaError_t e = allow_smem(kernel, F::smem(), &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + BN - 1) / BN, (a.M + F::bm - 1) / F::bm, batch);
  kernel<<<grid, THREADS, F::smem(), stream>>>(a);
  return (int)cudaGetLastError();
}

template <int FAM, int PANELS>
int launch_masked(const ImmaArgs& a, int batch, cudaStream_t stream) {
  if (a.xm || a.ym || a.pm)
    return launch_one<FAM, true, PANELS>(a, batch, stream);
  return launch_one<FAM, false, PANELS>(a, batch, stream);
}

// The instance of `panels` (which operands are panels): a template
// argument, so the natural instances are the kernels without panels.
template <int FAM>
int launch(const ImmaArgs& a, int panels, int batch, cudaStream_t stream) {
  switch (panels) {
    case 0: return launch_masked<FAM, 0>(a, batch, stream);
    case PANELS_X: return launch_masked<FAM, PANELS_X>(a, batch, stream);
    case PANELS_Y: return launch_masked<FAM, PANELS_Y>(a, batch, stream);
    case PANELS_X | PANELS_Y:
      return launch_masked<FAM, PANELS_X | PANELS_Y>(a, batch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ======================================================================
// Form A: the int8 wgmma tile (every unmasked product TMA can read)
// ======================================================================
//
// Int8 wgmma reads both operands K-major from shared memory (its transpose
// bits are for 16-bit types only), and sm_90 has no 8-bit ldmatrix .trans.
// X (M, K) is K-major; Y (K, N) is not, and I4GER8's nibbles and
// I16GER2's int16 are no wgmma type.  So a pre-pass writes the planes the
// tile reads, once, into the wrapper's workspace: Y^T (N, K) of each
// byte plane (I8GER4's uint8; I4GER8's nibbles unpacked to s8; I16GER2's
// signed high and unsigned low bytes, v = 256 h + l), and X's planes
// where X is no int8 matrix (I4GER8 unpacked, I16GER2 split).  A
// transforming producer warpgroup that did this inside the tile could
// not keep pace with the tensor cores (timed on the H100: PERF.md); the
// pre-pass costs one read and one write of each operand at the card's
// memory rate.
//
//   * prep_y_kernel: a (64 k x 64 n) tile of Y (natural rows or 64 x 64
//     Y panels) through shared memory, 16-byte loads in, then each thread
//     gathers 16 k of one column and stores them as 16 bytes of a Y^T row.
//   * prep_x_kernel: 16 k of an X row (natural or X panels) a thread:
//     nibbles unpacked, or int16 split into their two planes.
//   * imma_tile_kernel: one block owns a (128, BN) output tile, K in
//     stages of 128: a producer thread keeps TMA copies of each plane's X
//     box (128 rows x 128 k; I8GER4's X straight from its rows, or two
//     64-k boxes of its X panels) and Y^T box (BN rows x 128 k) in flight
//     on a ring of up to 8 stages, swizzled as wgmma reads them (ta_desc);
//     two consumer
//     warpgroups (64 rows each) run wgmma m64nBNk32 on s32 accumulators:
//     I8GER4 s8.u8, I4GER8 s8.s8, I16GER2 four byte products into three
//     accumulators (s8.s8; s8.u8 + u8.s8; u8.u8), combined by shifts at
//     the deprime.  The deprime stages the accumulators through the idle
//     ring as an int32 tile, then deprime() an element a thread.  The
//     products are the mma.sync kernel's exactly (the same byte planes, the
//     same wrapped int32 sums), so every output is its bit for bit.

constexpr int TA_BM = 128, TA_BK = 128, TA_THREADS = 384, TA_GROUP_M = 8;
constexpr int TA_BUDGET = 232448 - 2048;   // less alignment slack, barriers
constexpr int TA_MAX_STAGES = 8;
constexpr int TA_PLANE_X = TA_BM * TA_BK;  // 16 KB
constexpr int TA_KPAD = 64;                // the planes' K pitch unit

template <int FAM, int BN>
struct TaCfg {
  static constexpr int P = FAM == FAM_I16 ? 2 : 1;          // byte planes
  static constexpr int ACCS = FAM == FAM_I16 ? 3 : 1;
  static constexpr int PLANE_Y = BN * TA_BK;
  static constexpr int STAGE = P * (TA_PLANE_X + PLANE_Y);
  static constexpr int FIT = TA_BUDGET / STAGE;
  static constexpr int STAGES = FIT < TA_MAX_STAGES ? FIT : TA_MAX_STAGES;
  static constexpr int LDC = BN + 8;                        // int32 tile
  static_assert(STAGES >= 2, "two stages");
  static_assert(STAGES * STAGE >= TA_BM * LDC * 4, "the int32 tile");
  static constexpr size_t smem = (size_t)STAGES * STAGE + 1024 +
                                 2 * STAGES * 8;
};

// The K-major operand a wgmma reads for k32 step kk of a stage: rows of
// 128 k, 128-byte swizzled (chunk c of row r at chunk c ^ (r % 8)), as TMA
// writes a 128-byte box; or, for I8GER4's X panels, two 64-k panel boxes
// one after the other, 64-byte swizzled (chunk c of row r at c ^ (r / 2
// % 4)), since a panel row is 64 bytes.  `rows0` is the operand's first
// row (a consumer warpgroup's 64).
__device__ __forceinline__ uint64_t ta_desc(const unsigned char* base,
                                            int rows0, int kk, bool pan) {
  if (pan)
    return wgmma_desc(base + (kk / 2) * (TA_BM * 64) + rows0 * 64 +
                          (kk % 2) * 32,
                      16, 512, 64);
  return wgmma_desc(base + rows0 * 128 + kk * 32, 16, 1024, 128);
}

// ---- the pre-pass ----------------------------------------------------

constexpr int PREP_THREADS = 256;

// Y^T planes: (B, P, N, kp) bytes, kp the K pitch (a multiple of 64); a
// block a (64 k x 64 n) tile of batch element blockIdx.z.  I4GER8's tile is
// 32 packed rows (64 logical k).
template <int FAM>
__global__ void __launch_bounds__(PREP_THREADS)
    prep_y_kernel(const void* y, unsigned char* yt, int K, int N, int kp,
                  long long syb, int y_gk) {
  constexpr int ESZ = FAM == FAM_I16 ? 2 : 1;
  constexpr int ROWS = FAM == FAM_I4 ? 32 : 64;     // stored rows a tile
  constexpr int PITCH = 64 * ESZ + 16;              // smem row, bytes
  __shared__ __align__(16) unsigned char tile[ROWS * PITCH];
  const int n0 = blockIdx.x * 64, r0 = blockIdx.y * ROWS, bz = blockIdx.z;
  const int rows = FAM == FAM_I4 ? K / 2 : K;       // stored K
  const unsigned char* yb =
      reinterpret_cast<const unsigned char*>(y) + bz * syb * ESZ;
  // in: 16-byte chunks of the tile's rows (zero past K and N)
  constexpr int CHUNKS = ROWS * 64 * ESZ / 16;
  for (int i = threadIdx.x; i < CHUNKS; i += PREP_THREADS) {
    const int r = i / (4 * ESZ), c = i % (4 * ESZ);
    const int row = r0 + r, col = n0 + c * (16 / ESZ);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && col < N) {
      const long long off =
          y_gk ? y_panel_at(row, col, y_gk) : (long long)row * N + col;
      v = *reinterpret_cast<const uint4*>(yb + off * ESZ);
    }
    *reinterpret_cast<uint4*>(tile + r * PITCH + c * 16) = v;
  }
  __syncthreads();
  // out: 16 logical k of one column a thread, as 16 bytes of a Y^T row
  const int n = threadIdx.x / 4, c = threadIdx.x % 4;
  if (n0 + n >= N) return;
  const long long k0 = (long long)blockIdx.y * 64 + 16 * c;
  const long long plane = (long long)N * kp;
  unsigned char* dst = yt + ((long long)bz * (FAM == FAM_I16 ? 2 : 1) *
                             N + n0 + n) * kp + k0;
  uint32_t w[4] = {0u, 0u, 0u, 0u}, l[4] = {0u, 0u, 0u, 0u};
  if constexpr (FAM == FAM_I8) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      w[j / 4] |= (uint32_t)tile[(16 * c + j) * PITCH + n] << (8 * (j % 4));
  } else if constexpr (FAM == FAM_I4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {   // packed row -> logical k 2j, 2j + 1
      const uint32_t b = tile[(8 * c + j) * PITCH + n];
      const uint32_t lo = ((b & 0xfu) ^ 8u) - 8u, hi = ((b >> 4) ^ 8u) - 8u;
      w[j / 2] |= ((lo & 0xffu) | (hi & 0xffu) << 8) << (16 * (j % 2));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t v = *reinterpret_cast<const uint16_t*>(
          tile + (16 * c + j) * PITCH + 2 * n);
      w[j / 4] |= (v >> 8) << (8 * (j % 4));        // signed high byte
      l[j / 4] |= (v & 0xffu) << (8 * (j % 4));     // unsigned low byte
    }
    *reinterpret_cast<uint4*>(dst + plane) = make_uint4(l[0], l[1], l[2],
                                                        l[3]);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// X planes of I4GER8 (nibbles unpacked) and I16GER2 (high and low bytes):
// (B, P, M, kp) bytes, 16 logical k of a row a thread (zero past K).
template <int FAM>
__global__ void __launch_bounds__(PREP_THREADS)
    prep_x_kernel(const void* x, unsigned char* xp, int M, int K, int kp,
                  long long sxb, int x_gk, int batch) {
  const long long per_row = kp / 16, total = (long long)batch * M * per_row;
  for (long long q = blockIdx.x * (long long)PREP_THREADS + threadIdx.x;
       q < total; q += (long long)gridDim.x * PREP_THREADS) {
    const int bz = (int)(q / ((long long)M * per_row));
    const int m = (int)(q / per_row % M), k = (int)(q % per_row) * 16;
    uint32_t w[4] = {0u, 0u, 0u, 0u}, l[4] = {0u, 0u, 0u, 0u};
    if constexpr (FAM == FAM_I4) {
      if (k < K) {   // K / 2 is a multiple of 16: whole 8-byte runs
        const uint2 t = *reinterpret_cast<const uint2*>(
            reinterpret_cast<const unsigned char*>(x) + bz * sxb +
            (long long)m * (K / 2) + k / 2);
        const uint32_t lo0 = nib_lo(t.x), hi0 = nib_hi(t.x);
        const uint32_t lo1 = nib_lo(t.y), hi1 = nib_hi(t.y);
        w[0] = __byte_perm(lo0, hi0, 0x5140);
        w[1] = __byte_perm(lo0, hi0, 0x7362);
        w[2] = __byte_perm(lo1, hi1, 0x5140);
        w[3] = __byte_perm(lo1, hi1, 0x7362);
      }
    } else {
      const uint16_t* xb = reinterpret_cast<const uint16_t*>(x) + bz * sxb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // 8 int16 at k + 8 h (K % 8 == 0)
        if (k + 8 * h >= K) continue;
        const long long off = x_gk ? x_panel_at(m, k + 8 * h, x_gk)
                                   : (long long)m * K + k + 8 * h;
        const uint4 t = *reinterpret_cast<const uint4*>(xb + off);
        w[2 * h] = __byte_perm(t.x, t.y, 0x7531);
        w[2 * h + 1] = __byte_perm(t.z, t.w, 0x7531);
        l[2 * h] = __byte_perm(t.x, t.y, 0x6420);
        l[2 * h + 1] = __byte_perm(t.z, t.w, 0x6420);
      }
    }
    unsigned char* dst =
        xp + ((long long)bz * (FAM == FAM_I16 ? 2 : 1) * M + m) * kp + k;
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    if constexpr (FAM == FAM_I16)
      *reinterpret_cast<uint4*>(dst + (long long)M * kp) =
          make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// ---- the tile ----------------------------------------------------------

// Whether X and Y^T are batched (else shared: coordinate 0).
enum { TA_XB = 1, TA_YB = 2 };

// XPAN: X is I8GER4's X panels (two 64-k boxes a stage), else rows of a
// 3-D map whose third coordinate is batch * P + plane.
template <int FAM, int BN, bool XPAN>
__global__ void __launch_bounds__(TA_THREADS, 1)
    imma_tile_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmy, ImmaArgs a,
                     int form) {
  using C = TaCfg<FAM, BN>;
  constexpr int STAGES = C::STAGES, P = C::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;

  // the tile: rastered in groups of TA_GROUP_M tile rows (wgmma_tile.cuh)
  const int num_m = (a.M + TA_BM - 1) / TA_BM, num_n = (a.N + BN - 1) / BN;
  const int id = blockIdx.x, per_group = TA_GROUP_M * num_n;
  const int first_m = (id / per_group) * TA_GROUP_M;
  const int gsize = min(num_m - first_m, TA_GROUP_M);
  const int m0 = (first_m + (id % per_group) % gsize) * TA_BM;
  const int n0 = ((id % per_group) / gsize) * BN;
  const int bz = blockIdx.y;
  const int kiters = (a.K + TA_BK - 1) / TA_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full ----
    if (threadIdx.x == 0) {
      const int bx = (form & TA_XB) ? bz : 0, by = (form & TA_YB) ? bz : 0;
      for (int it = 0; it < kiters; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], C::STAGE);
        unsigned char* st = smem + s * C::STAGE;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if constexpr (XPAN)   // two panels; past gk: zeros
            tma_load_5d(st, &tmx, &full[s], 0, 0, 2 * it, m0 / TA_BM, bx);
          else
            tma_load_3d(st + p * TA_PLANE_X, &tmx, &full[s], it * TA_BK, m0,
                        bx * P + p);
          tma_load_3d(st + P * TA_PLANE_X + p * C::PLANE_Y, &tmy, &full[s],
                      it * TA_BK, n0, by * P + p);
        }
      }
    }
    return;
  }
  // ---- consumers: 64 rows each ----
  const int c = threadIdx.x / 128 - 1;
  int acc[C::ACCS][BN / 2];
#pragma unroll
  for (int p = 0; p < C::ACCS; ++p)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[p][i] = 0;
  for (int it = 0; it < kiters; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* xs = smem + s * C::STAGE;
    const unsigned char* ys = xs + P * TA_PLANE_X;
#pragma unroll
    for (int p = 0; p < C::ACCS; ++p) reg_fence(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TA_BK / 32; ++kk) {
      const uint64_t dx0 = ta_desc(xs, c * 64, kk, XPAN);
      const uint64_t dy0 = ta_desc(ys, 0, kk, false);
      if constexpr (FAM == FAM_I8) {
        Wgmma8<BN>::template ss<true, false>(acc[0], dx0, dy0);
      } else if constexpr (FAM == FAM_I4) {
        Wgmma8<BN>::template ss<true, true>(acc[0], dx0, dy0);
      } else {   // planes: 0 = signed high bytes, 1 = unsigned low bytes
        const uint64_t dx1 = ta_desc(xs + TA_PLANE_X, c * 64, kk, false);
        const uint64_t dy1 = ta_desc(ys + C::PLANE_Y, 0, kk, false);
        Wgmma8<BN>::template ss<true, true>(acc[0], dx0, dy0);
        Wgmma8<BN>::template ss<true, false>(acc[1], dx0, dy1);
        Wgmma8<BN>::template ss<false, true>(acc[1], dx1, dy0);
        Wgmma8<BN>::template ss<false, false>(acc[2], dx1, dy1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int p = 0; p < C::ACCS; ++p) reg_fence(acc[p]);
    if (it > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < C::ACCS; ++p) reg_fence(acc[p]);

  // the deprime: through the idle ring as an int32 tile
  named_bar_sync(1, 256);
  int* ct = reinterpret_cast<int*>(smem) + c * 64 * C::LDC;
  const int wl = threadIdx.x % 128, lane = wl % 32;
  const int r = (wl / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = (uint32_t)acc[0][4 * j + e];
      if constexpr (FAM == FAM_I16)
        v[e] = (v[e] << 16) + ((uint32_t)acc[1][4 * j + e] << 8) +
               (uint32_t)acc[2][4 * j + e];
    }
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<int2*>(ct + r * C::LDC + col) =
        make_int2((int)v[0], (int)v[1]);
    *reinterpret_cast<int2*>(ct + (r + 8) * C::LDC + col) =
        make_int2((int)v[2], (int)v[3]);
  }
  named_bar_sync(2 + c, 128);
#pragma unroll 1
  for (int e = wl; e < 64 * BN; e += 128) {
    const int row = e / BN, col = e % BN;
    const int gr = m0 + c * 64 + row, gc = n0 + col;
    if (gr < a.M && gc < a.N)
      deprime(a, bz, gr, gc, (uint32_t)ct[row * C::LDC + col]);
  }
}

// One operand's tensor map: rows (rows x cols elements of `eb` bytes at a
// row pitch of `pitch` bytes, box (bc, br)) or core/packing.py's panels
// ((g, gk, prow, 64), two k panels a box), with an outer dimension of `B`
// (the batch, or the batch times the planes; 1: none) at byte stride
// `bstride`.
static int ta_map(CUtensorMap* t, const void* p, int eb, bool panels,
                  uint64_t rows, uint64_t cols, uint64_t pitch, uint32_t bc,
                  uint32_t br, uint64_t prow, uint64_t g, uint64_t gk,
                  uint64_t B, uint64_t bstride, int sw) {
  if (panels) {   // a box of two consecutive k panels
    const uint64_t dims[5] = {64, prow, gk, g, B};
    const uint64_t str[4] = {64 * (uint64_t)eb, prow * 64 * eb,
                             gk * prow * 64 * eb, bstride};
    const uint32_t box[5] = {64, (uint32_t)prow, 2, 1, 1};
    return tmap_tiled(t, p, eb, 5, dims, str, box, sw);
  }
  const uint64_t dims[3] = {cols, rows, B};
  const uint64_t str[2] = {pitch, bstride};
  const uint32_t box[3] = {bc, br, 1};
  return tmap_tiled(t, p, eb, 3, dims, str, box, sw);
}

// The batch stride in bytes of an operand whose own stride is `sb` bytes
// (0: shared or not batched: the matrix's own size, a multiple of 16,
// which no coordinate steps over).
static uint64_t ta_bstride(long long sb, uint64_t own) {
  return sb ? (uint64_t)sb : own;
}

// The planes' K pitch: the logical K rounded up to TA_KPAD bytes.
static int ta_kp(int K) { return (K + TA_KPAD - 1) / TA_KPAD * TA_KPAD; }

// The pre-pass, then the tile.  xp / yt: the wrapper's workspace for X's
// planes (I4GER8, I16GER2; (Bx, P, M, kp) bytes) and Y^T's ((By, P, N,
// kp)); Bx, By the batch where the operand is batched, else 1.
template <int FAM, int BN, bool XPAN>
static int launch_tile(const ImmaArgs& a, int panels, int batch,
                       unsigned char* xp, unsigned char* yt,
                       cudaStream_t stream) {
  using C = TaCfg<FAM, BN>;
  constexpr int P = C::P;
  const bool xpan = panels & PANELS_X;
  const uint64_t M = a.M, N = a.N, K = a.K;
  const int kp = ta_kp(a.K);
  const int BX = a.sxb ? batch : 1, BY = a.syb ? batch : 1;
  if (!yt || (FAM != FAM_I8 && !xp)) return (int)cudaErrorInvalidValue;
  const int rows = FAM == FAM_I4 ? a.K / 2 : a.K;
  prep_y_kernel<FAM><<<dim3((a.N + 63) / 64, (rows + (FAM == FAM_I4 ? 31 : 63))
                                                  / (FAM == FAM_I4 ? 32 : 64),
                            BY),
                       PREP_THREADS, 0, stream>>>(a.y, yt, a.K, a.N, kp, a.syb,
                                                  a.y_gk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (FAM != FAM_I8) {
    const long long chunks = (long long)BX * a.M * (kp / 16);
    const long long need = (chunks + PREP_THREADS - 1) / PREP_THREADS;
    const int blocks = (int)(need < 132 * 16 ? need : 132 * 16);
    prep_x_kernel<FAM><<<blocks, PREP_THREADS, 0, stream>>>(
        a.x, xp, a.M, a.K, kp, a.sxb, a.x_gk, BX);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  CUtensorMap tx, ty;
  int rc;
  if (FAM == FAM_I8) {   // X as it lies: its rows, or its 64-wide panels
    const uint64_t gk = (K + PANEL_C - 1) / PANEL_C;
    const uint64_t gm = (M + PANEL_XR - 1) / PANEL_XR;
    const uint64_t own = xpan ? gm * gk * PANEL_XR * 64 : M * K;
    rc = ta_map(&tx, a.x, 1, xpan, M, K, K, TA_BK, 128, PANEL_XR, gm, gk,
                BX, ta_bstride(a.sxb, own), xpan ? 64 : TA_BK);
  } else {
    rc = ta_map(&tx, xp, 1, false, M, K, kp, TA_BK, 128, 0, 0, 0, BX * P,
                M * kp, TA_BK);
  }
  if (rc) return rc;
  rc = ta_map(&ty, yt, 1, false, N, K, kp, TA_BK, BN, 0, 0, 0, BY * P,
              N * kp, TA_BK);
  if (rc) return rc;
  const int form = (a.sxb ? TA_XB : 0) | (a.syb ? TA_YB : 0);
  static bool ok = false;
  auto kernel = imma_tile_kernel<FAM, BN, XPAN>;
  e = allow_smem(kernel, C::smem, &ok);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (int)(((M + TA_BM - 1) / TA_BM) * ((N + BN - 1) / BN));
  kernel<<<dim3(tiles, batch), TA_THREADS, C::smem, stream>>>(tx, ty, a,
                                                             form);
  return (int)cudaGetLastError();
}

// ======================================================================
// Form B: I8GER4's weight stream (N <= 64 columns, X the weight)
// ======================================================================
//
// quant.qdot's decode: the kernel's X is the (M, K) int8 weight (W^T, or
// its X-side panels), Y the (K, N <= 64) uint8 activations.  The weight's
// bytes bound it.  A block owns 128 weight rows and one K slice: a
// producer thread keeps TMA copies of (128 x 128 k) X boxes in flight on a
// ring of TB_STAGES stages (128-byte rows, 128-byte swizzled; X panels
// two 64-k panel boxes, 64-byte swizzled: ta_desc), while every thread
// first stages the slice's Y columns K-major (BN rows of its k, 128-byte
// swizzled, zero past K and N) once, 64 rows of Y at a time through
// shared memory (any pitch); two consumer warpgroups run wgmma m64nBNk32
// (s8 x u8) over the ring.  K is split so that the grid fills the card:
// integer partial sums add exactly in any order, so a slice writes its
// int32 partial tile and the last slice of a row tile to arrive (an
// atomic ticket, reset by it for the stream's next launch) sums them and
// runs the deprime once, on the whole sum.

constexpr int TB_BM = 128, TB_BK = 128, TB_THREADS = 288, TB_STAGES = 3;
constexpr int TB_STAGE = TB_BM * TB_BK;    // 16 KB
constexpr int TB_YT_MAX = 65536;           // a slice's K-major Y columns
constexpr int TB_RAW = 8192;               // rows of Y a pass, packed

template <int BN>
static size_t tb_smem(int slice_stages) {
  return 1024 + (size_t)TB_STAGES * TB_STAGE +
         (size_t)BN * TB_BK * slice_stages + TB_RAW + 2 * TB_STAGES * 8;
}

template <int BN, bool XPAN>
__global__ void __launch_bounds__(TB_THREADS, 3)
    imma_stream_kernel(const __grid_constant__ CUtensorMap tmx, ImmaArgs a,
                       int split, int slice_stages, int* ws, int* tickets) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last_unit;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* yt = smem + TB_STAGES * TB_STAGE;
  unsigned char* raw = yt + BN * TB_BK * slice_stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + TB_RAW);
  uint64_t* empty = full + TB_STAGES;

  const int mtiles = (a.M + TB_BM - 1) / TB_BM;
  const int mt = blockIdx.x % mtiles, sp = blockIdx.x / mtiles;
  const int bz = blockIdx.y, m0 = mt * TB_BM;
  const int S = (a.K + TB_BK - 1) / TB_BK;
  const int s0 = (int)((long long)sp * S / split);
  const int nst = (int)((long long)(sp + 1) * S / split) - s0;
  const bool producer = threadIdx.x == 256;
  const int bx = a.sxb ? bz : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TB_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int it) {
    const int s = it % TB_STAGES;
    mbar_expect_tx(&full[s], TB_STAGE);
    if constexpr (XPAN)   // two panels; past gk: zeros
      tma_load_5d(smem + s * TB_STAGE, &tmx, &full[s], 0, 0, 2 * (s0 + it),
                  mt, bx);
    else
      tma_load_3d(smem + s * TB_STAGE, &tmx, &full[s], (s0 + it) * TB_BK, m0,
                  bx);
  };
  if (producer)
    for (int it = 0; it < TB_STAGES && it < nst; ++it) issue(it);

  // the slice's Y columns, K-major: as many of its rows as TB_RAW holds
  // (all of them at qdot's decode), N bytes each, into `raw` (contiguous
  // in Y: in words where they are aligned; Y panels: each row's N bytes),
  // then each thread gathers 16 k of one column into a 16-byte chunk of
  // its Y^T row, 128-byte swizzled
  const uint8_t* yb =
      reinterpret_cast<const uint8_t*>(a.y) + (long long)bz * a.syb;
  const int k0 = s0 * TB_BK, kend = min(a.K, (s0 + nst) * TB_BK);
  const int pass = (TB_RAW / a.N) / 16 * 16;   // rows a pass
  for (int kb = k0; kb < kend; kb += pass) {
    const int rows = min(pass, kend - kb);
    const int bytes = rows * a.N;
    const uint8_t* src = yb + (long long)kb * a.N;
    if (a.y_gk) {
      for (int i = threadIdx.x; i < bytes; i += TB_THREADS) {
        const int k = kb + i / a.N, n = i % a.N;
        raw[i] = yb[y_panel_at(k, n, a.y_gk)];
      }
    } else if ((reinterpret_cast<uintptr_t>(src) & 3) == 0 &&
               (bytes & 3) == 0) {
      for (int i = threadIdx.x; i < bytes / 4; i += TB_THREADS)
        reinterpret_cast<uint32_t*>(raw)[i] =
            reinterpret_cast<const uint32_t*>(src)[i];
    } else {
      for (int i = threadIdx.x; i < bytes; i += TB_THREADS) raw[i] = src[i];
    }
    __syncthreads();
    const int chunks = (rows + 15) / 16;
    for (int ci = threadIdx.x; ci < BN * chunks; ci += TB_THREADS) {
      const int n = ci % BN, c = ci / BN;   // c: 16-k chunk of the pass
      const int k = kb - k0 + 16 * c;       // its first k in the slice
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (n < a.N) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (16 * c + j < rows)            // past K: zero
            w[j / 4] |= (uint32_t)raw[(16 * c + j) * a.N + n]
                        << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(yt + (k / TB_BK) * BN * TB_BK + n * TB_BK +
                                ((((k % TB_BK) / 16) ^ (n & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
  }
  // (a last stage's Y^T chunks past K stay unwritten: X's box is zero
  // there, and an integer product of zero is zero)
  fence_proxy_async();
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (producer)
      for (int it = TB_STAGES; it < nst; ++it) {
        mbar_wait(&empty[it % TB_STAGES], ((it / TB_STAGES) - 1) & 1);
        issue(it);
      }
    return;
  }
  const int c = threadIdx.x / 128;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int it = 0; it < nst; ++it) {
    const int s = it % TB_STAGES;
    mbar_wait(&full[s], (it / TB_STAGES) & 1);
    const unsigned char* xs = smem + s * TB_STAGE;
    const unsigned char* ys = yt + it * BN * TB_BK;
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TB_BK / 32; ++kk)
      Wgmma8<BN>::template ss<true, false>(acc, ta_desc(xs, c * 64, kk, XPAN),
                                           ta_desc(ys, 0, kk, false));
    wgmma_commit();
    wgmma_wait<0>();   // a few columns' products: release the stage now
    reg_fence(acc);
    mbar_arrive(&empty[s]);
  }

  // the partial tile through the idle ring as int32
  constexpr int LDC = BN + 8;
  named_bar_sync(2, 256);
  int* ct = reinterpret_cast<int*>(smem);
  const int lane = threadIdx.x % 32;
  const int r = c * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<int2*>(ct + r * LDC + col) =
        make_int2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<int2*>(ct + (r + 8) * LDC + col) =
        make_int2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_bar_sync(2, 256);
  const int rows = min(TB_BM, a.M - m0);
  if (split == 1) {
    for (int e = threadIdx.x; e < rows * a.N; e += 256) {
      const int row = e / a.N, col = e % a.N;
      deprime(a, bz, m0 + row, col, (uint32_t)ct[row * LDC + col]);
    }
    return;
  }
  const long long mn = (long long)a.M * a.N;
  int* part = ws + ((long long)bz * split + sp) * mn + (long long)m0 * a.N;
  for (int e = threadIdx.x; e < rows * a.N; e += 256)
    part[e] = ct[(e / a.N) * LDC + e % a.N];
  __threadfence();
  named_bar_sync(2, 256);
  if (threadIdx.x == 0) {
    int* ticket = tickets + (long long)bz * mtiles + mt;
    last_unit = atomicAdd(ticket, 1) == split - 1;
    if (last_unit) *ticket = 0;   // zero again for the stream's next launch
  }
  named_bar_sync(2, 256);
  if (!last_unit) return;
  __threadfence();
  const int* base = ws + (long long)bz * split * mn + (long long)m0 * a.N;
  for (int e = threadIdx.x; e < rows * a.N; e += 256) {
    uint32_t v = 0u;
    for (int p = 0; p < split; ++p)
      v += (uint32_t)__ldcg(base + p * mn + e);
    deprime(a, bz, m0 + e / a.N, e % a.N, v);
  }
}

template <int BN>
static int launch_stream(const ImmaArgs& a, int panels, int batch, int split,
                         int* ws, int* tickets, cudaStream_t stream) {
  const bool xp = panels & PANELS_X;
  const uint64_t M = a.M, K = a.K, B = batch;
  const uint64_t gk = (K + PANEL_C - 1) / PANEL_C;
  const uint64_t gm = (M + PANEL_XR - 1) / PANEL_XR;
  const int S = (a.K + TB_BK - 1) / TB_BK;
  const int slice_stages = (S + split - 1) / split;
  if (split < 1 || split > S || (split > 1 && (!ws || !tickets)) ||
      (size_t)BN * TB_BK * slice_stages > TB_YT_MAX)
    return (int)cudaErrorInvalidValue;
  const uint64_t xown = xp ? gm * gk * PANEL_XR * 64 : M * K;
  CUtensorMap tx;
  int rc = ta_map(&tx, a.x, 1, xp, M, K, K, TB_BK, 128, PANEL_XR, gm, gk,
                  a.sxb ? B : 1, ta_bstride(a.sxb, xown), xp ? 64 : TB_BK);
  if (rc) return rc;
  static bool ok[2] = {};
  auto kernel = xp ? imma_stream_kernel<BN, true>
                   : imma_stream_kernel<BN, false>;
  cudaError_t e = allow_smem(kernel, tb_smem<BN>(TB_YT_MAX / (BN * TB_BK)),
                             &ok[xp]);
  if (e != cudaSuccess) return (int)e;
  const int mtiles = (a.M + TB_BM - 1) / TB_BM;
  kernel<<<dim3(mtiles * split, batch), TB_THREADS, tb_smem<BN>(slice_stages),
           stream>>>(tx, a, split, slice_stages, ws, tickets);
  return (int)cudaGetLastError();
}

// The tile's instance of (family, BN, X panels).
static int launch_tile_family(const ImmaArgs& a, int family, int bn,
                              int panels, int batch, unsigned char* xp,
                              unsigned char* yt, cudaStream_t s) {
  const bool xpan = panels & PANELS_X;
  if (family == FAM_I8) {
    if (bn == 256)
      return xpan ? launch_tile<FAM_I8, 256, true>(a, panels, batch, xp, yt, s)
                  : launch_tile<FAM_I8, 256, false>(a, panels, batch, xp, yt,
                                                    s);
    if (bn == 128)
      return xpan ? launch_tile<FAM_I8, 128, true>(a, panels, batch, xp, yt, s)
                  : launch_tile<FAM_I8, 128, false>(a, panels, batch, xp, yt,
                                                    s);
  } else if (family == FAM_I4) {
    if (bn == 256)
      return launch_tile<FAM_I4, 256, false>(a, panels, batch, xp, yt, s);
    if (bn == 128)
      return launch_tile<FAM_I4, 128, false>(a, panels, batch, xp, yt, s);
  } else if (family == FAM_I16) {
    if (bn == 64)
      return launch_tile<FAM_I16, 64, false>(a, panels, batch, xp, yt, s);
  }
  return (int)cudaErrorInvalidValue;
}

static int launch_stream_bn(const ImmaArgs& a, int bn, int panels, int batch,
                            int split, int* ws, int* tickets,
                            cudaStream_t s) {
  if (bn == 8)
    return launch_stream<8>(a, panels, batch, split, ws, tickets, s);
  if (bn == 16)
    return launch_stream<16>(a, panels, batch, split, ws, tickets, s);
  if (bn == 32)
    return launch_stream<32>(a, panels, batch, split, ws, tickets, s);
  if (bn == 64)
    return launch_stream<64>(a, panels, batch, split, ws, tickets, s);
  return (int)cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// family: 0 I8GER4, 1 I4GER8, 2 I16GER2 (core/tiling.py: IMMA_GERS).  K is
// the logical depth (2 x the packed K for I4GER8); c, bias and res are
// int32; batch strides count stored elements (bytes for int8 and packed
// int4, int16 elements for I16GER2; 0: an operand shared across the
// batch).  xm, ym, pm: the pm* byte masks over M, N and logical K, each
// null or one byte a lane; I4GER8 takes ym only.  panels: which of x and
// y are core/packing.py's panels (PANELS_X, PANELS_Y), 16-byte aligned;
// not in I4GER8.  form (core/tiling.py's imma_plan): 0 the mma.sync
// kernel (every product: the masked ones, pitches TMA cannot read, an
// explicit block), 1 the wgmma tile (BN = bn; no masks, 16-byte bases,
// pitches and batch strides; work the pre-pass's X planes, (Bx, P, M, kp)
// bytes, null for I8GER4, and work2 its Y^T planes, (By, P, N, kp); kp the
// logical K rounded up to 64, Bx and By the batch where the operand is
// batched, else 1), 2 I8GER4's weight stream (N <= bn <= 64 columns, K cut
// into `split` slices, work the (B, split, M, N) int32 partials and work2
// the stream's zeroed (B, M / 128) tickets where split > 1; no masks, X
// read by TMA, Y any pitch).  A form the operands
// do not admit returns cudaErrorInvalidValue: the wrapper routes by form
// up front and never retries.
extern "C" int gemm_imma_launch(const void* x, const void* y, const void* xm,
                                const void* ym, const void* pm, const void* c,
                                const void* bias, const void* res, void* out,
                                int family, int out_dt, int batch, int M,
                                int N, int K, long long sxb, long long syb,
                                long long scb, long long srb, long long sob,
                                int alpha, int beta, int neg_product,
                                int neg_acc, int relu, void* stream,
                                int panels, int form, int bn, int split,
                                void* work, void* work2) {
  ImmaArgs a;
  a.x = x; a.y = y; a.out = out;
  a.c = reinterpret_cast<const int*>(c);
  a.bias = reinterpret_cast<const int*>(bias);
  a.res = reinterpret_cast<const int*>(res);
  a.out_dt = out_dt;
  a.M = M; a.N = N; a.K = K;
  a.sxb = sxb; a.syb = syb; a.scb = scb; a.srb = srb; a.sob = sob;
  a.alpha = alpha; a.beta = beta;
  a.neg_product = neg_product; a.neg_acc = neg_acc; a.relu = relu;
  const int gk = (K + PANEL_C - 1) / PANEL_C;
  a.x_gk = (panels & PANELS_X) ? gk : 0;
  a.y_gk = (panels & PANELS_Y) ? gk : 0;
  const int esz = family == FAM_I16 ? 2 : 1;
  a.xm = reinterpret_cast<const uint8_t*>(xm);
  a.ym = reinterpret_cast<const uint8_t*>(ym);
  a.pm = reinterpret_cast<const uint8_t*>(pm);
  a.vec_x = a.vec_y = 0;
  if (panels && family == FAM_I4) return (int)cudaErrorInvalidValue;
  if ((a.x_gk && (!aligned(x, 16) || (sxb * esz) % 16)) ||
      (a.y_gk && (!aligned(y, 16) || (syb * esz) % 16)))
    return (int)cudaErrorInvalidValue;
  if (family == FAM_I4 && (xm || pm)) return (int)cudaErrorInvalidValue;
  for (const void* m : {xm, ym, pm})   // whole-word mask loads
    if (m && !aligned(m, 16)) return (int)cudaErrorInvalidValue;
  if (family == FAM_I4 && K % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (form == 1 || form == 2) {
    // TMA's rule: 16-byte bases, pitches and batch strides
    const long long xpitch = family == FAM_I4 ? K / 2 : (long long)K * esz;
    const long long ypitch = (long long)N * esz;
    const bool x_tma = aligned(x, 16) && (a.x_gk || (xpitch % 16 == 0 &&
                                                     (sxb * esz) % 16 == 0));
    const bool y_tma = aligned(y, 16) && (a.y_gk || (ypitch % 16 == 0 &&
                                                     (syb * esz) % 16 == 0));
    if (xm || ym || pm || !x_tma) return (int)cudaErrorInvalidValue;
    if (form == 1)
      return y_tma ? launch_tile_family(
                         a, family, bn, panels, batch,
                         reinterpret_cast<unsigned char*>(work),
                         reinterpret_cast<unsigned char*>(work2), s)
                   : (int)cudaErrorInvalidValue;
    if (family != FAM_I8 || N > bn) return (int)cudaErrorInvalidValue;
    return launch_stream_bn(a, bn, panels, batch, split,
                            reinterpret_cast<int*>(work),
                            reinterpret_cast<int*>(work2), s);
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  if (family == FAM_I8) {
    a.vec_x = K % 16 == 0 && sxb % 16 == 0 && aligned(x, 16);
    a.vec_y = N % 4 == 0 && syb % 4 == 0 && aligned(y, 4);
    return launch<FAM_I8>(a, panels, batch, s);
  }
  if (family == FAM_I4) {
    a.vec_x = (K / 2) % 8 == 0 && sxb % 8 == 0 && aligned(x, 8);
    a.vec_y = N % 4 == 0 && syb % 4 == 0 && aligned(y, 4);
    return launch_masked<FAM_I4, 0>(a, batch, s);
  }
  if (family == FAM_I16) {
    a.vec_x = K % 8 == 0 && sxb % 8 == 0 && aligned(x, 16);
    a.vec_y = N % 4 == 0 && syb % 4 == 0 && aligned(y, 8);
    return launch<FAM_I16>(a, panels, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}
