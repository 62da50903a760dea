// Accumulator-resident integer GEMM for Hopper (sm_90a): the IMMA kernel.
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
// 2-D and batched operands (batch on blockIdx.z), the accumulate forms and
// the epilogues an integer accumulator admits:
//
//   out = cast(residual + relu?(bias + alpha * ([-](X @ Y) + s * beta * C)))
//
// all in int32 arithmetic that wraps modulo 2^32, as the reference's int32
// dot_general and its int32 alpha/beta (truncated to integers by the
// wrapper) do.  Prepacked X and Y panels (K1d) are read in I8GER4 and
// I16GER2, masked or not.  The pm*
// prefixed masked forms (K1b) run in the MASKED instances: I8GER4 and
// I16GER2 take row, column and rank predicates, I4GER8 a column one (its
// row and rank predicates go through ref.pm_ger, as the reference's
// kernel refuses them).  The ABFT sidecar (K1e) is not here.
//
// What bounds it on an H100: the int8 tensor cores (1979 TOP/s dense) for
// large products; the operands' bytes (3.35 TB/s) for skinny ones.
//
// Design.  mma.sync.aligned.m16n8k32 with s8/u8 operands and an s32
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

#include "common.cuh"

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
  const long long cbase = (long long)bz * a.scb, rbase = (long long)bz * a.srb;
  const long long obase = (long long)bz * a.sob;
  for (int e = threadIdx.x; e < F::bm * BN; e += THREADS) {
    const int row = e / BN, col = e % BN;
    const int gr = m0 + row, gc = n0 + col;
    if (gr >= a.M || gc >= a.N) continue;
    const long long idx = (long long)gr * a.N + gc;
    uint32_t v = (uint32_t)cs[row * CP + col];
    if (a.neg_product) v = 0u - v;
    if (a.c) {
      const uint32_t s = (uint32_t)a.c[cbase + idx] * (uint32_t)a.beta;
      v += a.neg_acc ? 0u - s : s;
    }
    v *= (uint32_t)a.alpha;
    if (a.bias) v += (uint32_t)a.bias[gc];
    int sv = (int)v;
    if (a.relu) sv = sv > 0 ? sv : 0;
    if (a.res) sv = (int)((uint32_t)sv + (uint32_t)a.res[rbase + idx]);
    store_i(a.out, a.out_dt, obase + idx, sv);
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
// not in I4GER8.
extern "C" int gemm_imma_launch(const void* x, const void* y, const void* xm,
                                const void* ym, const void* pm, const void* c,
                                const void* bias, const void* res, void* out,
                                int family, int out_dt, int batch, int M,
                                int N, int K, long long sxb, long long syb,
                                long long scb, long long srb, long long sob,
                                int alpha, int beta, int neg_product,
                                int neg_acc, int relu, void* stream,
                                int panels) {
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
  if (panels && family == FAM_I4) return (int)cudaErrorInvalidValue;
  if ((a.x_gk && (!aligned(x, 16) || (sxb * esz) % 16)) ||
      (a.y_gk && (!aligned(y, 16) || (syb * esz) % 16)))
    return (int)cudaErrorInvalidValue;
  if (family == FAM_I4 && (xm || pm)) return (int)cudaErrorInvalidValue;
  for (const void* m : {xm, ym, pm})   // whole-word mask loads
    if (m && !aligned(m, 16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (family == FAM_I8) {
    a.vec_x = K % 16 == 0 && sxb % 16 == 0 && aligned(x, 16);
    a.vec_y = N % 4 == 0 && syb % 4 == 0 && aligned(y, 4);
    return launch<FAM_I8>(a, panels, batch, s);
  }
  if (family == FAM_I4) {
    if (K % 2) return (int)cudaErrorInvalidValue;
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
