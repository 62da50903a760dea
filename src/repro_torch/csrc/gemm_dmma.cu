// Accumulator-resident fp64 GEMM for Hopper (sm_90a): the DMMA kernel.
//
// Replaces the F64GER family of the TPU kernel K1: repro/kernels/mma_gemm.py,
// mma_gemm (kernel body _make_kernel with an f64 accumulator; on the TPU it
// ran on the vector unit, which has no fp64 matrix path), for 2-D and
// batched operands (batch on blockIdx.z), the accumulate forms and the
// fused epilogue, all in fp64:
//
//   out = cast(residual + act(bias + alpha * ([-](X @ Y) + s * beta * C)))
//
// with s = -1 for the neg_acc form, and the pm* prefixed masked forms (K1b:
// row, column and rank predicates).  This is the paper's DGEMM case study
// (xvf64ger).
//
// What bounds it on an H100: the fp64 tensor cores (67 TFLOP/s dense) for
// large products (a DGEMM of 8192^3 needs 16.4 ms at that rate, 2048^3
// 0.256 ms); the operands' bytes (3.35 TB/s) for skinny ones (a 4-row
// product reads its whole Y once).  Between the two sits the operand
// traffic from L2: a (BM, BN) tile reads BM + BN doubles a K row for
// 2 BM BN flops, so a 64 x 64 tile needs ~8 TB/s of L2 reads to feed the
// tensor cores at their peak and a 128 x 128 tile half that.
//
// Design.  One block owns one (BM, BN) output tile and runs its whole K
// loop.  Two tiles are compiled (core/tiling.py's GEMM_TILES, picked by
// choose_blocks' wave rule): 128 x 128 with 16 warps of 32 x 32 and 32-deep K
// steps, which halves the L2 reads of a flop against 64 x 64; and 64 x 64 with
// 4 warps and 16-deep steps, 3 blocks an SM, which spreads skinny products over
// more SMs.  Each warp holds its slice of the accumulator in registers as m16n8
// fragments (32 doubles a thread; the launch bounds' cap is 128 registers in
// the large tile, and no instance spills) and runs mma.sync.aligned.m16n8k8
// with f64 operands and accumulator, or m16n8k4 where X arrives as panels
// (dmma_depth). sm_90's fp64 shapes are m8n8k4 and m16n8k4, k8, k16 (wgmma has
// no fp64 form); PERF.md says how each fared in this kernel on the card.  The
// operands come through a ring of DMMA_STAGES cp.async stages: X's (BM, BK)
// panel and Y's (BK, BN) panel, row-major, rows padded by 4 doubles so that
// every fragment read (lane (g, t) at row g, column t) hits distinct banks.
// The ring runs on mbarriers, not on block-wide barriers: full[i] completes when
// every thread's copies into slot i have landed (cp.async.mbarrier.arrive),
// empty[i] when every warp is done reading it.  A warp waits for its step to be
// full, runs the step's fragments and MMAs, releases the slot, and refills the
// slot of the step before, once every warp has released that, with the copies
// of the step DMMA_STAGES - 1 ahead.  So the warps do not wait for one another
// at every step: one __syncthreads a step, as in tile_gemm.cuh's 16-bit ring,
// leaves the tensor cores idle while the slowest warp catches up
// (PERF.md).  Copies are 16 bytes where a row and its base allow it (vec_x /
// vec_y: even pitch, 16-byte base; panels always), else 8 bytes an element; a
// copy's bytes past M, K or N are zero-filled by the copy.
// Each output element is one chain of fp64 tensor-core products over its K
// slices in ascending order from +0.0, the K loop padded with zeros to a whole
// number of steps; the fp64 tensor cores sum k in order within an instruction,
// so m16n8k8, m16n8k4 and two m8n8k4 give the same bits (PERF.md: the
// outputs' hashes).  So both tiles, a batched call's slice and the 2-D call
// give the same bits, and an autotune choice of tile never changes a result.
// The deprime goes through a shared fp64 tile aliasing the ring, so that
// each output element is stored once, coalesced, in the requested dtype.
// The ABFT checksum sidecar (K1e, checksum=True in
// repro/kernels/mma_gemm.py): with ck_col / ck_row set, each finished fp64
// value goes back over the deprime tile after its store, and the block
// sums the tile's columns (one a thread) and rows (one a warp) in fp64, in
// a fixed order (common.cuh's tile_checksums); the stores are untouched.
// Masked (K1b), the MASKED instances: a disabled row of X, rank of X and
// Y and column of Y is never copied: its lanes are zero-filled by the copy
// itself, as past M, K and N (8-byte copies where a pair's two lanes
// differ), so a NaN or Inf there never reaches shared memory, and the
// MMA loop is the natural one.  The predicate bytes a copy needs are read
// as it is issued (L1-resident: K + N + M bytes).
// Prepacked operands (K1d: repro/kernels/mma_gemm.py's packed_spec):
// with `panels` set, X arrives as core/packing.py's X-side
// (gm, gk, 128, 64) fp64 panels and/or Y as its Y-side (gn, gk, 64, 64)
// panels (common.cuh's x_panel_at / y_panel_at), zero-padded past M, K and
// N.  A block's rows lie in one X panel band (128 rows: the whole band;
// 64: half of it), its columns in one or two Y panels, and a K step in
// half or a quarter of a panel's depth; every 16-byte copy (two k of an X row,
// two n of a Y row, at an even column) lies in one zero-padded panel row.
// A copy past M, K or N is zero-filled, as the natural copy's is, a copy
// across K or N reads the zero padding, and the masks apply as they do to
// natural rows, so the staged panels, and the result and the sidecar, are
// the natural launch's bit for bit.  A packed operand without a batch axis
// beside a batched one is shared: its batch stride is 0.  Which operands
// are panels is the kernel's PANELS template argument (common.cuh's
// PANELS_X | PANELS_Y), so the natural instances are unchanged.

#include "hopper.cuh"

namespace {

constexpr int DMMA_STAGES = 3;    // core/tiling.py's DMMA_STAGES
constexpr int PAD = 4;            // row padding in doubles

// The instruction depth of an instance: m16n8k8 (IK 8), the faster,
// unless X arrives as panels, whose copies hold more state: there
// m16n8k4 (IK 4, half the fragment registers), so that every instance
// fits the 128 x 128 tile's 128-register cap with no spill.  The fp64
// tensor cores sum k in order either way: the bits are the same.
__host__ __device__ constexpr int dmma_depth(int panels) {
  return (panels & PANELS_X) != 0 ? 4 : 8;
}

// One compiled tile: BM x BN outputs, K steps of BK rows, WM x WN warps,
// MINB blocks an SM (the launch bounds' register cap).  A ring stage holds
// X's (BM, BK) panel (pitch AP) and Y's (BK, BN) panel (pitch BP); the
// fp64 deprime tile (pitch CP) aliases the ring (core/tiling.py's
// BlockConfig.smem_bytes mirrors SMEM).
template <int BM_, int BN_, int BK_, int WM_, int WN_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WM = WM_, WN = WN_, MINB = MINB_;
  static constexpr int NT = WM * WN * 32;
  static constexpr int TM = BM / WM, TN = BN / WN;   // a warp's slice
  static constexpr int MF = TM / 16, NF = TN / 8;    // its m16 / n8 tiles
  static constexpr int AP = BK + PAD, BP = BN + PAD, CP = BN + PAD;
  static constexpr int STAGE_BYTES = (BM * AP + BK * BP) * 8;
  static constexpr size_t RING = (size_t)DMMA_STAGES * STAGE_BYTES;
  static constexpr size_t CTILE = (size_t)BM * CP * 8;
  static constexpr size_t SMEM = RING > CTILE ? RING : CTILE;
  // this thread's copies: X in 16-byte chunks of a row (BK / 2 a row),
  // Y likewise (BN / 2 a row)
  static constexpr int XCH = BK / 2, YCH = BN / 2;
  static constexpr int XPER = BM * XCH / NT, YPER = BK * YCH / NT;
  static constexpr int XSTEP = NT / XCH, YSTEP = NT / YCH;
  static_assert(TM % 16 == 0 && TN % 8 == 0 && BK % 8 == 0,
                "Tile: m16n8 fragments, whole instruction steps");
  static_assert(NT % XCH == 0 && NT % YCH == 0 && XPER >= 1 && YPER >= 1 &&
                    BM % XSTEP == 0 && BK % YSTEP == 0,
                "Tile: whole copies a thread, in fixed columns");
  static_assert(STAGE_BYTES % 16 == 0, "Tile: 16-byte aligned stages");
};
using Large = Tile<128, 128, 32, 4, 4, 1>;   // core/tiling.py's (128, 128, 32)
using Small = Tile<64, 64, 16, 2, 2, 3>;     // core/tiling.py's (64, 64, 16)

struct DmmaArgs {
  const double* x;
  const double* y;
  const double* c;
  const double* bias;
  const double* res;
  void* out;
  int out_dt;
  int M, N, K;
  long long sxb, syb, scb, srb, sob;   // batch strides in elements
  double alpha, beta;
  int neg_product, neg_acc, act;
  int vec_x, vec_y;                    // 16-byte copies allowed
  int x_gk, y_gk;                      // panels along K (PANELS instances)
  const uint8_t* xm;                   // pm* byte masks over M, N and K,
  const uint8_t* ym;                   // each null or one byte a lane
  const uint8_t* pm;                   // (the MASKED instances)
  double* ck_col;                      // ((B,) gm, N) fp64 sidecar, or null
  double* ck_row;                      // ((B,) M, gn)
};

// D += A B: mma.sync m16n8k{IK}, f64 operands and accumulator.  Lane
// (g, t) = (lane / 4, lane % 4) holds A element e at row g + 8 (e % 2),
// column t + 4 (e / 2), B element h at row t + 4 h of column g, and D at
// row g (d0, d1) and g + 8 (d2, d3), columns 2t, 2t + 1.
template <int IK>
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[IK / 2],
                                     const double (&b)[IK / 4]);
template <>
__device__ __forceinline__ void dmma<8>(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <>
__device__ __forceinline__ void dmma<4>(double (&d)[4], const double (&a)[2],
                                        const double (&b)[1]) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

// cp.async of 8 bytes into shared memory, zero-filled where `in` is false
// (nothing is read then: src may lie past the matrix).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(in ? src : (const void*)cp_async_nothing), "r"(in ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ double act_d(double v, int act) {
  if (act == ACT_RELU) return v > 0.0 ? v : 0.0;
  if (act == ACT_SILU) return v / (1.0 + exp(-v));
  if (act == ACT_GELU) return v * (0.5 * (1.0 + erf(v * 0.7071067811865476)));
  return v;
}

__device__ __forceinline__ void store_d(void* out, int dt, long long i,
                                        double v) {
  if (dt == DT_F64)
    reinterpret_cast<double*>(out)[i] = v;
  else if (dt == DT_F32)
    reinterpret_cast<float*>(out)[i] = (float)v;
  else if (dt == DT_BF16)
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __double2bfloat16(v);
  else
    reinterpret_cast<__half*>(out)[i] = __double2half(v);
}

// Arrive on `bar` once this thread's cp.async copies so far have landed
// (the arrival counts toward the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Two doubles at src into dst, each copied where its flag is set and
// zero-filled where not: one 16-byte copy where the source is 16-byte
// aligned (`wide`) and the flags allow it, else one 8-byte copy a lane.
// The MASKED instances' copies go through it.  The others give the same
// shared-memory contents from their own branches (a panel row's padding
// is zero; past K or N a 16-byte copy is cut to the bytes left): routed
// through copy_pair too, the natural 128 x 128 instance spills at its
// 128-register cap (ptxas: 4 bytes) and the 64 x 64 one on X and Y panels
// takes 154 registers where it takes 126.
__device__ __forceinline__ void copy_pair(double* dst, const double* src,
                                          bool lo, bool hi, bool wide) {
  if (wide && (lo || !hi)) {
    cp_async16_upto(dst, src, lo ? (hi ? 16 : 8) : 0);
  } else {
    cp_async8(dst, src, lo);
    cp_async8(dst + 1, src + 1, hi);
  }
}

template <class T, bool MASKED, int PANELS>
__global__ void __launch_bounds__(T::NT, T::MINB)
    gemm_dmma_kernel(DmmaArgs a) {
  constexpr int IK = dmma_depth(PANELS);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int bz = blockIdx.z, m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int g = lane / 4, t = lane % 4;
  const double* xb = a.x + (long long)bz * a.sxb;
  const double* yb = a.y + (long long)bz * a.syb;
  const int M = a.M, N = a.N, K = a.K;

  // this thread's copies: X column xc of rows xr + j XSTEP, Y columns
  // yc of K rows yr + j YSTEP (fixed a tile; a K step moves them along K),
  // each read at a base pointer, plus the step's offset, plus j strides
  const int xc = 2 * (tid % T::XCH), xr = tid / T::XCH;
  const int yc = 2 * (tid % T::YCH), yr = tid / T::YCH;
  const double* xsrc;
  const double* ysrc;
  long long xj, yj;
  if constexpr ((PANELS & PANELS_X) != 0) {
    // a block's rows lie in one X panel band: rows step PANEL_C apart
    xsrc = xb + x_panel_at(m0 + xr, xc, a.x_gk);
    xj = (long long)T::XSTEP * PANEL_C;
  } else {
    xsrc = xb + (long long)(m0 + xr) * K + xc;
    xj = (long long)T::XSTEP * K;
  }
  if constexpr ((PANELS & PANELS_Y) != 0) {
    // within a 64-column Y panel band, row k lies at 64 k
    ysrc = yb + y_panel_at(yr, n0 + yc, a.y_gk);
    yj = (long long)T::YSTEP * PANEL_C;
  } else {
    ysrc = yb + (long long)yr * N + n0 + yc;
    yj = (long long)T::YSTEP * N;
  }
  // bit j where copy j's X row is in the matrix (and, MASKED, enabled)
  uint32_t xrow_in = 0;
#pragma unroll
  for (int j = 0; j < T::XPER; ++j) {
    const int row = m0 + xr + j * T::XSTEP;
    bool in = row < M;
    if constexpr (MASKED) in = in && (a.xm == nullptr || a.xm[row]);
    xrow_in |= (uint32_t)in << j;
  }
  // the Y copies' two columns (fixed a tile): in the matrix and, MASKED,
  // enabled
  const int ncols = N - (n0 + yc);
  bool ylo = ncols > 0, yhi = ncols > 1;
  if constexpr (MASKED) {
    if (a.ym) {
      ylo = ylo && a.ym[n0 + yc];
      yhi = yhi && a.ym[n0 + yc + 1];
    }
  }
  // MASKED: where a pair's source allows one 16-byte copy
  const bool xwide = (PANELS & PANELS_X) != 0 || a.vec_x;
  const bool ywide = (PANELS & PANELS_Y) != 0 || a.vec_y;

  auto issue = [&](int s) {   // K step s into ring slot s % DMMA_STAGES
    unsigned char* slot = smem_raw + (s % DMMA_STAGES) * T::STAGE_BYTES;
    double* as = reinterpret_cast<double*>(slot) + xr * T::AP + xc;
    double* bs = reinterpret_cast<double*>(slot) + T::BM * T::AP +
                 yr * T::BP + yc;
    const int k0 = s * T::BK, kx = K - (k0 + xc);   // X columns left
    const double* xs =
        xsrc + ((PANELS & PANELS_X) != 0
                    ? (long long)(k0 / PANEL_C) * (PANEL_XR * PANEL_C) +
                          k0 % PANEL_C
                    : (long long)k0);
    const double* ys = ysrc + (long long)k0 * ((PANELS & PANELS_Y) != 0
                                                   ? PANEL_C : N);
    // the X copies' two ranks: in the matrix and, MASKED, enabled
    bool xlo = kx > 0, xhi = kx > 1;
    if constexpr (MASKED) {
      if (a.pm) {
        xlo = xlo && a.pm[k0 + xc];
        xhi = xhi && a.pm[k0 + xc + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < T::XPER; ++j) {
      double* dst = as + j * T::XSTEP * T::AP;
      const double* src = xs + j * xj;
      const bool in = xrow_in >> j & 1u;
      if constexpr (MASKED) {
        copy_pair(dst, src, in && xlo, in && xhi, xwide);
      } else if ((PANELS & PANELS_X) != 0) {
        cp_async16_upto(dst, src, in && xlo ? 16 : 0);
      } else if (a.vec_x) {
        cp_async16_upto(dst, src, in ? 8LL * kx : 0);
      } else {
        cp_async8(dst, src, in && xlo);
        cp_async8(dst + 1, src + 1, in && xhi);
      }
    }
#pragma unroll
    for (int j = 0; j < T::YPER; ++j) {
      double* dst = bs + j * T::YSTEP * T::BP;
      const double* src = ys + j * yj;
      const int k = k0 + yr + j * T::YSTEP;
      bool in = k < K;
      if constexpr (MASKED) {
        in = in && (a.pm == nullptr || a.pm[k]);
        copy_pair(dst, src, in && ylo, in && yhi, ywide);
      } else if ((PANELS & PANELS_Y) != 0) {
        cp_async16_upto(dst, src, in && ylo ? 16 : 0);
      } else if (a.vec_y) {
        cp_async16_upto(dst, src, in ? 8LL * ncols : 0);
      } else {
        cp_async8(dst, src, in && ylo);
        cp_async8(dst + 1, src + 1, in && yhi);
      }
    }
  };

  // The ring's barriers: full[i] completes when every thread's copies
  // into slot i have landed (each thread's cp.async arrival, T::NT),
  // empty[i] when every warp is done reading it (T::NT / 32).
  __shared__ uint64_t full[DMMA_STAGES], empty[DMMA_STAGES];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < DMMA_STAGES; ++i) {
      mbar_init(&full[i], T::NT);
      mbar_init(&empty[i], T::NT / 32);
    }
  }
  __syncthreads();

  double acc[T::MF][T::NF][4];
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < T::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  const int nk = (K + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < DMMA_STAGES - 1; ++s) {
    if (s < nk) {
      issue(s);
      cp_async_arrive(&full[s]);
    }
  }
  // lane (g, t)'s first fragment elements in a stage
  const int a_off = (wm * T::TM + g) * T::AP + t;
  const int b_off = t * T::BP + wn * T::TN + g;
  for (int s = 0; s < nk; ++s) {
    const int i_s = s % DMMA_STAGES;
    mbar_wait(&full[i_s], (s / DMMA_STAGES) & 1);   // step s has landed
    const unsigned char* slot = smem_raw + i_s * T::STAGE_BYTES;
    const double* as = reinterpret_cast<const double*>(slot);
    const double* bs = as + T::BM * T::AP;
#pragma unroll
    for (int kk = 0; kk < T::BK / IK; ++kk) {
      constexpr int AE = IK / 2, BE = IK / 4;   // fragment doubles a lane
      double bf[T::NF][BE];
#pragma unroll
      for (int j = 0; j < T::NF; ++j)
#pragma unroll
        for (int h = 0; h < BE; ++h)
          bf[j][h] = bs[b_off + (kk * IK + 4 * h) * T::BP + 8 * j];
#pragma unroll
      for (int i = 0; i < T::MF; ++i) {
        double af[AE];
#pragma unroll
        for (int e = 0; e < AE; ++e)
          af[e] = as[a_off + (16 * i + 8 * (e % 2)) * T::AP + kk * IK +
                     4 * (e / 2)];
#pragma unroll
        for (int j = 0; j < T::NF; ++j) dmma<IK>(acc[i][j], af, bf[j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i_s]);   // this warp is done with it
    // step s + DMMA_STAGES - 1 into the slot step s - 1 held, once every
    // warp is done with step s - 1
    const int nx = s + DMMA_STAGES - 1;
    if (nx < nk) {
      if (nx >= DMMA_STAGES)
        mbar_wait(&empty[nx % DMMA_STAGES], (nx / DMMA_STAGES - 1) & 1);
      issue(nx);
      cp_async_arrive(&full[nx % DMMA_STAGES]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring: the tile aliases it

  // deprime through the shared fp64 tile
  double* cs = reinterpret_cast<double*>(smem_raw);
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < T::NF; ++j) {
      double* p = cs + (wm * T::TM + 16 * i + g) * T::CP + wn * T::TN +
                  8 * j + 2 * t;
      *reinterpret_cast<double2*>(p) = make_double2(acc[i][j][0],
                                                    acc[i][j][1]);
      *reinterpret_cast<double2*>(p + 8 * T::CP) =
          make_double2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  const long long cbase = (long long)bz * a.scb, rbase = (long long)bz * a.srb;
  const long long obase = (long long)bz * a.sob;
  for (int e = tid; e < T::BM * T::BN; e += T::NT) {
    const int row = e / T::BN, col = e % T::BN;
    const int gr = m0 + row, gc = n0 + col;
    if (gr >= M || gc >= N) continue;
    const long long idx = (long long)gr * N + gc;
    double v = cs[row * T::CP + col];
    if (a.neg_product) v = -v;
    if (a.c) {
      double s = a.c[cbase + idx];
      if (a.beta != 1.0) s *= a.beta;
      v += a.neg_acc ? -s : s;
    }
    if (a.alpha != 1.0) v *= a.alpha;
    if (a.bias) v += a.bias[gc];
    v = act_d(v, a.act);
    if (a.res) v += a.res[rbase + idx];
    store_d(a.out, a.out_dt, obase + idx, v);
    if (a.ck_col) cs[row * T::CP + col] = v;
  }
  if (a.ck_col) {
    __syncthreads();
    const int gm = (M + T::BM - 1) / T::BM, gn = (N + T::BN - 1) / T::BN;
    tile_checksums<double>(cs, T::CP, min(T::BM, M - m0), min(T::BN, N - n0),
                           a.ck_col + ((long long)bz * gm + m0 / T::BM) * N +
                               n0,
                           a.ck_row + ((long long)bz * M + m0) * gn +
                               n0 / T::BN,
                           gn, tid, T::NT);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One launch on tile T: `which` = panels | 4 for the MASKED instances.
template <class T>
int launch_tile(const DmmaArgs& a, int which, int batch, cudaStream_t st) {
  decltype(&gemm_dmma_kernel<T, false, 0>) kernel;
  switch (which) {
    case 0: kernel = gemm_dmma_kernel<T, false, 0>; break;
    case 1: kernel = gemm_dmma_kernel<T, false, 1>; break;
    case 2: kernel = gemm_dmma_kernel<T, false, 2>; break;
    case 3: kernel = gemm_dmma_kernel<T, false, 3>; break;
    case 4: kernel = gemm_dmma_kernel<T, true, 0>; break;
    case 5: kernel = gemm_dmma_kernel<T, true, 1>; break;
    case 6: kernel = gemm_dmma_kernel<T, true, 2>; break;
    case 7: kernel = gemm_dmma_kernel<T, true, 3>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  static bool smem_ok[8] = {};
  cudaError_t e = allow_smem(kernel, T::SMEM, &smem_ok[which]);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + T::BN - 1) / T::BN, (a.M + T::BM - 1) / T::BM, batch);
  kernel<<<grid, T::NT, T::SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// c, bias and res are fp64; batch strides count elements (0: an operand
// shared across the batch); xm, ym, pm the pm* byte masks over M, N and K,
// each null or one byte a lane; (bm, bn, bk) one of
// the compiled tiles (core/tiling.py's GEMM_TILES); ck_col / ck_row the
// sidecar's ((B,) ceil(M / bm), N) and ((B,) M, ceil(N / bn)) fp64
// outputs, or null; panels: which of x and y are core/packing.py's panels
// (PANELS_X, PANELS_Y), 16-byte aligned.
extern "C" int gemm_dmma_launch(const void* x, const void* y, const void* xm,
                                const void* ym, const void* pm, const void* c,
                                const void* bias, const void* res, void* out,
                                int out_dt, int batch, int M, int N, int K,
                                long long sxb, long long syb, long long scb,
                                long long srb, long long sob, double alpha,
                                double beta, int neg_product, int neg_acc,
                                int act, int bm, int bn, int bk, void* ck_col,
                                void* ck_row, void* stream, int panels) {
  DmmaArgs a;
  a.x = reinterpret_cast<const double*>(x);
  a.y = reinterpret_cast<const double*>(y);
  a.c = reinterpret_cast<const double*>(c);
  a.bias = reinterpret_cast<const double*>(bias);
  a.res = reinterpret_cast<const double*>(res);
  a.out = out;
  a.out_dt = out_dt;
  a.M = M; a.N = N; a.K = K;
  a.sxb = sxb; a.syb = syb; a.scb = scb; a.srb = srb; a.sob = sob;
  a.alpha = alpha; a.beta = beta;
  a.neg_product = neg_product; a.neg_acc = neg_acc; a.act = act;
  a.vec_x = K % 2 == 0 && sxb % 2 == 0 && aligned16(x);
  a.vec_y = N % 2 == 0 && syb % 2 == 0 && aligned16(y);
  const int gk = (K + PANEL_C - 1) / PANEL_C;
  a.x_gk = (panels & PANELS_X) ? gk : 0;
  a.y_gk = (panels & PANELS_Y) ? gk : 0;
  if ((a.x_gk && (!aligned16(x) || sxb % 2)) ||
      (a.y_gk && (!aligned16(y) || syb % 2)) || panels < 0 || panels > 3)
    return (int)cudaErrorInvalidValue;
  a.xm = reinterpret_cast<const uint8_t*>(xm);
  a.ym = reinterpret_cast<const uint8_t*>(ym);
  a.pm = reinterpret_cast<const uint8_t*>(pm);
  a.ck_col = reinterpret_cast<double*>(ck_col);
  a.ck_row = reinterpret_cast<double*>(ck_row);
  const int which = panels | (xm || ym || pm ? 4 : 0);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bm == Large::BM && bn == Large::BN && bk == Large::BK)
    return launch_tile<Large>(a, which, batch, st);
  if (bm == Small::BM && bn == Small::BN && bk == Small::BK)
    return launch_tile<Small>(a, which, batch, st);
  return (int)cudaErrorInvalidValue;
}
