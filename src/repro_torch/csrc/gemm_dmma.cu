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
// large products (a DGEMM of 8192^3 needs 16.4 ms at that rate); the
// operands' bytes (3.35 TB/s) for skinny ones.
//
// Design.  mma.sync.aligned.m8n8k4 with f64 operands and accumulator (the
// only fp64 tensor-core instruction; wgmma has no fp64 form).  One block of
// 4 warps owns one 64 x 64 output tile, each warp 32 x 32 of it as 4 x 4
// m8n8 accumulators (32 doubles a thread), and runs the whole k-loop:
// 16-deep stages of X (row-major) and Y (row-major; the instruction's B
// fragment is one element a thread, so Y needs no transpose) are loaded
// into registers before the current stage's MMAs and stored into the
// second of two shared-memory buffers after them (one barrier a stage).
// The row pitches (20 and 68 doubles) make every fragment read
// conflict-free.  The deprime goes through a shared fp64 tile, so that each
// output element is stored once, coalesced, in the requested dtype.
// The ABFT checksum sidecar (K1e, checksum=True in
// repro/kernels/mma_gemm.py): with ck_col / ck_row set, each finished fp64
// value goes back over the deprime tile after its store, and the block
// sums the tile's columns (one a thread) and rows (one a warp) in fp64, in
// a fixed order (common.cuh's tile_checksums); the stores are untouched.
// Masked (K1b): the MASKED instance loads each staged pair's mask bytes
// beside it and zeroes a disabled row or rank of X and rank or column of Y
// when the pair goes to shared memory (after the current stage's MMAs, so
// nothing waits on the mask loads), as load2 zero-fills the fringes: a NaN
// there never enters a product.

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 128;            // 4 warps, 2 x 2
constexpr int MT = 4, NT = 4;           // m8 / n8 tiles a warp
constexpr int AP = BK + 4;              // X panel pitch in doubles
constexpr int BP = BN + 4;              // Y panel pitch in doubles
constexpr int CP = BN + 4;              // deprime tile pitch
constexpr int STAGE = BM * AP + BK * BP;   // doubles a buffer
constexpr int X_UNITS = BM * BK / 2 / THREADS;   // double2 units a thread
constexpr int Y_UNITS = BK * BN / 2 / THREADS;
constexpr size_t SMEM =
    (2 * STAGE > BM * CP ? 2 * STAGE : BM * CP) * sizeof(double);

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
  int vec_x, vec_y;                    // 16-byte global loads allowed
  const uint8_t* xm;                   // pm* byte masks over M, N and K,
  const uint8_t* ym;                   // each null or one byte a lane
  const uint8_t* pm;                   // (the MASKED instance)
  double* ck_col;                      // ((B,) gm, N) fp64 sidecar, or null
  double* ck_row;                      // ((B,) M, gn)
};

__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// Two consecutive elements of row `row` starting at column `col` of a
// (rows, cols) row-major matrix, zero past either edge.
__device__ __forceinline__ double2 load2(const double* p, int rows, int cols,
                                         int row, int col, bool vec) {
  double2 v = make_double2(0.0, 0.0);
  if (row >= rows || col >= cols) return v;
  const double* q = p + (long long)row * cols + col;
  if (vec) return *reinterpret_cast<const double2*>(q);
  v.x = q[0];
  if (col + 1 < cols) v.y = q[1];
  return v;
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

// The pm* mask bytes of a staged pair, lanes (row, col) and (row, col + 1)
// of a matrix whose rows are masked by `rm` and columns by `cm`: byte 0 the
// row's, bytes 1 and 2 the columns' (1 where a mask is null or the lane
// lies past the edge, whose value load2 zero-filled).
__device__ __forceinline__ uchar4 mask_bytes(const uint8_t* rm,
                                            const uint8_t* cm, int rows,
                                            int cols, int row, int col) {
  uchar4 f = make_uchar4(1, 1, 1, 0);
  if (rm && row < rows) f.x = rm[row];
  if (cm && col < cols) f.y = cm[col];
  if (cm && col + 1 < cols) f.z = cm[col + 1];
  return f;
}

__device__ __forceinline__ double2 apply_mask(double2 v, uchar4 f) {
  if (!f.x) return make_double2(0.0, 0.0);
  if (!f.y) v.x = 0.0;
  if (!f.z) v.y = 0.0;
  return v;
}

template <bool MASKED>
__global__ void __launch_bounds__(THREADS) gemm_dmma_kernel(DmmaArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const int bz = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t = lane % 4;
  const double* xb = a.x + (long long)bz * a.sxb;
  const double* yb = a.y + (long long)bz * a.syb;

  double acc[MT][NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  double2 xs[X_UNITS], ys[Y_UNITS];
  uchar4 xf[X_UNITS], yf[Y_UNITS];   // the MASKED instance's mask bytes
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_UNITS; ++i) {
      const int u = threadIdx.x + i * THREADS;   // 8 units a row
      const int row = m0 + u / 8, col = k0 + 2 * (u % 8);
      xs[i] = load2(xb, a.M, a.K, row, col, a.vec_x);
      if constexpr (MASKED)
        xf[i] = mask_bytes(a.xm, a.pm, a.M, a.K, row, col);
    }
#pragma unroll
    for (int i = 0; i < Y_UNITS; ++i) {
      const int u = threadIdx.x + i * THREADS;   // 32 units a row
      const int row = k0 + u / 32, col = n0 + 2 * (u % 32);
      ys[i] = load2(yb, a.K, a.N, row, col, a.vec_y);
      if constexpr (MASKED)
        yf[i] = mask_bytes(a.pm, a.ym, a.K, a.N, row, col);
    }
  };
  auto store = [&](double* buf) {
#pragma unroll
    for (int i = 0; i < X_UNITS; ++i) {
      const int u = threadIdx.x + i * THREADS;
      double2 v = xs[i];
      if constexpr (MASKED) v = apply_mask(v, xf[i]);
      *reinterpret_cast<double2*>(buf + (u / 8) * AP + 2 * (u % 8)) = v;
    }
#pragma unroll
    for (int i = 0; i < Y_UNITS; ++i) {
      const int u = threadIdx.x + i * THREADS;
      double2 v = ys[i];
      if constexpr (MASKED) v = apply_mask(v, yf[i]);
      *reinterpret_cast<double2*>(buf + BM * AP + (u / 32) * BP +
                                  2 * (u % 32)) = v;
    }
  };

  const int ktiles = (a.K + BK - 1) / BK;
  load(0);
  store(smem);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const double* cur = smem + (kt & 1) * STAGE;
    if (kt + 1 < ktiles) load((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK / 4; ++kk) {
      double af[MT], bf[NT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        af[i] = cur[(wm * 32 + i * 8 + g) * AP + kk * 4 + t];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        bf[j] = cur[BM * AP + (kk * 4 + t) * BP + wn * 32 + j * 8 + g];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) dmma(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < ktiles) store(smem + ((kt + 1) & 1) * STAGE);
    __syncthreads();
  }

  // deprime through a shared fp64 tile (aliasing the panels, all read)
  double* cs = smem;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        cs[(wm * 32 + i * 8 + g) * CP + wn * 32 + j * 8 + 2 * t + r] =
            acc[i][j][r];
  __syncthreads();
  const long long cbase = (long long)bz * a.scb, rbase = (long long)bz * a.srb;
  const long long obase = (long long)bz * a.sob;
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int row = e / BN, col = e % BN;
    const int gr = m0 + row, gc = n0 + col;
    if (gr >= a.M || gc >= a.N) continue;
    const long long idx = (long long)gr * a.N + gc;
    double v = cs[row * CP + col];
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
    if (a.ck_col) cs[row * CP + col] = v;
  }
  if (a.ck_col) {
    __syncthreads();
    const int gm = (a.M + BM - 1) / BM, gn = (a.N + BN - 1) / BN;
    tile_checksums<double>(cs, CP, min(BM, a.M - m0), min(BN, a.N - n0),
                           a.ck_col + ((long long)bz * gm + m0 / BM) * a.N +
                               n0,
                           a.ck_row + ((long long)bz * a.M + m0) * gn +
                               n0 / BN,
                           gn, threadIdx.x, THREADS);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// c, bias and res are fp64; batch strides count elements; xm, ym, pm the
// pm* byte masks over M, N and K, each null or one byte a lane; ck_col /
// ck_row the sidecar's ((B,) ceil(M / 64), N) and ((B,) M, ceil(N / 64))
// fp64 outputs, or null.
extern "C" int gemm_dmma_launch(const void* x, const void* y, const void* xm,
                                const void* ym, const void* pm, const void* c,
                                const void* bias, const void* res, void* out,
                                int out_dt, int batch, int M, int N, int K,
                                long long sxb, long long syb, long long scb,
                                long long srb, long long sob, double alpha,
                                double beta, int neg_product, int neg_acc,
                                int act, void* ck_col, void* ck_row,
                                void* stream) {
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
  a.xm = reinterpret_cast<const uint8_t*>(xm);
  a.ym = reinterpret_cast<const uint8_t*>(ym);
  a.pm = reinterpret_cast<const uint8_t*>(pm);
  a.ck_col = reinterpret_cast<double*>(ck_col);
  a.ck_row = reinterpret_cast<double*>(ck_row);
  const bool masked = xm || ym || pm;
  static bool smem_ok[2] = {false, false};
  auto kernel = masked ? gemm_dmma_kernel<true> : gemm_dmma_kernel<false>;
  cudaError_t e = allow_smem(kernel, SMEM, &smem_ok[masked]);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  kernel<<<grid, THREADS, SMEM, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
