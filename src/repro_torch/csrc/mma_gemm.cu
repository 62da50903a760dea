// Accumulator-resident blocked GEMM for Hopper (sm_90a): the WMMA tiles.
//
// Replaces the TPU kernel K1a: repro/kernels/mma_gemm.py, mma_gemm
// (kernel body _make_kernel), restricted to the F32GER / BF16GER2 / F16GER2
// families, 2-D and batched operands, the accumulate forms, the fused
// epilogue and the ABFT checksum sidecar:
//
//     out = cast(residual + act(bias + alpha * ([-](X @ Y) + s * beta * C)))
//
// with s = -1 for the neg_acc form, and the pm* prefixed masked forms (K1b:
// the row, column and rank predicates of repro/kernels/mma_gemm.py's
// _make_kernel, applied to the staged panels) and prepacked X and Y panels
// (K1d: the packed_spec of repro/kernels/mma_gemm.py).  The int8/int4/int16/f64
// families are in gemm_imma.cu and gemm_dmma.cu.
//
// Which products run here.  core/tiling.py's choose_gemm_path sends M <=
// 64 to the weight stream (gemm_stream.cu; F32GER too) and larger 16-bit
// M with 16-byte pitches to the TMA + wgmma tile (gemm_wgmma.cu).  This
// kernel takes the rest: pitches TMA cannot describe at large M
// (whisper's 51865-column logits over a prompt), K below one MMA step
// (the SSD's K = 1 outer product), F32GER at M > 64, which stays true
// fp32 (never TF32), and an explicit Plan.block naming one of
// core/tiling.py's GEMM_TILES, and every masked 16-bit or fp32 product,
// at any M (choose_gemm_path(masked=True)).
//
// What bounds it on an H100: device memory (3.35 TB/s) for skinny
// products, the tensor cores (989 TFLOP/s bf16; 67 TFLOP/s fp32 FMAs for
// F32GER) for large ones.
//
// Design.  One thread block owns one (bm, bn) output tile and runs the
// whole k-loop itself; batch comes from blockIdx.z.
//   * prime: the seed C (neg/beta forms) is read once into a shared fp32
//     tile and loaded into the warps' accumulator fragments;
//   * update: (bm, bk) and (bk, bn) panels are staged in shared memory,
//     zero-filled past the M, N and K fringes, and multiplied on the
//     bf16/f16 tensor cores into fp32 registers (tile_gemm.cuh's
//     wmma_tile_ab: a 4-stage cp.async ring, ldmatrix and mma.sync
//     m16n8k16, one barrier a K step); F32GER runs
//     tile_gemm.cuh's f32_simt_tile (128 x 128 or 64 x 64, 8 x 8 or 4 x 4
//     fp32 FMAs a thread, two stages in flight);
//   * deprime: the fragments go back through the shared tile, and one
//     masked pass applies alpha and the epilogue and stores each output
//     element exactly once, in the requested dtype.
//   * masked (K1b): the kernels' MASKED instances stage their panels
//     through tile_gemm.cuh's MaskedRowMajorA/B: a disabled row of X or
//     rank of Y is not copied (the copy zero-fills it, as past the
//     fringes), a disabled rank of X or column of Y is selected to 0 in
//     the landed chunk (a thread's 8 mask bytes, read a K step ahead);
//     the unmasked instances read no mask.
//   * packed panels (K1d): with `panels` set, y arrives as
//     core/packing.py's (B?, gn, gk, 64, 64) Y panels and/or x as its
//     (B?, gm, gk, 128, 64) X panels, read by tile_gemm.cuh's PackedB and
//     PackedA (MaskedPackedB / MaskedPackedA under pm* masks): each stage
//     comes out of the fixed panels one 16-byte copy a chunk, zero past M,
//     K and N as the natural loaders stage it, so the result (and the
//     sidecar) is the natural launch's bit for bit; the tight-parity config
//     served prepacked reads its fp32 panels here with no per-call
//     relayout.  Which operands are panels is the kernels' PANELS template
//     argument (common.cuh's PANELS_X | PANELS_Y), so the natural
//     instances are unchanged.
//   * the ABFT sidecar (K1e, checksum=True in repro/kernels/mma_gemm.py):
//     with ck_col / ck_row set, the deprime writes each finished fp32
//     value back over the staged fp32 tile, and the block sums the
//     tile's columns (one a thread) and rows (one a warp) in a fixed order
//     (common.cuh's tile_checksums): one write per tile column and row, no
//     atomics; the stores are untouched.
// The 16-bit update loop is tile_gemm.cuh's, shared with K3's implicit
// GEMM: a natural row at a 16-byte offset is copied as it lies, any other
// as the whole 16-byte words that cover it, realigned in shared memory
// (whisper's 51865-column logits), row by row, so no pitch puts the whole
// matrix on a slow path.  Each output is one chain of m16n8k16
// products in ascending k from the seed or +0.0, the chain of the WMMA
// fragments the tile used before, so its bits do not depend on the loader
// or the staging.  The fp32 tile carries F32GER's products at M > 64: each
// output one fmaf chain in ascending k from the seed or zero, the chain
// K3's fp32 conv takes on the same tile (tile_gemm.cuh's f32_simt_tile),
// so its bits do not depend on the tile.

#include "tile_gemm.cuh"

struct GemmArgs {
  const void* x;
  const void* y;
  const void* c;
  const void* bias;
  const void* res;
  void* out;
  int c_dt, bias_dt, res_dt, out_dt;
  int M, N, K;
  long long sxb, syb, scb, srb, sob;  // batch strides in elements (0: shared)
  float alpha, beta;
  int neg_product, neg_acc, act;
  int vec_x, vec_y;  // fp32 rows 16-byte aligned: the F32GER tile's float4
                     // loads (the 16-bit tile decides row by row)
  PmMasks mk;        // the pm* predicates (the MASKED instances)
  long long slab;    // elements of one 64-column Y panel slab (PANELS_Y)
  int x_gk;          // X panels along K (PANELS_X)
  float* ck_col;     // ((B,) gm, N) per-tile column sums, or null
  float* ck_row;     // ((B,) M, gn) per-tile row sums, or null
};

// prime: the seed s * beta * C into the shared fp32 tile (zero off-matrix).
// With the neg_product form the accumulator holds -(seed) + X@Y and the
// deprime negates it back, so the seed sign folds both forms.
template <int BM, int BN>
__device__ void prime_tile(float* cs, const GemmArgs& a, int bz, int m0,
                           int n0) {
  constexpr int LDC = BN + 4;
  const float sign = (a.neg_acc ? -1.f : 1.f) * (a.neg_product ? -1.f : 1.f);
  const long long base = (long long)bz * a.scb;
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = i / BN, cc = i % BN;
    const int gr = m0 + r, gc = n0 + cc;
    float v = 0.f;
    if (gr < a.M && gc < a.N)
      v = sign * (a.beta * load_f(a.c, a.c_dt, base + (long long)gr * a.N + gc));
    cs[r * LDC + cc] = v;
  }
}

// deprime: alpha, epilogue, cast; every in-bounds element stored once;
// with the sidecar, the finished values back over the tile and its sums.
template <int BM, int BN>
__device__ void store_tile(float* cs, const GemmArgs& a, int bz, int m0,
                           int n0) {
  constexpr int LDC = BN + 4;
  const float fin = a.neg_product ? -1.f : 1.f;
  const long long rbase = (long long)bz * a.srb;
  const long long obase = (long long)bz * a.sob;
  const bool ck = a.ck_col != nullptr;
  for_each_in_tile<BM, BN>(cs, a.M, a.N, m0, n0, [&](int gr, int gc, float v) {
    v *= fin;
    if (a.alpha != 1.f) v *= a.alpha;
    const long long idx = (long long)gr * a.N + gc;
    v = epilogue_apply(v, a.act, a.bias, a.bias_dt, gc, a.res, a.res_dt,
                       rbase + idx);
    store_f(a.out, a.out_dt, obase + idx, v);
    if (ck) cs[(gr - m0) * LDC + gc - n0] = v;
  });
  if (ck) {
    __syncthreads();
    const int gm = (a.M + BM - 1) / BM, gn = (a.N + BN - 1) / BN;
    tile_checksums<float>(cs, LDC, min(BM, a.M - m0), min(BN, a.N - n0),
                          a.ck_col + ((long long)bz * gm + m0 / BM) * a.N + n0,
                          a.ck_row + ((long long)bz * a.M + m0) * gn + n0 / BN,
                          gn, threadIdx.x, blockDim.x);
  }
}

// The A and B loaders of one launch (tile_gemm.cuh): natural rows or
// packed panels, masked or not.  `vec`: the F32GER tile's 16-byte loads of
// natural rows.
template <typename T, bool MASKED, bool PX>
__device__ __forceinline__ auto a_loader(const GemmArgs& a, const T* x, int m0,
                                         bool vec) {
  if constexpr (PX) {
    const PackedA<T> p{x, a.M, a.K, m0, a.x_gk};
    if constexpr (MASKED) return MaskedPackedA<T>{p, a.mk};
    else return p;
  } else if constexpr (MASKED) {
    return MaskedRowMajorA<T>{x, a.M, a.K, m0, vec, a.mk};
  } else {
    return RowMajorA<T>{x, a.M, a.K, m0, vec};
  }
}

template <typename T, bool MASKED, bool PY>
__device__ __forceinline__ auto b_loader(const GemmArgs& a, const T* y, int n0,
                                         bool vec) {
  if constexpr (PY) {
    const PackedB<T> p{y, a.K, a.N, n0, a.slab};
    if constexpr (MASKED) return MaskedPackedB<T>{p, a.mk};
    else return p;
  } else if constexpr (MASKED) {
    return MaskedRowMajorB<T>{y, a.K, a.N, n0, vec, a.mk};
  } else {
    return RowMajorB<T>{y, a.K, a.N, n0, vec};
  }
}

// bf16 / f16 on the tensor cores (tile_gemm.cuh's wmma_tile_ab).
template <typename T, int BM, int BN, int BK, int WM, int WN, bool MASKED,
          int PANELS>
__global__ void __launch_bounds__(WM* WN * 32, 2)
    gemm_wmma_kernel(GemmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  // the grid's M tiles of one N column run together, so that a Y panel is
  // read from device memory about once
  const int id = blockIdx.x + blockIdx.y * gridDim.x;
  const int bz = blockIdx.z, m0 = (id % gridDim.y) * BM,
            n0 = (id / gridDim.y) * BN;
  if (a.c) prime_tile<BM, BN>(cs, a, bz, m0, n0);
  const T* x = reinterpret_cast<const T*>(a.x) + (long long)bz * a.sxb;
  const T* y = reinterpret_cast<const T*>(a.y) + (long long)bz * a.syb;
  wmma_tile_ab<T, BM, BN, BK, WM, WN>(
      smem, a_loader<T, MASKED, (PANELS & PANELS_X) != 0>(a, x, m0,
                                                           a.vec_x != 0),
      b_loader<T, MASKED, (PANELS & PANELS_Y) != 0>(a, y, n0, a.vec_y != 0),
      a.K, a.c != nullptr);
  store_tile<BM, BN>(cs, a, bz, m0, n0);
}

// F32GER: true fp32 FMAs on the CUDA cores (tile_gemm.cuh's
// f32_simt_tile), on a (BM, BN) tile of 128 x 128 or 64 x 64, two blocks an
// SM (the register budget of 128 a thread).
template <bool MASKED, int PANELS, int BM, int BN>
__global__ void __launch_bounds__(F32S_THREADS, 2)
    gemm_f32_kernel(GemmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  const int bz = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (a.c) prime_tile<BM, BN>(cs, a, bz, m0, n0);
  const float* x = reinterpret_cast<const float*>(a.x) + (long long)bz * a.sxb;
  const float* y = reinterpret_cast<const float*>(a.y) + (long long)bz * a.syb;
  f32_simt_tile<BM, BN>(
      smem,
      a_loader<float, MASKED, (PANELS & PANELS_X) != 0>(a, x, m0,
                                                        a.vec_x != 0),
      b_loader<float, MASKED, (PANELS & PANELS_Y) != 0>(a, y, n0,
                                                        a.vec_y != 0),
      a.K, a.c != nullptr);
  store_tile<BM, BN>(cs, a, bz, m0, n0);
}

template <bool MASKED, int PANELS, int BM, int BN>
static int launch_f32(const GemmArgs& a, int batch, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t smem = f32_simt_smem_bytes<BM, BN>();
  auto kernel = gemm_f32_kernel<MASKED, PANELS, BM, BN>;
  cudaError_t e = allow_smem(kernel, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, batch);
  kernel<<<grid, F32S_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The tiles core/tiling.py GEMM_TILES lists for F32GER.
template <bool MASKED, int PANELS>
static int launch_f32_tile(const GemmArgs& a, int batch, int bm, int bn,
                           int bk, cudaStream_t stream) {
  if (bk != F32S_BK) return (int)cudaErrorInvalidValue;
  if (bm == 128 && bn == 128)
    return launch_f32<MASKED, PANELS, 128, 128>(a, batch, stream);
  if (bm == 64 && bn == 64)
    return launch_f32<MASKED, PANELS, 64, 64>(a, batch, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int BM, int BN, int BK, int WM, int WN, bool MASKED,
          int PANELS>
static int launch_wmma(const GemmArgs& a, int batch, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t smem = wmma_smem_bytes<T, BM, BN, BK>();
  auto kernel = gemm_wmma_kernel<T, BM, BN, BK, WM, WN, MASKED, PANELS>;
  cudaError_t e = allow_smem(kernel, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, batch);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool MASKED, int PANELS>
static int launch_16bit(const GemmArgs& a, int batch, int bm, int bn, int bk,
                        cudaStream_t stream) {
  // The tiles core/tiling.py GEMM_TILES lists for BF16GER2 / F16GER2.
  if (bm == 128 && bn == 128 && bk == 32)
    return launch_wmma<T, 128, 128, 32, 2, 4, MASKED, PANELS>(a, batch,
                                                              stream);
  if (bm == 64 && bn == 64 && bk == 64)
    return launch_wmma<T, 64, 64, 64, 2, 2, MASKED, PANELS>(a, batch, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int PANELS>
static int launch_16bit_any(const GemmArgs& a, bool masked, int batch, int bm,
                            int bn, int bk, cudaStream_t stream) {
  return masked ? launch_16bit<T, true, PANELS>(a, batch, bm, bn, bk, stream)
                : launch_16bit<T, false, PANELS>(a, batch, bm, bn, bk,
                                                 stream);
}

template <int PANELS>
static int launch_any(const GemmArgs& a, int in_dt, bool masked, int batch,
                      int bm, int bn, int bk, cudaStream_t s) {
  if (in_dt == DT_BF16)
    return launch_16bit_any<__nv_bfloat16, PANELS>(a, masked, batch, bm, bn,
                                                   bk, s);
  if (in_dt == DT_F16)
    return launch_16bit_any<__half, PANELS>(a, masked, batch, bm, bn, bk, s);
  if (in_dt == DT_F32)
    return masked ? launch_f32_tile<true, PANELS>(a, batch, bm, bn, bk, s)
                  : launch_f32_tile<false, PANELS>(a, batch, bm, bn, bk, s);
  return (int)cudaErrorInvalidValue;
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The launchers, one argument list.  xm, ym, pm: the pm* byte masks over M,
// N and K, each null or one byte a lane; any non-null one selects the
// MASKED kernels.  ck_col / ck_row: the sidecar's ((B,) ceil(M / bm), N)
// and ((B,) M, ceil(N / bn)) fp32 outputs, or null.  x and y: natural
// (M, K) and (K, N) rows (panels = 0), or either or both as core/packing.py's (B?, gm, gk, 128, 64) X and (B?, gn, gk, 64,
// 64) Y panels (panels: PANELS_X, PANELS_Y), 16-byte aligned; batch
// strides in elements of what each pointer holds, 0 where an operand is
// shared across the batch.
extern "C" int mma_gemm_launch(
    const void* x, const void* y, const void* xm, const void* ym,
    const void* pm, const void* c, const void* bias,
    const void* res, void* out, int in_dt, int c_dt, int bias_dt, int res_dt,
    int out_dt, int batch, int M, int N, int K, long long sxb, long long syb,
    long long scb, long long srb, long long sob, float alpha, float beta,
    int neg_product, int neg_acc, int act, int bm, int bn, int bk,
    float* ck_col, float* ck_row, void* stream, int panels) {
  GemmArgs a;
  a.x = x; a.y = y; a.c = c; a.bias = bias; a.res = res; a.out = out;
  a.c_dt = c_dt; a.bias_dt = bias_dt; a.res_dt = res_dt; a.out_dt = out_dt;
  a.M = M; a.N = N; a.K = K;
  a.sxb = sxb; a.syb = syb; a.scb = scb; a.srb = srb; a.sob = sob;
  a.alpha = alpha; a.beta = beta;
  a.neg_product = neg_product; a.neg_acc = neg_acc; a.act = act;
  // fp32 rows the F32GER tile reads as float4s; the 16-bit tile picks
  // each row's copies from its address (tile_gemm.cuh's copy_chunk)
  a.vec_x = (K % 4 == 0) && aligned16(x) && (sxb % 4 == 0);
  a.vec_y = (N % 4 == 0) && aligned16(y) && (syb % 4 == 0);
  a.mk.xm = reinterpret_cast<const uint8_t*>(xm);
  a.mk.ym = reinterpret_cast<const uint8_t*>(ym);
  a.mk.pm = reinterpret_cast<const uint8_t*>(pm);
  a.ck_col = ck_col; a.ck_row = ck_row;
  // packed panels: a Y slab is one column block's gk panels; X panels
  // are read through x_panel_at (the batch strides are the panels')
  const int gk = (K + PANEL_C - 1) / PANEL_C;
  a.slab = (long long)gk * PANEL_YR * PANEL_C;
  a.x_gk = gk;
  if (((panels & PANELS_Y) && (!aligned16(y) || syb % 8)) ||
      ((panels & PANELS_X) && (!aligned16(x) || sxb % 8)))
    return (int)cudaErrorInvalidValue;
  const bool masked = xm || ym || pm;
  for (const void* m : {xm, ym, pm})   // 8-byte mask loads
    if (m && !aligned16(m)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (panels) {
    case 0: return launch_any<0>(a, in_dt, masked, batch, bm, bn, bk, s);
    case PANELS_X:
      return launch_any<PANELS_X>(a, in_dt, masked, batch, bm, bn, bk, s);
    case PANELS_Y:
      return launch_any<PANELS_Y>(a, in_dt, masked, batch, bm, bn, bk, s);
    case PANELS_X | PANELS_Y:
      return launch_any<PANELS_X | PANELS_Y>(a, in_dt, masked, batch, bm, bn,
                                             bk, s);
  }
  return (int)cudaErrorInvalidValue;
}
