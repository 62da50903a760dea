// The port's two convolution kernels for Hopper (sm_90a): K4, the depthwise
// conv (first half of this file), and K3, the dense conv as an implicit
// GEMM (second half, with its own head comment).
//
// K4: depthwise (groups == C) VALID strided convolution.
//
// Replaces the TPU kernel K4: repro/kernels/mma_conv.py,
// mma_depthwise_conv2d (kernel body _depthwise_kernel):
//
//     out[n, oh, ow, c] = cast(residual + act(bias[c]
//         + sum_{i < KH, j < KW} x[n, oh*SH + i, ow*SW + j, c] * w[i, j, c]))
//
// for x (N, H, W, C) and taps (KH, KW, C) in f32, bf16 or f16, an fp32
// accumulator and the fused epilogue of kernels/epilogue.py.  It is
// mamba2's causal conv: (N, 1, L + 3, C) x (1, 4, C) with bias + silu,
// once per SSM layer in every prefill and decode step.
//
// What bounds it on an H100.  Each output element costs KH*KW multiply-adds
// on data it reads once, so it is bound by device memory (3.35 TB/s):
// zamba2's prefill conv at L = 256 moves ~4.4 MB in and ~2.2 MB out (~2 us
// at the bound), and a decode conv (L = 1) moves ~0.3 MB, so it is bound
// by the launch itself.
//
// Design.  The TPU grid (N*OH, C/bc, KH) walked KH in order and carried an
// (OW, bc) accumulator in VMEM scratch across it.  Blocks on the card run
// in no order, so nothing carries over: each thread owns output elements
// (n, oh, ow, c), with c fastest so that neighbouring threads read
// neighbouring addresses, and loops over all KH x KW taps in a register.
// The products and sums are rounded one by one, in the order of the plain
// version (ref.depthwise_conv: for i, for j, acc += x * w), never
// contracted into FMAs.  The epilogue applies once, in fp32, and each
// output element is stored exactly once in the output dtype.  Strides and
// ragged C / OW need no masking beyond the element-count bound, since no
// tile is padded.  This is the simple, correct first kernel: scalar loads,
// the KW-fold reuse of an input row left to L1 (PERF.md has its times).

#include "tile_gemm.cuh"

struct DwArgs {
  const void* x;
  const void* w;
  const void* bias;
  const void* res;
  void* out;
  int bias_dt, res_dt, out_dt;
  int N, H, W, C, KH, KW, SH, SW, OH, OW;
  int act;
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__global__ void depthwise_conv_kernel(DwArgs a) {
  const T* __restrict__ x = reinterpret_cast<const T*>(a.x);
  const T* __restrict__ w = reinterpret_cast<const T*>(a.w);
  const long long total = (long long)a.N * a.OH * a.OW * a.C;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(e % a.C);
    long long r = e / a.C;
    const int ow = (int)(r % a.OW);
    r /= a.OW;
    const int oh = (int)(r % a.OH);
    const int n = (int)(r / a.OH);
    float acc = 0.f;
    for (int i = 0; i < a.KH; ++i) {
      const long long row =
          ((long long)n * a.H + (long long)oh * a.SH + i) * a.W;
      for (int j = 0; j < a.KW; ++j) {
        const float xv =
            to_f<T>(x[(row + (long long)ow * a.SW + j) * a.C + c]);
        const float wv = to_f<T>(w[((long long)i * a.KW + j) * a.C + c]);
        acc = __fadd_rn(acc, __fmul_rn(xv, wv));
      }
    }
    const float v = epilogue_apply(acc, a.act, a.bias, a.bias_dt, c, a.res,
                                   a.res_dt, e);
    store_f(a.out, a.out_dt, e, v);
  }
}

extern "C" int mma_depthwise_conv_launch(
    const void* x, const void* w, const void* bias, const void* res,
    void* out, int in_dt, int bias_dt, int res_dt, int out_dt, int N, int H,
    int W, int C, int KH, int KW, int SH, int SW, int act, void* stream) {
  DwArgs a;
  a.x = x; a.w = w; a.bias = bias; a.res = res; a.out = out;
  a.bias_dt = bias_dt; a.res_dt = res_dt; a.out_dt = out_dt;
  a.N = N; a.H = H; a.W = W; a.C = C; a.KH = KH; a.KW = KW;
  a.SH = SH; a.SW = SW;
  a.OH = (H - KH) / SH + 1;
  a.OW = (W - KW) / SW + 1;
  a.act = act;
  if (N < 1 || C < 1 || KH < 1 || KW < 1 || SH < 1 || SW < 1 || H < KH ||
      W < KW)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * a.OH * a.OW * C;
  const int threads = 256;
  // One element per thread up to 132 SMs x 16 blocks; beyond that the
  // grid-stride loop takes the rest.
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_F32)
    depthwise_conv_kernel<float><<<blocks, threads, 0, s>>>(a);
  else if (in_dt == DT_BF16)
    depthwise_conv_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(a);
  else if (in_dt == DT_F16)
    depthwise_conv_kernel<__half><<<blocks, threads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ======================================================================
// K3: dense VALID strided convolution as an implicit GEMM.
//
// Replaces the TPU kernel K3: repro/kernels/mma_conv.py, mma_conv2d
// (kernel body _sconv_kernel):
//
//     out[n, oh, ow, f] = cast(residual + act(bias[f]
//         + sum_{i, j, c} x[n, oh*SH + i, ow*SW + j, c] * w[i, j, c, f]))
//
// for x (N, H, W, C) and w (KH, KW, C, F) in bf16, f16 (tensor cores) or
// f32 (F32GER: true fp32 FMAs, never TF32), an fp32 accumulator and the
// fused epilogue of kernels/epilogue.py.  On the main path it is whisper's
// conv stem (two k3 CONV1Ds over 3000 mel frames, the second of stride 2,
// bias + gelu) and qwen2-vl's patch embed (one 14 x 14, stride-14 CONV2D
// over a 448 x 448 image, bias), once per prefill.
//
// What bounds it on an H100.  As a GEMM it is (M, K) x (K, F) with
// M = N*OH*OW output pixels and K = KH*KW*C.  whisper's conv2 at batch 4
// (M 6000, K 2304, F 768: 21 GFLOP, 31 MB) is bound by the bf16 tensor
// cores (0.021 ms at 989 TFLOP/s); conv1 (K 240) and the patch embed
// (K 588) do ~10-350 flops a byte and sit near the knee, bound by device
// memory or operations by a few per cent either way.
//
// Design.  The TPU kernel walked KH as an in-order grid axis with an
// (OW, bf) accumulator resident in VMEM, and folded KW*C per step into one
// MXU dot where the panel was lane-aligned.  Neither carries over: here
// one thread block owns one (BM pixels, BN filters) output tile and runs
// the whole flattened K loop itself, with K in the filter's own order
// (i, j, c), so the B panel is a plain (BK, BN) window of the (K, F) view
// of the filter bank.  The A panel is gathered from the image on the fly
// and the patch matrix never exists in memory: each tile row's pixel
// offset ((n*H + oh*SH)*W + ow*SW)*C is computed once into shared memory,
// and each K step computes its BK column offsets i*W*C + (j*C + c) once,
// so element (m, k) is x[row[m] + col[k]].  For a fixed i the (j, c) run
// is contiguous in the image, so where C % 8 == 0 (whisper: 80 and 768)
// the gather is 16-byte vectors; qwen2-vl's C = 3 gathers by element.
// The K, M and F fringes are zero-filled on load (K = 588 and 240 are no
// multiple of the 32-deep step).  Only that A loader is K3's own: the tile
// loop (WMMA bf16/f16 fragments into fp32 registers, or fp32 FMAs for
// F32GER) is tile_gemm.cuh's, shared with K1a.  The epilogue applies once
// in fp32 and each output element is stored once, in the output dtype.
// The simple, correct first kernel: synchronous loads, no cp.async/TMA
// pipeline and no wgmma (PERF.md has its times).

struct ConvArgs {
  const void* x;
  const void* w;
  const void* bias;
  const void* res;
  void* out;
  int bias_dt, res_dt, out_dt;
  int N, H, W, C, KH, KW, F, SH, SW, OH, OW;
  int M, K;  // the implicit GEMM: M = N*OH*OW, K = KH*KW*C
  int act;
  int vec_a, vec_b;  // 16-byte gathers (C % 8 == 0) / rows (F % 8 == 0)
};

// Image offset of each tile row's pixel (n, oh, ow) at (i, j, c) = 0; -1
// past M.
template <int BM>
__device__ void conv_row_offsets(long long* rows, const ConvArgs& a, int m0) {
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    const int m = m0 + r;
    long long off = -1;
    if (m < a.M) {
      const int ow = m % a.OW;
      const int t = m / a.OW;
      const int oh = t % a.OH;
      const int n = t / a.OH;
      off = (((long long)n * a.H + (long long)oh * a.SH) * a.W +
             (long long)ow * a.SW) * a.C;
    }
    rows[r] = off;
  }
}

// K3's A loader for tile_gemm.cuh: the panel gathered from the image.
// rows[r] is tile row r's pixel offset (-1 past M); each K step first
// computes its column offsets cols[kk] = i*W*C + (j*C + c) for
// k = (i*KW + j)*C + c (-1 past K), so element (r, kk) is
// x[rows[r] + cols[kk]].
template <typename T>
struct ConvGatherA {
  const T* x;
  long long* rows;
  long long* cols;
  long long wc;  // W * C: one image row
  int kwc, K;    // KW * C: one filter row; KH * KW * C
  bool vec;      // C % 8 == 0: 8 columns are one contiguous 16-byte run

  template <int BK>
  __device__ void col_offsets(int k0) const {
    for (int kk = threadIdx.x; kk < BK; kk += blockDim.x) {
      const int k = k0 + kk;
      long long off = -1;
      if (k < K) {
        const int i = k / kwc;
        off = (long long)i * wc + (k - i * kwc);
      }
      cols[kk] = off;
    }
    __syncthreads();
  }

  template <int BM, int BK, int LDA>
  __device__ void panel(T* as, int k0) const {
    col_offsets<BK>(k0);
    if (vec) {  // K % 8 == 0: an 8-column chunk is all in range or all out
      constexpr int CH = BK / 8;
      for (int i = threadIdx.x; i < BM * CH; i += blockDim.x) {
        const int r = i / CH, c8 = (i % CH) * 8;
        const long long row = rows[r], col = cols[c8];
        uint4 v = make_uint4(0u, 0u, 0u, 0u);  // +0.0 in bf16 and f16
        if (row >= 0 && col >= 0)
          v = __ldg(reinterpret_cast<const uint4*>(x + row + col));
        *reinterpret_cast<uint4*>(as + r * LDA + c8) = v;
      }
    } else {
      for (int i = threadIdx.x; i < BM * BK; i += blockDim.x) {
        const int r = i / BK, kk = i % BK;
        const long long row = rows[r], col = cols[kk];
        as[r * LDA + kk] = (row >= 0 && col >= 0) ? x[row + col] : zero_of<T>();
      }
    }
  }

  template <int BM, int BK, int LDT>
  __device__ void panel_kmajor(float* as, int k0) const {
    col_offsets<BK>(k0);
    for (int i = threadIdx.x; i < BM * BK; i += blockDim.x) {
      const int r = i / BK, kk = i % BK;
      const long long row = rows[r], col = cols[kk];
      as[kk * LDT + r] = (row >= 0 && col >= 0) ? x[row + col] : 0.f;
    }
  }
};

// Row offsets for the tile, then the A loader over them; the offsets live
// after the tile's panels in shared memory.
template <typename T, int BM, int BK>
__device__ ConvGatherA<T> conv_gather(unsigned char* smem, size_t panels,
                                      const ConvArgs& a, int m0) {
  long long* rows = reinterpret_cast<long long*>(smem + panels);
  conv_row_offsets<BM>(rows, a, m0);  // read after col_offsets' barrier
  return ConvGatherA<T>{reinterpret_cast<const T*>(a.x), rows, rows + BM,
                        (long long)a.W * a.C, a.KW * a.C, a.K, a.vec_a != 0};
}

// Epilogue and the single store of the (BM, BN) fp32 tile.
template <int BM, int BN>
__device__ void conv_store_tile(const float* cs, const ConvArgs& a, int m0,
                                int n0) {
  for_each_in_tile<BM, BN>(cs, a.M, a.F, m0, n0, [&](int gr, int gc, float v) {
    const long long idx = (long long)gr * a.F + gc;
    v = epilogue_apply(v, a.act, a.bias, a.bias_dt, gc, a.res, a.res_dt, idx);
    store_f(a.out, a.out_dt, idx, v);
  });
}

// bf16 / f16: a (64 pixels, 128 filters) tile on 2 x 4 warps, each owning
// a 32 x 32 slice as 2 x 2 fp32 WMMA fragments; the filter tile is the one
// kernels/mma_conv.py CONV_TILE names.
constexpr int CONV_BM = 64, CONV_BN = 128, CONV_BK = 32, CONV_WM = 2,
              CONV_WN = 4;

template <typename T>
__host__ __device__ constexpr size_t conv_wmma_smem_bytes() {
  return wmma_smem_bytes<T, CONV_BM, CONV_BN, CONV_BK>() +
         (size_t)(CONV_BM + CONV_BK) * sizeof(long long);
}

template <typename T>
__global__ void __launch_bounds__(CONV_WM* CONV_WN * 32)
    conv_wmma_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * CONV_BM, n0 = blockIdx.y * CONV_BN;
  const ConvGatherA<T> ld = conv_gather<T, CONV_BM, CONV_BK>(
      smem, wmma_smem_bytes<T, CONV_BM, CONV_BN, CONV_BK>(), a, m0);
  wmma_tile<T, CONV_BM, CONV_BN, CONV_BK, CONV_WM, CONV_WN>(
      smem, ld, reinterpret_cast<const T*>(a.w), a.K, a.F, n0, a.vec_b != 0,
      false);
  conv_store_tile<CONV_BM, CONV_BN>(reinterpret_cast<float*>(smem), a, m0, n0);
}

// F32GER: true fp32 FMAs on the CUDA cores (tile_gemm.cuh's f32_tile).
__host__ __device__ constexpr size_t conv_f32_smem_bytes() {
  return f32_smem_bytes() + (size_t)(F32_BM + F32_BK) * sizeof(long long);
}

__global__ void __launch_bounds__(256) conv_f32_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * F32_BM, n0 = blockIdx.y * F32_BN;
  const ConvGatherA<float> ld =
      conv_gather<float, F32_BM, F32_BK>(smem, f32_smem_bytes(), a, m0);
  f32_tile(smem, ld, reinterpret_cast<const float*>(a.w), a.K, a.F, n0, false);
  conv_store_tile<F32_BM, F32_BN>(reinterpret_cast<float*>(smem), a, m0, n0);
}

template <typename Kernel>
static int launch_conv(Kernel kernel, size_t smem, bool* smem_ok, int bm,
                       int bn, int threads, const ConvArgs& a,
                       cudaStream_t s) {
  cudaError_t e = allow_smem(kernel, smem, smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.M + bm - 1) / bm, (a.F + bn - 1) / bn);
  kernel<<<grid, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mma_conv2d_launch(
    const void* x, const void* w, const void* bias, const void* res,
    void* out, int in_dt, int bias_dt, int res_dt, int out_dt, int N, int H,
    int W, int C, int KH, int KW, int F, int SH, int SW, int act, int bf,
    void* stream) {
  if (N < 1 || C < 1 || F < 1 || KH < 1 || KW < 1 || SH < 1 || SW < 1 ||
      H < KH || W < KW)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = x; a.w = w; a.bias = bias; a.res = res; a.out = out;
  a.bias_dt = bias_dt; a.res_dt = res_dt; a.out_dt = out_dt;
  a.N = N; a.H = H; a.W = W; a.C = C; a.KH = KH; a.KW = KW; a.F = F;
  a.SH = SH; a.SW = SW;
  a.OH = (H - KH) / SH + 1;
  a.OW = (W - KW) / SW + 1;
  const long long m = (long long)N * a.OH * a.OW;
  const long long k = (long long)KH * KW * C;
  if (m > 0x7fffffffLL || k > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.M = (int)m;
  a.K = (int)k;
  a.act = act;
  a.vec_a = (C % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  a.vec_b = (F % 8 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int wmma_threads = CONV_WM * CONV_WN * 32;
  if (in_dt == DT_BF16 && bf == CONV_BN) {
    static bool ok = false;
    return launch_conv(conv_wmma_kernel<__nv_bfloat16>,
                       conv_wmma_smem_bytes<__nv_bfloat16>(), &ok, CONV_BM,
                       CONV_BN, wmma_threads, a, s);
  }
  if (in_dt == DT_F16 && bf == CONV_BN) {
    static bool ok = false;
    return launch_conv(conv_wmma_kernel<__half>, conv_wmma_smem_bytes<__half>(),
                       &ok, CONV_BM, CONV_BN, wmma_threads, a, s);
  }
  if (in_dt == DT_F32 && bf == F32_BN) {
    static bool ok = false;
    return launch_conv(conv_f32_kernel, conv_f32_smem_bytes(), &ok, F32_BM,
                       F32_BN, 256, a, s);
  }
  return (int)cudaErrorInvalidValue;
}
