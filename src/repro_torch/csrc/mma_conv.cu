// Depthwise (groups == C) VALID strided convolution for Hopper (sm_90a).
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

#include "common.cuh"

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
