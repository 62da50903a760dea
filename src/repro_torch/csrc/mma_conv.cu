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
// in no order, so nothing carries over: each thread owns whole sums in
// registers for one output pixel.  core/tiling.py's depthwise_plan picks
// one of two paths up front and passes it in as vec:
//   * vector (depthwise_vec_kernel): a thread owns 16 bytes of channels
//     (VEC = 4 f32 or 8 bf16/f16; channel vectors fastest across the
//     warp, so a warp reads 512 contiguous bytes).  Per tap it loads its
//     tap vector and input vector with 16-byte loads; L2 serves the
//     KW-fold re-reads of an input vector by the neighbouring pixels'
//     threads.  The bias is loaded beside the taps.  Index math is 32-bit
//     and runs once per thread (the launcher guards the range); outputs
//     go out as 16-byte (f32) or 8/16-byte (16-bit) vector stores.
//   * scalar (depthwise_conv_kernel): one output element a thread, for a
//     C that VEC does not divide or a base that is not 16-byte aligned.
// Blocks are small (DW_BLOCK = 64 threads), so that a decode conv's 4224
// threads span 66 SMs.  Both paths round every product and every sum on
// its own, in the plain version's order (ref.depthwise_conv: for i, for
// j, acc += x * w), never contracted into an FMA, so the two paths and the
// plain version agree bit for bit.  The epilogue applies once, in fp32,
// and each output element is stored exactly once in the output dtype.

#include "tile_gemm.cuh"
#include "wgmma_tile.cuh"

struct DwArgs {
  const void* x;
  const void* w;
  const void* bias;
  const void* res;
  void* out;
  int bias_dt, res_dt, out_dt;
  int N, H, W, C, KH, KW, SH, SW, OH, OW;
  int act;
  int threads;  // threads with work; the last block's others return
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

// 16 bytes at p (16-byte aligned) as fp32: 4 f32 or 8 bf16/f16 values.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T* h = reinterpret_cast<const T*>(&w[i]);
    v[2 * i] = to_f<T>(h[0]);
    v[2 * i + 1] = to_f<T>(h[1]);
  }
}

// V consecutive outputs at element idx (V-aligned, 16-byte base) in the
// output dtype: 16-byte stores for f32, 8 (V = 4) or 16 (V = 8) for 16-bit.
template <int V>
__device__ __forceinline__ void store_vec(void* p, int dt, int idx,
                                          const float (&v)[V]) {
  if (dt == DT_F32) {
    float* q = reinterpret_cast<float*>(p) + idx;
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(q + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    return;
  }
  uint32_t w[V / 2];
#pragma unroll
  for (int i = 0; i < V / 2; ++i)
    w[i] = dt == DT_BF16 ? pack2<__nv_bfloat16>(v[2 * i], v[2 * i + 1])
                         : pack2<__half>(v[2 * i], v[2 * i + 1]);
  uint16_t* q = reinterpret_cast<uint16_t*>(p) + idx;
  if constexpr (V == 4)
    *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint4*>(q) = make_uint4(w[0], w[1], w[2], w[3]);
}

constexpr int DW_BLOCK = 64;  // threads a block, both paths

template <typename T>
__global__ void __launch_bounds__(DW_BLOCK) depthwise_vec_kernel(DwArgs a) {
  constexpr int V = 16 / sizeof(T);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.threads) return;
  const int cvs = a.C / V;
  const int u = t / cvs, c0 = (t - u * cvs) * V;  // u: (n * OH + oh) * OW + ow
  const int row = u / a.OW, ow = u - row * a.OW;
  const int n = row / a.OH, oh = row - n * a.OH;
  const T* x = reinterpret_cast<const T*>(a.x) + c0;
  const T* w = reinterpret_cast<const T*>(a.w) + c0;
  float bias[V];  // loaded here, off the epilogue's critical path
#pragma unroll
  for (int q = 0; q < V; ++q)
    bias[q] = a.bias ? load_f(a.bias, a.bias_dt, c0 + q) : 0.f;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int i = 0; i < a.KH; ++i) {
    const T* xr = x + ((n * a.H + oh * a.SH + i) * a.W + ow * a.SW) * a.C;
    const T* wr = w + i * a.KW * a.C;
    for (int j = 0; j < a.KW; ++j) {
      float tap[V], xv[V];
      load_vec(wr + j * a.C, tap);
      load_vec(xr + j * a.C, xv);
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] = __fadd_rn(acc[v], __fmul_rn(xv[v], tap[v]));
    }
  }
  const int idx = u * a.C + c0;
  float v[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {  // epilogue_apply's order
    v[q] = act_apply(a.bias ? acc[q] + bias[q] : acc[q], a.act);
    if (a.res) v[q] += load_f(a.res, a.res_dt, idx + q);
  }
  store_vec<V>(a.out, a.out_dt, idx, v);
}

template <typename T>
__global__ void __launch_bounds__(DW_BLOCK) depthwise_conv_kernel(DwArgs a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.threads) return;
  int r = e / a.C;
  const int c = e - r * a.C;
  const int ow = r % a.OW;
  r /= a.OW;
  const int oh = r % a.OH, n = r / a.OH;
  const T* x = reinterpret_cast<const T*>(a.x) + c;
  const T* w = reinterpret_cast<const T*>(a.w) + c;
  float acc = 0.f;
  for (int i = 0; i < a.KH; ++i) {
    const T* xr = x + ((n * a.H + oh * a.SH + i) * a.W + ow * a.SW) * a.C;
    const T* wr = w + i * a.KW * a.C;
    for (int j = 0; j < a.KW; ++j)
      acc = __fadd_rn(acc, __fmul_rn(to_f<T>(xr[j * a.C]),
                                     to_f<T>(wr[j * a.C])));
  }
  store_f(a.out, a.out_dt, e,
          epilogue_apply(acc, a.act, a.bias, a.bias_dt, c, a.res, a.res_dt,
                         e));
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// vec 0: the scalar path; else vec must be 16 / sizeof(T).
template <typename T>
static int launch_depthwise(DwArgs a, int vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  long long threads = (long long)a.N * a.OH * a.OW * a.C;
  if (vec != 0) {
    if (vec != V || a.C % V || !aligned16(a.x) || !aligned16(a.w) ||
        !aligned16(a.out))
      return (int)cudaErrorInvalidValue;
    threads /= V;
  }
  a.threads = (int)threads;
  const int blocks = (int)((threads + DW_BLOCK - 1) / DW_BLOCK);
  if (vec == 0)
    depthwise_conv_kernel<T><<<blocks, DW_BLOCK, 0, s>>>(a);
  else
    depthwise_vec_kernel<T><<<blocks, DW_BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mma_depthwise_conv_launch(
    const void* x, const void* w, const void* bias, const void* res,
    void* out, int in_dt, int bias_dt, int res_dt, int out_dt, int N, int H,
    int W, int C, int KH, int KW, int SH, int SW, int act, int vec,
    void* stream) {
  if (N < 1 || C < 1 || KH < 1 || KW < 1 || SH < 1 || SW < 1 || H < KH ||
      W < KW)
    return (int)cudaErrorInvalidValue;
  DwArgs a;
  a.x = x; a.w = w; a.bias = bias; a.res = res; a.out = out;
  a.bias_dt = bias_dt; a.res_dt = res_dt; a.out_dt = out_dt;
  a.N = N; a.H = H; a.W = W; a.C = C; a.KH = KH; a.KW = KW;
  a.SH = SH; a.SW = SW;
  a.OH = (H - KH) / SH + 1;
  a.OW = (W - KW) / SW + 1;
  a.act = act;
  // 32-bit index math: every element offset of the image and the output
  if ((long long)N * H * W * C > 0x7fffffffLL ||
      (long long)KH * KW * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_F32) return launch_depthwise<float>(a, vec, s);
  if (in_dt == DT_BF16)
    return launch_depthwise<__nv_bfloat16>(a, vec, s);
  if (in_dt == DT_F16) return launch_depthwise<__half>(a, vec, s);
  return (int)cudaErrorInvalidValue;
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
// cores (0.021 ms at 989 TFLOP/s), which only wgmma reaches; conv1 (K 240)
// and the patch embed (K 588) do ~10-350 flops a byte and sit near the
// knee, bound by device memory or operations by a few per cent either
// way.
//
// Design.  The TPU kernel walked KH as an in-order grid axis with an
// (OW, bf) accumulator resident in VMEM, and folded KW*C per step into one
// MXU dot where the panel was lane-aligned.  Neither carries over: here
// one thread block owns one (BM pixels, BN filters) output tile and runs
// the whole flattened K loop itself, with K in the filter's own order
// (i, j, c), so the B panel is a plain (BK, BN) window of the (K, F) view
// of the filter bank.  The A panel is read from the image on the fly and
// the patch matrix never exists in memory: each tile row's pixel
// offset ((n*H + oh*SH)*W + ow*SW)*C is computed once per tile into shared
// memory, and a K column's offset is i*W*C + (j*C + c), so element (m, k)
// is x[row[m] + col[k]].  For a fixed i the (j, c) run is contiguous in
// the image.  core/tiling.py's choose_conv_path picks one of three kernels:
//   * conv_wgmma_kernel (bf16/f16, F % 8 == 0, 16-byte filter base, an
//     image gathered in 16- or 4-byte copies: every stem of the main
//     path).  wgmma_tile.cuh's (128, BN) tile, BN = 128
//     or 256, with its consumers and staged epilogue; only the producer
//     warpgroup is K3's own.  Its 4 warps take the K steps in turn.  For
//     its step a warp loads the B panel as TMA boxes of the (K, F) filter
//     view (zero past K and F).  The A panel comes one of two ways, in
//     the 128-byte swizzled K-major layout wgmma reads (chunk c of row r
//     at c ^ r % 8), zero past M and K (K = 588 and 240 are no multiple
//     of 64):
//       - by TMA, where the tile's rows are pixels of one image of a 1-D
//         conv (H = KH = 1, whisper's stems) whose pixel pitch is 16-byte:
//         its patch rows are a (K, OW, N) tensor whose row pitch SW*C is
//         below K (rows overlap), which a tensor map describes as is;
//       - gathered by the warp with cp.async everywhere else (tiles across
//         an image boundary, 2-D convs): 16 bytes a copy where C % 8 == 0,
//         4-byte pairs where the (j, c) runs and offsets are even
//         (qwen2-vl's C = 3: runs of 42).  An image neither copy can
//         gather goes to the WMMA kernel (choose_conv_path).
//         cp.async writes through the generic proxy and wgmma reads
//         through the async one, so a warp releases its stage only after
//         its copies have landed (cp.async.wait_group) and each lane has
//         run fence.proxy.async.
//     The gather is the slower way: whisper's conv2 takes 0.069 ms with
//     TMA and 0.125 ms recast as a 2-D conv that gathers (H100 80GB HBM3,
//     700 W; PERF.md).
//     Prepacked filters (K3's packed stream: repro/kernels/mma_conv.py's
//     w_layout): through mma_conv2d_packed_launch the filter bank arrives
//     as core/packing.py's
//     (gf, KH, KW, C, 64) stream, zero-padded past F, read as a 3-D map
//     [64, K, gf] with box [64, 64, 1] at (0, k0, n0 / 64 + p): each box
//     is 64 K rows of one contiguous 64-filter slab, and lands as the same
//     swizzled bytes as the natural (K, F) box, so the result is the
//     natural launch's bit for bit.
//   * conv_wmma_kernel (what wgmma does not take, or an explicit filter
//     tile): a (64, 128) tile on tile_gemm.cuh's 16-bit tensor-core loop
//     (a 4-stage cp.async ring into ldmatrix and mma.sync m16n8k16, one
//     barrier a K step), shared with K1's mma_gemm.cu, fed by
//     ConvGatherA's cp.async gathers (16 bytes or 4-byte pairs, as the
//     wgmma producer's; elements where neither copy can gather).
//   * conv_f32_kernel (F32GER): tile_gemm.cuh's fp32 SIMT tile
//     (f32_simt_tile, K1's F32GER tile: 128 x 128 or 64 x 64, picked
//     wave by wave by core/tiling.py's f32_conv_tile on M = N*OH*OW by
//     F; 8 x 8
//     or 4 x 4 fp32 FMAs a thread, two stages, the next one's chunks in
//     flight under the FMAs), fed by ConvGatherA::chunk4: 16-byte loads
//     where C % 4 == 0 at a 16-byte base (whisper's stems), else four
//     element loads (qwen2-vl's C = 3).  Each output is one fmaf chain in
//     ascending k from +0.0, as before this tile, so either tile gives
//     the same bits.
//     Both read packed filters too (their PACKED instances, through
//     mma_conv2d_packed_launch): tile_gemm.cuh's PackedB takes the (gf, K,
//     64) stream as 64-filter slabs of K rows, so the WMMA tile's 128
//     filters are two slabs and the fp32 tile's 128 or 64 two or one,
//     each chunk one 16-byte load, zero past K and F as the natural
//     loader stages it: the result is the natural launch's bit for bit.
// Each applies the epilogue once in fp32 and stores each output element
// once, in the output dtype.

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
  int vec_a, vec_b;  // 16-byte gathers (16 bytes of channels divide C) /
                     // filter rows (16 bytes of filters divide F)
  int gather;        // bytes per copy of the A gather (16 or 4; 0: the
                     // wgmma producer cannot gather this image, the WMMA
                     // tile gathers it element by element)
  int a_tma;         // a 1-D conv whose A rows TMA can read
};

// Image offset of K column k = (i*KW + j)*C + c: i*W*C + (j*C + c); -1
// past K.
__device__ __forceinline__ long long conv_col(int k, int K, int kwc,
                                              long long wc) {
  if (k >= K) return -1;
  const int i = k / kwc;
  return i * wc + (k - i * kwc);
}

// conv_col of the N columns k, k + STEP, ... (STEP divides every (j, c)
// run): one division, then each column the next of its filter row or
// the first of the next.
template <int N, int STEP>
__device__ __forceinline__ void conv_cols(long long* cl, int k, int K,
                                          int kwc, long long wc) {
  int i = k / kwc, r = k - i * kwc;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    cl[e] = k + STEP * e < K ? i * wc + r : -1;
    r += STEP;
    if (r == kwc) {
      r = 0;
      ++i;
    }
  }
}

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

// The 16-bit tile's copies of K3's A panel (ConvGatherA::copies): chunk
// j's pixel offset row[j] (-1 past M) read once a tile, the K step's
// column offsets worked out in registers with one division (one a chunk
// column for 16-byte gathers, one a pair for 4-byte ones, one an element
// otherwise: every chunk of a thread lies in one column).
template <typename T, int NT, int BM, int BK, int LDA>
struct ConvCopies {
  using C = Chunks<NT, BM, BK>;
  const T* x;
  long long row[C::PER];
  long long wc;
  int kwc, K, gather;

  __device__ void issue(T* as, int t) {
    const int k = t * BK + C::col();
    if (gather == 16) {
      const long long cl = conv_col(k, K, kwc, wc);
#pragma unroll
      for (int j = 0; j < C::PER; ++j) {
        const bool in = row[j] >= 0 && cl >= 0;
        cp_async16_upto(as + C::row(j) * LDA + C::col(), x + row[j] + cl,
                        in ? 16 : 0);
      }
    } else if (gather == 4) {
      long long cl[4];
      conv_cols<4, 2>(cl, k, K, kwc, wc);
#pragma unroll
      for (int j = 0; j < C::PER; ++j)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const bool in = row[j] >= 0 && cl[p] >= 0;
          cp_async4_upto(as + C::row(j) * LDA + C::col() + 2 * p,
                         x + row[j] + cl[p], in ? 4 : 0);
        }
    } else {
      long long cl[8];
      conv_cols<8, 1>(cl, k, K, kwc, wc);
#pragma unroll
      for (int j = 0; j < C::PER; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          as[C::row(j) * LDA + C::col() + e] =
              row[j] >= 0 && cl[e] >= 0 ? x[row[j] + cl[e]] : zero_of<T>();
    }
  }

  __device__ void land(T*, int) {}
};

// K3's A loader for tile_gemm.cuh: the panel gathered from the image.
// rows[r] is tile row r's pixel offset (-1 past M, in shared memory); the
// offset of K column k = (i*KW + j)*C + c is conv_col's i*W*C + (j*C + c)
// (-1 past K), computed in registers, so element (r, kk) of the K step at
// k0 is x[rows[r] + conv_col(k0 + kk)].  The 16-bit tile's stages are
// gathered with cp.async as the wgmma producer gathers them
// (conv_gather_panel): 16 bytes a copy where C % 8 == 0 at a 16-byte base
// (an 8-column chunk is then one contiguous run, all in range or all
// out), 4-byte pairs where every (j, c) run, row pitch and pixel step is
// even at a 4-byte base (core/tiling.py's conv_gather_bytes), else
// element by element through registers.
template <typename T>
struct ConvGatherA {
  const T* x;
  const long long* rows;
  long long wc;  // W * C: one image row
  int kwc, K;    // KW * C: one filter row; KH * KW * C
  int gather;    // bytes a copy: 16, 4, or 0 (elements)

  __device__ __forceinline__ long long col(int k) const {
    return conv_col(k, K, kwc, wc);
  }

  template <int NT, int BM, int BK, int LDA>
  __device__ ConvCopies<T, NT, BM, BK, LDA> copies() const {
    using C = Chunks<NT, BM, BK>;
    ConvCopies<T, NT, BM, BK, LDA> c;
    c.x = x;
#pragma unroll
    for (int j = 0; j < C::PER; ++j) c.row[j] = rows[C::row(j)];
    c.wc = wc;
    c.kwc = kwc;
    c.K = K;
    c.gather = gather;
    return c;
  }

  // The fp32 SIMT tile's chunk (T = float): the four image values of tile
  // row r at K columns k .. k + 3 (k a multiple of 4), zero past M and K.
  // With 16-byte gathers (C % 4 == 0 at a 16-byte base) the four lie in
  // one pixel's channel run at a 16-byte address, all in K or all past
  // it: one load.  Else four element loads, each the next column of its
  // filter row or the first of the next (one division, as conv_cols).
  __device__ __forceinline__ float4 chunk4(int r, int k) const {
    const long long row = rows[r];
    if (row < 0 || k >= K) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* p = x + row;
    int i = k / kwc, j = k - i * kwc;
    if (gather == 16)
      return __ldg(reinterpret_cast<const float4*>(p + i * wc + j));
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = k + e < K ? __ldg(p + i * wc + j) : 0.f;
      if (++j == kwc) {
        j = 0;
        ++i;
      }
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Row offsets for the tile, then the A loader over them; the offsets live
// after the tile's panels in shared memory.
template <typename T, int BM>
__device__ ConvGatherA<T> conv_gather(unsigned char* smem, size_t panels,
                                      const ConvArgs& a, int m0) {
  long long* rows = reinterpret_cast<long long*>(smem + panels);
  conv_row_offsets<BM>(rows, a, m0);
  __syncthreads();  // every thread reads every row's offset
  return ConvGatherA<T>{reinterpret_cast<const T*>(a.x), rows,
                        (long long)a.W * a.C, a.KW * a.C, a.K, a.gather};
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
// a 32 x 32 slice of m16n8 fp32 fragments; the filter tile is the one
// kernels/mma_conv.py CONV_TILE names.
constexpr int CONV_BM = 64, CONV_BN = 128, CONV_BK = 32, CONV_WM = 2,
              CONV_WN = 4;

template <typename T>
__host__ __device__ constexpr size_t conv_wmma_smem_bytes() {
  return wmma_smem_bytes<T, CONV_BM, CONV_BN, CONV_BK>() +
         (size_t)CONV_BM * sizeof(long long);
}

// The packed filter stream as tile_gemm.cuh's B: slabs of K rows of 64
// filters.
template <typename T>
__device__ PackedB<T> conv_packed_b(const ConvArgs& a, int n0) {
  return PackedB<T>{reinterpret_cast<const T*>(a.w), a.K, a.F, n0,
                    (long long)a.K * PANEL_COLS};
}

template <typename T, bool PACKED>
__global__ void __launch_bounds__(CONV_WM* CONV_WN * 32, 2)
    conv_wmma_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * CONV_BM, n0 = blockIdx.y * CONV_BN;
  const ConvGatherA<T> ld = conv_gather<T, CONV_BM>(
      smem, wmma_smem_bytes<T, CONV_BM, CONV_BN, CONV_BK>(), a, m0);
  if constexpr (PACKED)
    wmma_tile_ab<T, CONV_BM, CONV_BN, CONV_BK, CONV_WM, CONV_WN>(
        smem, ld, conv_packed_b<T>(a, n0), a.K, false);
  else
    wmma_tile<T, CONV_BM, CONV_BN, CONV_BK, CONV_WM, CONV_WN>(
        smem, ld, reinterpret_cast<const T*>(a.w), a.K, a.F, n0, false);
  conv_store_tile<CONV_BM, CONV_BN>(reinterpret_cast<float*>(smem), a, m0, n0);
}

// F32GER: true fp32 FMAs on the CUDA cores (tile_gemm.cuh's f32_simt_tile),
// a (BM, BN) tile of 128 x 128 or 64 x 64, two blocks an SM (128
// registers a thread), as K1's gemm_f32_kernel.
template <int BM, int BN>
__host__ __device__ constexpr size_t conv_f32_smem_bytes() {
  return f32_simt_smem_bytes<BM, BN>() + (size_t)BM * sizeof(long long);
}

template <bool PACKED, int BM, int BN>
__global__ void __launch_bounds__(F32S_THREADS, 2)
    conv_f32_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const ConvGatherA<float> ld =
      conv_gather<float, BM>(smem, f32_simt_smem_bytes<BM, BN>(), a, m0);
  if constexpr (PACKED)
    f32_simt_tile<BM, BN>(smem, ld, conv_packed_b<float>(a, n0), a.K, false);
  else
    f32_simt_tile<BM, BN>(
        smem, ld,
        RowMajorB<float>{reinterpret_cast<const float*>(a.w), a.K, a.F, n0,
                         a.vec_b != 0},
        a.K, false);
  conv_store_tile<BM, BN>(reinterpret_cast<float*>(smem), a, m0, n0);
}

// ---- the wgmma kernel ----


// Byte b (< 128) of tile row r's K slice in the 128-byte swizzled K-major
// layout (TMA's SWIZZLE_128B; wgmma_desc(..., 128) reads it): 16-byte
// chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ int swz128(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// A warp gathers a K step's A panel (rows[] holds each tile row's pixel
// offset, -1 past M), zero-filled past M and K:
//   16 bytes: 8 lanes a row, each an 8-column chunk, 4 rows a pass;
//   4 bytes:  a warp a row, each lane a column pair.
template <typename T>
__device__ __forceinline__ void conv_gather_panel(unsigned char* as,
                                                  const long long* rows,
                                                  const ConvArgs& a, int k0,
                                                  int lane) {
  const int kwc = a.KW * a.C;
  const long long wc = (long long)a.W * a.C;
  const T* x = reinterpret_cast<const T*>(a.x);
  if (a.gather == 16) {
    const int part = lane % 8;
    const long long col = conv_col(k0 + 8 * part, a.K, kwc, wc);
#pragma unroll 8
    for (int r = lane / 8; r < WG_BM; r += 4) {
      const long long row = rows[r];
      const bool in = row >= 0 && col >= 0;
      cp_async16(as + swz128(r, 16 * part), in ? x + row + col : x, in);
    }
  } else {
    const long long col = conv_col(k0 + 2 * lane, a.K, kwc, wc);
#pragma unroll 8
    for (int r = 0; r < WG_BM; ++r) {
      const long long row = rows[r];
      const bool in = row >= 0 && col >= 0;
      cp_async4(as + swz128(r, 4 * lane), in ? x + row + col : x, in);
    }
  }
}

// The producer warpgroup (threads 0-127).  Its 4 warps take the K steps
// in turn: warp w fills stages it = w, w + 4, ..., each whole.  Lane 0
// expects and issues the step's B boxes, and the A box too where the tile
// is image img's pixels ow0.. of a 1-D conv (img >= 0: the launcher's map
// of its patch rows); else the
// warp gathers the A panel.  Once the step's copies have landed
// (cp.async.wait_group 0) and every lane has run its fence, so that the
// gathered bytes are visible to wgmma's async proxy, lane 0 arrives on
// full[s]: each warp keeps one step in flight, the four warps four.
template <typename T, int BN, bool PACKED>
__device__ __forceinline__ void conv_produce(unsigned char* smem,
                                             uint64_t* full, uint64_t* empty,
                                             const long long* rows,
                                             const CUtensorMap* tma,
                                             const CUtensorMap* tmb,
                                             const ConvArgs& a, int img,
                                             int ow0, int n0, int kiters) {
  using Cfg = WgCfg<BN, WG_CONV_STAGES>;
  constexpr int STAGES = Cfg::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int it = warp; it < kiters; it += 4) {
    const int s = it % STAGES, k0 = it * WG_BK;
    if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
    unsigned char* as = smem + s * Cfg::STAGE;
    if (lane == 0) {
      mbar_expect_tx(&full[s], Cfg::B_BYTES + (img >= 0 ? Cfg::A_BYTES : 0));
      if (img >= 0) tma_load_3d(as, tma, &full[s], k0, ow0, img);
#pragma unroll
      for (int p = 0; p < BN / 64; ++p) {
        if (PACKED)
          tma_load_3d(as + Cfg::A_BYTES + p * 64 * 128, tmb, &full[s], 0, k0,
                      n0 / 64 + p);
        else
          tma_load_2d(as + Cfg::A_BYTES + p * 64 * 128, tmb, &full[s],
                      n0 + 64 * p, k0);
      }
    }
    if (img < 0) conv_gather_panel<T>(as, rows, a, k0, lane);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[s]);
  }
}

template <int BN>
__host__ __device__ constexpr size_t conv_wgmma_smem_bytes() {
  return WgCfg<BN, WG_CONV_STAGES>::smem + WG_BM * sizeof(long long);
}

template <typename T, int BN, bool PACKED>
__global__ void __launch_bounds__(WG_THREADS, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap tma,
                      const __grid_constant__ CUtensorMap tmb, ConvArgs a,
                      GemmEpi e) {
  using Cfg = WgCfg<BN, WG_CONV_STAGES>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Cfg::STAGE);
  uint64_t* empty = full + STAGES;
  long long* rows = reinterpret_cast<long long*>(empty + STAGES);

  int m0, n0;
  wg_tile_origin<BN>(blockIdx.x, a.M, a.F, m0, n0);
  const int kiters = (a.K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 2);  // the warp's arrival and the TMA's
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  conv_row_offsets<WG_BM>(rows, a, m0);
  // A by TMA where the tile's rows are pixels of one image
  const int img = m0 / a.OW, ow0 = m0 - img * a.OW;
  const bool one_image = (min(m0 + WG_BM, a.M) - 1) / a.OW == img;
  __syncthreads();

  // 48 registers for the producer (its gather spills at 40), 224 for the
  // consumers: 128 * 48 + 256 * 224 fits the 384 * 168 the block holds.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<48>();
    conv_produce<T, BN, PACKED>(smem, full, empty, rows, &tma, &tmb, a,
                        a.a_tma && one_image ? img : -1, ow0, n0, kiters);
  } else {
    setmaxnreg_inc<224>();
    wg_consume<T, BN, Cfg>(smem, full, empty, kiters, e, 0, m0, n0);
  }
}

template <typename T, int BN>
static int launch_conv_wgmma(const ConvArgs& a, const GemmEpi& e,
                             bool w_packed, cudaStream_t s) {
  CUtensorMap tb;
  int rc;
  if (w_packed) {  // the (gf, K, 64) packed slabs
    const uint64_t gf = ((uint64_t)a.F + 63) / 64;
    const uint64_t dims[3] = {64, (uint64_t)a.K, gf};
    const uint64_t pitch[2] = {64 * 2, (uint64_t)a.K * 64 * 2};
    const uint32_t box[3] = {64, 64, 1};
    rc = tmap_16bit(&tb, a.w, 3, dims, pitch, box, 128);
  } else {  // the (K, F) row-major view of the filter bank
    const uint64_t dims[2] = {(uint64_t)a.F, (uint64_t)a.K};
    const uint64_t pitch[1] = {(uint64_t)a.F * 2};
    const uint32_t box[2] = {64, 64};
    rc = tmap_16bit(&tb, a.w, 2, dims, pitch, box, 128);
  }
  if (rc) return rc;
  // A 1-D conv's patch rows, (K, OW, N): row ow of image n starts at
  // pixel ow * SW and runs K = KW * C elements on; rows overlap where
  // KW > SW.
  CUtensorMap ta = {};
  if (a.a_tma) {
    const uint64_t adims[3] = {(uint64_t)a.K, (uint64_t)a.OW, (uint64_t)a.N};
    const uint64_t astr[2] = {(uint64_t)a.SW * a.C * 2,
                              (uint64_t)a.W * a.C * 2};
    const uint32_t abox[3] = {64, WG_BM, 1};
    rc = tmap_16bit(&ta, a.x, 3, adims, astr, abox, 128);
    if (rc) return rc;
  }
  const long long tiles = (long long)((a.M + WG_BM - 1) / WG_BM) *
                          ((a.F + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = conv_wgmma_smem_bytes<BN>();
  if (w_packed) {
    static bool ok = false;
    auto kernel = conv_wgmma_kernel<T, BN, true>;
    cudaError_t err = allow_smem(kernel, smem, &ok);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)tiles, WG_THREADS, smem, s>>>(ta, tb, a, e);
  } else {
    static bool ok = false;
    auto kernel = conv_wgmma_kernel<T, BN, false>;
    cudaError_t err = allow_smem(kernel, smem, &ok);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)tiles, WG_THREADS, smem, s>>>(ta, tb, a, e);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_conv_wgmma_t(const ConvArgs& a, const GemmEpi& e, int bn,
                               bool w_packed, cudaStream_t s) {
  if (bn == 128) return launch_conv_wgmma<T, 128>(a, e, w_packed, s);
  if (bn == 256) return launch_conv_wgmma<T, 256>(a, e, w_packed, s);
  return (int)cudaErrorInvalidValue;
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

// path: CONV_PATH_* (core/tiling.py, choose_conv_path); bn: the filter
// tile, which must be one the path is compiled for.
enum { CONV_PATH_WMMA = 0, CONV_PATH_F32 = 1, CONV_PATH_WGMMA = 2 };

// The WMMA and fp32 tiles, on natural or packed filters.
template <bool PACKED>
static int launch_conv_tile(const ConvArgs& a, int path, int in_dt, int bn,
                            cudaStream_t s) {
  const int wmma_threads = CONV_WM * CONV_WN * 32;
  if (path == CONV_PATH_WMMA && in_dt == DT_BF16 && bn == CONV_BN) {
    static bool ok = false;
    return launch_conv(conv_wmma_kernel<__nv_bfloat16, PACKED>,
                       conv_wmma_smem_bytes<__nv_bfloat16>(), &ok, CONV_BM,
                       CONV_BN, wmma_threads, a, s);
  }
  if (path == CONV_PATH_WMMA && in_dt == DT_F16 && bn == CONV_BN) {
    static bool ok = false;
    return launch_conv(conv_wmma_kernel<__half, PACKED>,
                       conv_wmma_smem_bytes<__half>(), &ok, CONV_BM, CONV_BN,
                       wmma_threads, a, s);
  }
  // the fp32 tiles of core/tiling.py's GEMM_TILES[F32GER], by filter tile
  if (path == CONV_PATH_F32 && in_dt == DT_F32 && bn == 128) {
    static bool ok = false;
    return launch_conv(conv_f32_kernel<PACKED, 128, 128>,
                       conv_f32_smem_bytes<128, 128>(), &ok, 128, 128,
                       F32S_THREADS, a, s);
  }
  if (path == CONV_PATH_F32 && in_dt == DT_F32 && bn == 64) {
    static bool ok = false;
    return launch_conv(conv_f32_kernel<PACKED, 64, 64>,
                       conv_f32_smem_bytes<64, 64>(), &ok, 64, 64,
                       F32S_THREADS, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

static int conv2d_launch(
    const void* x, const void* w, const void* bias, const void* res,
    void* out, int in_dt, int bias_dt, int res_dt, int out_dt, int N, int H,
    int W, int C, int KH, int KW, int F, int SH, int SW, int act, int path,
    int bn, void* stream, int w_packed) {
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
  const uintptr_t xb = reinterpret_cast<uintptr_t>(x);
  const int vec = in_dt == DT_F32 ? 4 : 8;  // elements in 16 bytes
  a.vec_a = (C % vec == 0) && ((xb & 15) == 0);
  a.vec_b = (F % vec == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  // packed filters: 16-byte aligned slab rows of 64 filters, any F
  if (w_packed && (reinterpret_cast<uintptr_t>(w) & 15))
    return (int)cudaErrorInvalidValue;
  if (w_packed) a.vec_b = 1;
  // 4-byte pairs need every (j, c) run, row pitch and pixel step even
  // (core/tiling.py, conv_gather_bytes)
  a.gather = a.vec_a ? 16
             : ((KW * C) % 2 == 0 && ((long long)W * C) % 2 == 0 &&
                (SW * C) % 2 == 0 && (xb & 3) == 0)
                 ? 4
                 : 0;
  // TMA reads a 1-D conv's patch rows where its pitches are 16-byte
  a.a_tma = H == 1 && KH == 1 && (xb & 15) == 0 && (SW * C) % 8 == 0 &&
            ((long long)W * C) % 8 == 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (path == CONV_PATH_WGMMA) {
    if (!a.vec_b || !a.gather || (in_dt != DT_BF16 && in_dt != DT_F16))
      return (int)cudaErrorInvalidValue;  // TMA: 16-byte base and pitch
    GemmEpi e;
    e.c = nullptr; e.bias = bias; e.res = res; e.out = out;
    e.c_dt = 0; e.bias_dt = bias_dt; e.res_dt = res_dt; e.out_dt = out_dt;
    e.M = a.M; e.N = F;
    e.alpha = 1.f; e.beta = 0.f;
    e.neg_product = 0; e.neg_acc = 0; e.act = act;
    e.vec8 = 1;
    for (const void* p : {bias, res, (const void*)out})
      if (reinterpret_cast<uintptr_t>(p) & 15) e.vec8 = 0;
    if (in_dt == DT_BF16)
      return launch_conv_wgmma_t<__nv_bfloat16>(a, e, bn, w_packed != 0, s);
    return launch_conv_wgmma_t<__half>(a, e, bn, w_packed != 0, s);
  }
  return w_packed ? launch_conv_tile<true>(a, path, in_dt, bn, s)
                  : launch_conv_tile<false>(a, path, in_dt, bn, s);
}

// K3's launchers, one argument list: the filter bank as natural (KH, KW,
// C, F), or as core/packing.py's (gf, KH, KW, C, 64) stream.
extern "C" int mma_conv2d_launch(
    const void* x, const void* w, const void* bias, const void* res,
    void* out, int in_dt, int bias_dt, int res_dt, int out_dt, int N, int H,
    int W, int C, int KH, int KW, int F, int SH, int SW, int act, int path,
    int bn, void* stream) {
  return conv2d_launch(x, w, bias, res, out, in_dt, bias_dt, res_dt, out_dt,
                       N, H, W, C, KH, KW, F, SH, SW, act, path, bn, stream,
                       0);
}

extern "C" int mma_conv2d_packed_launch(
    const void* x, const void* w, const void* bias, const void* res,
    void* out, int in_dt, int bias_dt, int res_dt, int out_dt, int N, int H,
    int W, int C, int KH, int KW, int F, int SH, int SW, int act, int path,
    int bn, void* stream) {
  return conv2d_launch(x, w, bias, res, out, in_dt, bias_dt, res_dt, out_dt,
                       N, H, W, C, KH, KW, F, SH, SW, act, path, bn, stream,
                       1);
}
