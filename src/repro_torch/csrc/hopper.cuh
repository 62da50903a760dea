// Hopper (sm_90a) building blocks in inline PTX, shared by the TMA + wgmma
// GEMM (gemm_wgmma.cu), the flash attention (mma_attention.cu), K3's
// wgmma conv (mma_conv.cu) and the integer GEMM's wgmma forms
// (gemm_imma.cu):
// mbarriers, TMA tensor loads, wgmma shared-memory descriptors and the
// wgmma instructions themselves, and the host-side tensor-map encoder
// (cuTensorMapEncodeTiled through the runtime's driver entry point, so no
// library links -lcuda).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"


// ---------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive once and expect `bytes` of TMA transactions on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.  A phase that
// never completes (a lost transaction) traps after ~2^31 polls, seconds,
// so that the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == 0x80000000u) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Order this thread's generic-proxy writes to shared memory (st.shared,
// landed cp.async) before later async-proxy reads of it (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// TMA tensor loads (global -> shared, completion on an mbarrier); the
// hardware zero-fills every element of the box outside the tensor.
// ---------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// ---------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------

// Shared-memory matrix descriptor.  `swizzle_bytes` is the TMA swizzle
// the tile was written with (128 or 64); `lbo` / `sbo` are the leading and
// stride byte offsets of the canonical layouts:
//   K-major (the reduction dimension contiguous): rows of swizzle_bytes,
//     sbo = 8 rows (one swizzle atom), lbo unused;
//   MN-major: lbo = the stride between (swizzle_bytes / 2)-element
//     column chunks, sbo = the stride between groups of 8 k rows.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo,
                                               int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : (swizzle_bytes == 64 ? 2 : 3);
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the accumulator registers in place across an asynchronous wgmma
// (the compiler must not move or reuse them before the wait).
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void reg_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Barrier `id` (1..15) over `count` threads (a multiple of 32): the
// consumer warpgroups among themselves, without the producer.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// D (64 x N, fp32 registers) += A (64 x 16) * B (16 x N), one instruction:
//   ss<TNSPB>: A and B in shared memory (A K-major; B K-major for
//              TNSPB = 0, MN-major for TNSPB = 1);
//   rs:        A from registers, B MN-major.
// The register lists are written out: inline PTX takes no loops.
template <int N, typename T>
struct Wgmma;

#include "wgmma_ops.cuh"

// Two fp32 values rounded to a packed pair of T (the lower column in the
// low half), as torch's .to(T) rounds them.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

typedef CUresult (*CtxGetCurrentFn)(CUcontext*);

// The encoder needs a context current on the calling host thread (else
// CUDA_ERROR_INVALID_CONTEXT).  A fresh thread has none until a runtime
// call binds one, and PyTorch binds none where the thread's device is
// already the one it asks for: on the H100 the autograd engine's worker
// thread (and a fresh threading.Thread) encoded a launcher's maps before
// any call had bound the primary context, and the launch failed with
// cudaErrorInvalidValue (ROADMAP queue 3).  Bind the current device's
// primary context where none is current.  Returns 0 or a cudaError_t.
static int bind_context() {
  static const CtxGetCurrentFn get = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuCtxGetCurrent", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuCtxGetCurrent", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<CtxGetCurrentFn>(p)
               : nullptr;
  }();
  if (get == nullptr) return (int)cudaErrorNotSupported;
  CUcontext ctx = nullptr;
  if (get(&ctx) == CUDA_SUCCESS && ctx != nullptr) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  return (int)e;
}

// A tiled tensor map of a tensor of `rank` dims (innermost first) whose
// elements are `elem_bytes` wide (1: 8-bit integers, 2: 16-bit values),
// `strides` the byte pitches of dims 1..; `swizzle_bytes` 128, 64 or 0 (no
// swizzle: the box lands densely, innermost dim first).  Encoded on every
// call (an encode costs no host time that a launch's measurement can see:
// PERF.md), with a context bound first (bind_context).  Returns 0 or a
// cudaError_t.
static int tmap_tiled(CUtensorMap* out, const void* base, int elem_bytes,
                      int rank, const uint64_t* dims, const uint64_t* strides,
                      const uint32_t* box, int swizzle_bytes) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int bound = bind_context();
  if (bound) return bound;
  cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  // The element type only sets the width here: bf16, f16 and int16 move
  // alike, as do int8 and uint8.
  const CUtensorMapDataType dt = elem_bytes == 1
                                     ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUresult r = fn(out, dt, rank, const_cast<void*>(base), dims, strides, box,
                  elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  return 0;
}

// A tiled tensor map of a 16-bit tensor (tmap_tiled), swizzled 128 or 64.
static int tmap_16bit(CUtensorMap* out, const void* base, int rank,
                      const uint64_t* dims, const uint64_t* strides,
                      const uint32_t* box, int swizzle_bytes) {
  return tmap_tiled(out, base, 2, rank, dims, strides, box,
                    swizzle_bytes == 128 ? 128 : 64);
}
