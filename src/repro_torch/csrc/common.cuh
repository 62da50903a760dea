// Shared helpers of the port's CUDA kernels: runtime dtype codes for the
// operands that are touched once per element (seed, bias, residual, out),
// the fused epilogue, and the error-string export the ctypes wrappers use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes (kernels/mma_gemm.py, kernels/mma_attention.py: DTYPE_CODES);
// int32 and f64 only where an integer or F64GER accumulator is stored
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2, DT_I32 = 3, DT_F64 = 4 };
// activation codes (kernels/epilogue.py: ACT_CODES)
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

#define REPRO_NEG_INF (-1e30f)

// A generic pointer into shared memory as the 32-bit shared address that
// cp.async, ldmatrix, mbarrier, TMA and wgmma take.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes (cached in L2 only) or 4 bytes into shared
// memory; `in` false zero-fills the destination and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float load_f(const void* p, int dt, long long i) {
  if (dt == DT_BF16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == DT_F16) return __half2float(reinterpret_cast<const __half*>(p)[i]);
  return reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f(void* p, int dt, long long i, float v) {
  if (dt == DT_BF16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);  // RNE
  else if (dt == DT_F16)
    reinterpret_cast<__half*>(p)[i] = __float2half(v);              // RNE
  else
    reinterpret_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float act_apply(float v, int act) {
  if (act == ACT_RELU) {
    v = fmaxf(v, 0.f);
  } else if (act == ACT_SILU) {
    v = v / (1.f + expf(-v));
  } else if (act == ACT_GELU) {
    v = v * (0.5f * (1.f + erff(v * 0.7071067811865476f)));  // exact erf
  }
  return v;
}

// store(cast(residual + act(bias + v))), in fp32: kernels/epilogue.py's
// contract, evaluated per element of the resident accumulator tile.
__device__ __forceinline__ float epilogue_apply(float v, int act,
                                                const void* bias, int bias_dt,
                                                long long bias_idx,
                                                const void* res, int res_dt,
                                                long long res_idx) {
  if (bias) v += load_f(bias, bias_dt, bias_idx);
  v = act_apply(v, act);
  if (res) v += load_f(res, res_dt, res_idx);
  return v;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
template <>
__device__ __forceinline__ __half zero_of<__half>() {
  return __float2half(0.f);
}

// fp32 -> T, round to nearest even (as torch's .to(dtype))
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// One lane of a pm* predicate (a byte mask over M, N or K): enabled where
// the mask is null or its byte is nonzero.
__device__ __forceinline__ bool lane_on(const uint8_t* mask, long long i) {
  return mask == nullptr || mask[i] != 0;
}

// The ABFT checksum sidecar (K1e: repro/kernels/mma_gemm.py's checksum
// outputs): the column and row sums of one finished output tile, staged in
// shared memory as `cs` (row pitch ldc) in the accumulator dtype, over its
// first `rows` x `cols` elements (the M/N fringe is left out).  Column c's
// sum goes to col_out[c], row r's to row_out[r * row_stride].  Threads
// tid = 0 .. nthr - 1 (a multiple of 32) take the columns one a thread and
// the rows one a warp (lane-strided partial sums, then a butterfly), each
// in a fixed order: no atomics, the same sums on every run.  The caller
// synchronises the threads before (the tile is complete) and after (the
// tile's memory is reused).  The loops stay rolled: unrolled, they took
// ptxas past 400 s on the wgmma consumers (gemm_wgmma.cu, mma_conv.cu).
template <typename Acc>
__device__ void tile_checksums(const Acc* cs, int ldc, int rows, int cols,
                               Acc* col_out, Acc* row_out,
                               long long row_stride, int tid, int nthr) {
  for (int c = tid; c < cols; c += nthr) {
    Acc s = 0;
    for (int r = 0; r < rows; ++r) s += cs[(long long)r * ldc + c];
    col_out[c] = s;
  }
  const int lane = tid % 32;
  for (int r = tid / 32; r < rows; r += nthr / 32) {
    Acc s = 0;
    for (int c = lane; c < cols; c += 32) s += cs[(long long)r * ldc + c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) row_out[r * row_stride] = s;
  }
}

// Give a kernel more than 48 KB of dynamic shared memory (once).
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
