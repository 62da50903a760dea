// Shared helpers of the port's CUDA kernels: runtime dtype codes for the
// operands that are touched once per element (seed, bias, residual, out),
// the fused epilogue, and the error-string export the ctypes wrappers use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes (kernels/mma_gemm.py, kernels/mma_attention.py: DTYPE_CODES)
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };
// activation codes (kernels/epilogue.py: ACT_CODES)
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

#define REPRO_NEG_INF (-1e30f)

// A generic pointer into shared memory as the 32-bit shared address that
// cp.async, ldmatrix, mbarrier, TMA and wgmma take.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
