// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel reads float32 or bfloat16 tensors, computes in float32 and
// writes back in the input type.  Each C entry point launches on the
// caller's stream and returns cudaGetLastError(), so a refused launch (too
// many threads, too much shared memory) reaches the Python wrapper, which
// raises.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PRFAAS_API extern "C" __attribute__((visibility("default")))

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

static inline int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// Launch with `smem` bytes of dynamic shared memory, lifting the 48 KB
// default first when needed.
template <typename Kernel>
static inline cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}
