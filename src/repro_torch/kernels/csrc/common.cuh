// Shared helpers for the port's attention kernels (plain C interface,
// built with nvcc for sm_90a and loaded through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Masked scores use a finite -1e30, as the JAX kernels do: a fully masked
// row keeps m = -1e30, and exp(s - m) = 1 is then zeroed by the mask.
constexpr float NEG_INF = -1e30f;

// dtype codes passed by the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Key t is attended by a query at absolute position pq when its position
// is live (>= 0), not in the future, and inside the sliding window
// (window <= 0 means none).
__device__ __forceinline__ bool key_visible(int pos, int pq, int window) {
  return pos >= 0 && pos <= pq && (window <= 0 || pos > pq - window);
}

// tanh soft cap on pre-softmax scores (soft_cap <= 0 means none); applied
// before masking, as in the JAX kernels.
__device__ __forceinline__ float cap_score(float s, float soft_cap) {
  return soft_cap > 0.f ? tanhf(s / soft_cap) * soft_cap : s;
}

// Raise the dynamic shared memory limit when a launch needs more than the
// default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
