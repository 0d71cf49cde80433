// Shared helpers for the port's attention kernels (plain C interface,
// built with nvcc for sm_90a and loaded through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

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
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

// Raise the dynamic shared memory limit when a launch needs more than the
// default 48 KB, static shared memory included (a launch whose dynamic
// bytes fit 48 KB only without the static ones is refused otherwise).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (bytes + attr.sharedSizeBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Per-device caches of what a launch queries once: attributes and
// cudaFuncSetAttribute apply to one device, so a process that drives
// several cards keeps one entry per card (ordinals past kMaxDevices are
// refused).
constexpr int kMaxDevices = 64;

// The current device's ordinal, or -1 on an error or past kMaxDevices.
inline int device_slot() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

// The current device's SM count, queried once a process and device (0 on
// an error: the caller then returns cudaGetLastError()).
inline int sm_count() {
  static int sms[kMaxDevices] = {};
  const int dev = device_slot();
  if (dev < 0) return 0;
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess)
      return 0;
    sms[dev] = n;
  }
  return sms[dev];
}

}  // namespace repro
