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

// tanh soft cap on pre-softmax scores (soft_cap <= 0 means none); applied
// before masking, as in the JAX kernels.
__device__ __forceinline__ float cap_score(float s, float soft_cap) {
  return soft_cap > 0.f ? tanhf(s / soft_cap) * soft_cap : s;
}

// Stage `rows` rows of D elements of two arrays (K and V), row t at
// k_base / v_base + t * stride, into shared memory as f32 (rows x D, row
// major), spread over `nthreads` threads.  With `vec` (the launcher checked
// D % (16 / sizeof(T)) == 0 and 16-byte aligned bases) each thread moves
// 16-byte words, two loads in flight per step, and converts them as it
// stores; otherwise one element at a time.
template <typename T>
__device__ __forceinline__ void cvt_word(const uint4& w, float* out);
template <>
__device__ __forceinline__ void cvt_word<float>(const uint4& w, float* out) {
  reinterpret_cast<float4*>(out)[0] = make_float4(
      __uint_as_float(w.x), __uint_as_float(w.y), __uint_as_float(w.z),
      __uint_as_float(w.w));
}
template <>
__device__ __forceinline__ void cvt_word<__nv_bfloat16>(const uint4& w,
                                                        float* out) {
  const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u[2 * i]));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u[2 * i + 1]));
    reinterpret_cast<float4*>(out)[i] = make_float4(a.x, a.y, b.x, b.y);
  }
}
template <>
__device__ __forceinline__ void cvt_word<int8_t>(const uint4& w, float* out) {
  const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const char4 c = *reinterpret_cast<const char4*>(&u[i]);
    reinterpret_cast<float4*>(out)[i] = make_float4(c.x, c.y, c.z, c.w);
  }
}

template <typename T>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k_base,
                                         const T* __restrict__ v_base,
                                         size_t stride, int rows, int D,
                                         float* __restrict__ ks,
                                         float* __restrict__ vs, bool vec,
                                         int nthreads) {
  if (vec) {
    constexpr int N = 16 / sizeof(T);
    const int per_row = D / N;
#pragma unroll 2
    for (int i = threadIdx.x; i < rows * per_row; i += nthreads) {
      const int t = i / per_row, c = (i - t * per_row) * N;
      const uint4 kw = *reinterpret_cast<const uint4*>(k_base + t * stride + c);
      const uint4 vw = *reinterpret_cast<const uint4*>(v_base + t * stride + c);
      cvt_word<T>(kw, ks + t * D + c);
      cvt_word<T>(vw, vs + t * D + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += nthreads) {
      const int t = i / D, d = i - t * D;
      ks[i] = to_f32(k_base[t * stride + d]);
      vs[i] = to_f32(v_base[t * stride + d]);
    }
  }
}

// Whether stage_kv may move 16-byte words for these arrays.
template <typename T>
inline bool vec_ok(int D, const void* k, const void* v) {
  return D % (16 / sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
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
