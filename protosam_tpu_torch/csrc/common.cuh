// Shared helpers for the hand-written Hopper kernels.
//
// Every entry point has a plain C interface (pointers, ints, a stream) so
// the library is loaded with ctypes, and returns cudaGetLastError() as an
// int.  Element types are passed as a code: 0 = float32, 1 = bfloat16.
#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptk {

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch's cast
}

constexpr int kCachedDevices = 64;

// the current device's SM count, queried once a device; 0 on an error
inline int sm_count() {
  static std::atomic<int> cache[kCachedDevices];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const bool cached = dev < kCachedDevices;
  if (cached && (n = cache[dev].load(std::memory_order_relaxed)) > 0)
    return n;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (cached) cache[dev].store(n, std::memory_order_relaxed);
  return n;
}

}  // namespace ptk
