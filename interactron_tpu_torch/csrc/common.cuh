// Shared helpers for the attention kernels: element-type conversion and the
// argument codes of the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace ipt {

// dtype codes passed from Python (ops/flash_attention.py::_DTYPES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// x rounded through T's precision (the identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

}  // namespace ipt
