// Shared helpers for the hand-written Hopper kernels (sm_90a).
//
// Every kernel source has a plain C entry point that takes raw device
// pointers, the sizes, a dtype code and the caller's CUDA stream, launches
// on that stream, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch. No entry point allocates or synchronises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes passed from the wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr float kNegInf = -1e30f;  // the reference's mask value

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
  return __float2bfloat16(x);
}

}  // namespace repro
