// Helpers shared by the port's kernels: element-type conversion and the
// dtype codes the ctypes wrappers pass (ops/_build.py DTYPE_CODES).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tr {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

}  // namespace tr
