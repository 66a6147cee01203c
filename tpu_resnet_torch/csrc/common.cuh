// Helpers shared by the port's kernels: element-type conversion, the ReLU
// and the dtype codes the ctypes wrappers pass (ops/_build.py DTYPE_CODES).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tr {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max(v, 0) that keeps a NaN, as the reference's jnp.maximum(v, 0) and the
// plain versions' torch.clamp_min do (fmaxf returns 0 for a NaN); fmaxf's
// value, signed zeros included, wherever v is not a NaN.
__device__ __forceinline__ float relu(float v) {
  return v != v ? v : fmaxf(v, 0.f);
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
