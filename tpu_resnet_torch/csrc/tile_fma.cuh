// The shared-memory limit and the 16-byte float32 loads and stores of the
// bottleneck's tile kernels (fused_bottleneck_tc.cu).
#pragma once

#include "common.cuh"

namespace tr {

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

}  // namespace tr
