// Sums without atomics, shared by the fused bottleneck's kernels
// (fused_bottleneck_tc.cu, bottleneck_wgrad.cu): a kernel writes one
// row of partial sums per block, and bottleneck_sum_kernel adds the rows in
// row order, so two calls agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace tr {

// out[k] = sum over rows, in row order, of part[row][k].
__global__ void bottleneck_sum_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int rows,
                                      long long L) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= L) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(long long)r * L + k];
  out[k] = s;
}

inline cudaError_t sum_rows(const float* part, float* out, int rows,
                            long long L, cudaStream_t st) {
  if (L == 0) return cudaSuccess;
  bottleneck_sum_kernel<<<(unsigned)((L + 255) / 256), 256, 0, st>>>(
      part, out, rows, L);
  return cudaGetLastError();
}

}  // namespace tr
