// Softmax cross-entropy over [B, C] float32 logits with int32 labels:
//   forward   loss[b] = logsumexp(x[b, :]) - x[b, label[b]]
//   backward  dx[b, c] = (softmax(x[b, :])[c] - [c == label[b]]) * g[b]
// A label outside [0, C) gathers 0 (its one-hot row is all zeros), as in
// the reference kernels.
//
// Replaces: tpu_resnet/ops/softmax_xent.py::_fwd_kernel and ::_bwd_kernel
// (launched through _pallas_per_example / _pallas_bwd by the custom VJP of
// softmax_xent_per_example), the train step's loss with
// optim.use_pallas_xent=on. The [B, 128] lane tile and the padding of C to
// 128 classes are TPU layout and are not carried over.
//
// Bound: device memory, B*C*4 bytes read and B*4 written (forward), twice
// that (backward); at the CIFAR head (128 x 10) both are a few kilobytes, so
// the launch itself is the cost. Design: one warp per row; lanes stride over
// the C classes, the row max and then the sum of exp(x - max) come from
// warp-shuffle reductions, and the backward recomputes both from the logits
// (no probabilities are kept between the passes).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 rows per block

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row max and sum of exp(x - max), identical on every lane of the warp.
__device__ __forceinline__ void row_stats(const float* __restrict__ row, int C,
                                          int lane, float* m, float* s) {
  float mx = -INFINITY;
  for (int c = lane; c < C; c += kWarp) mx = fmaxf(mx, __ldg(row + c));
  mx = warp_max(mx);
  float sum = 0.f;
  for (int c = lane; c < C; c += kWarp) sum += expf(__ldg(row + c) - mx);
  *m = mx;
  *s = warp_sum(sum);
}

__global__ void xent_fwd_kernel(const float* __restrict__ x,
                                const int* __restrict__ labels,
                                float* __restrict__ loss, int B, int C) {
  const int row = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) /
                        kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= B) return;  // whole warps leave together
  const float* xr = x + (long long)row * C;
  float m, s;
  row_stats(xr, C, lane, &m, &s);
  if (lane == 0) {
    const int lab = __ldg(labels + row);
    const float picked = (lab >= 0 && lab < C) ? __ldg(xr + lab) : 0.f;
    loss[row] = (logf(s) + m) - picked;
  }
}

__global__ void xent_bwd_kernel(const float* __restrict__ x,
                                const int* __restrict__ labels,
                                const float* __restrict__ g,
                                float* __restrict__ dx, int B, int C) {
  const int row = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) /
                        kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= B) return;
  const float* xr = x + (long long)row * C;
  float m, s;
  row_stats(xr, C, lane, &m, &s);
  const int lab = __ldg(labels + row);
  const float gr = __ldg(g + row);
  float* out = dx + (long long)row * C;
  for (int c = lane; c < C; c += kWarp) {
    const float p = expf(__ldg(xr + c) - m) / s;
    out[c] = (p - (c == lab ? 1.f : 0.f)) * gr;
  }
}

unsigned blocks_for(int B) {
  return (unsigned)(((long long)B * kWarp + kThreads - 1) / kThreads);
}

}  // namespace

// logits: B*C floats, row-major; labels: B int32; loss: B floats.
extern "C" int tr_xent_fwd(const void* logits, const void* labels, void* loss,
                           int B, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || C <= 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  xent_fwd_kernel<<<blocks_for(B), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels),
      static_cast<float*>(loss), B, C);
  return cudaGetLastError();
}

// logits, dx: B*C floats, row-major; labels: B int32; g: B floats.
extern "C" int tr_xent_bwd(const void* logits, const void* labels,
                           const void* g, void* dx, int B, int C, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || C <= 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  xent_bwd_kernel<<<blocks_for(B), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(g), static_cast<float*>(dx), B, C);
  return cudaGetLastError();
}
