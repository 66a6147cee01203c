// Fused BN+ReLU conv epilogue: y = relu(x * s[c] + b[c]) over a contiguous
// NHWC tensor. Math in f32, result stored in x's type (f32 or bf16).
//
// Replaces: tpu_resnet/ops/epilogue.py::_sbr_kernel (launched through
// _sbr_call by scale_bias_relu), the scale-bias-ReLU that every XLA-path BN
// site of the ResNet runs when model.fused_epilogue=on.
//
// Bound: device memory. Each element is read once and written once (4 bytes
// per element in bf16, 8 in f32) for one multiply, one add and one max:
// under one operation per byte, far below the ~295 flop/byte at which the
// H100 stops being memory-bound. Nothing is reused, so the design is one
// grid-stride pass with 16-byte loads and stores (8 bf16 or 4 f32 values per
// thread per step). C is a multiple of the vector width, so a vector never
// spans two pixels and its first channel is (i * N) % C; s and b (C floats
// each) stay in L1. Multiply and add are rounded separately (__fmul_rn,
// __fadd_rn, no contraction into an FMA), as the plain PyTorch version
// rounds them, so the two agree bit for bit.

#include "common.cuh"

namespace {

template <typename T>
struct Vec;  // N values of T in 16 bytes
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

template <typename T>
__global__ void sbr_kernel(const T* __restrict__ x, const float* __restrict__ s,
                           const float* __restrict__ b, T* __restrict__ y,
                           long long nvec, int C) {
  constexpr int N = Vec<T>::N;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    const uint4 raw = __ldg(xv + i);
    const T* in = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* out = reinterpret_cast<T*>(&packed);
    const int c0 = (int)((i * N) % C);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float v = __fadd_rn(__fmul_rn(tr::to_f32(in[j]), __ldg(s + c0 + j)),
                                __ldg(b + c0 + j));
      out[j] = tr::from_f32<T>(fmaxf(v, 0.f));
    }
    yv[i] = packed;
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride beyond this

template <typename T>
cudaError_t launch(const void* x, const void* s, const void* b, void* y,
                   long long n, int C, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (C % N != 0 || n % C != 0) return cudaErrorInvalidValue;
  const long long nvec = n / N;
  if (nvec == 0) return cudaSuccess;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sbr_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const float*>(b), static_cast<T*>(y), nvec, C);
  return cudaGetLastError();
}

}  // namespace

// x, y: n elements of `dtype` (tr::DType), NHWC-contiguous with C channels,
// 16-byte aligned; s, b: C floats. Returns the launch's cudaError_t.
extern "C" int tr_sbr(const void* x, const void* s, const void* b, void* y,
                      long long n, int C, int dtype, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return launch<float>(x, s, b, y, n, C, st);
    case tr::kBFloat16:
      return launch<__nv_bfloat16>(x, s, b, y, n, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}
