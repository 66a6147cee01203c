// Fused ResNet-v2 basic block, forward with folded BN:
//   y = x + conv2(relu(s2 * conv1(relu(s1 * x + b1)) + b2))
// for stride 1, equal in/out channels, 3x3 SAME convs. x and y are NHWC
// (f32 or bf16), w1 and w2 are HWIO f32 [3,3,C,C], s/b are f32 [C]. All
// arithmetic is f32; y is stored in x's type.
//
// Replaces: tpu_resnet/ops/fused_block.py::_block_kernel (launched by
// block_fwd), which the eval path of every stride-1 identity block of the
// CIFAR ResNet runs when model.fused_blocks=true.
//
// Bound: arithmetic. 2 * 2 * H*W*9*C*C flops per image against
// 2 * H*W*C elements moved, e.g. 4.7 Mflop for 0.1 MB at 32x32x16 in bf16:
// tens of operations per byte, and the math is f32 off the tensor cores
// (67 TFLOP/s on an H100), so operations, not bytes, set the bound.
//
// Design: one thread block per image. The pre-activation relu(s1*x+b1) is
// written with a zero halo into shared memory, conv1 reads it and writes
// relu(s2*.+b2), again with a zero halo, into a second shared buffer, and
// conv2 reads that, adds x (read again from global memory, where L2 still
// holds it) and writes y. Neither intermediate touches device memory. The
// shared buffers are f32 with a pixel stride of C+1 words (odd), so threads
// of a warp that read neighbouring pixels hit distinct banks; both fit under
// the 227 KB limit at every CIFAR stage (32x32x16: 2 x 78.6 KB, 16x16x32:
// 2 x 42.8 KB, 8x8x64: 2 x 26 KB). Each thread computes 8 output channels of
// one pixel, reading their weights as two 16-byte loads per input channel
// through the read-only path: the weights (9*C*C*4 bytes per conv, up to
// 147 KB) do not fit in shared memory beside the activations, so L1 and L2
// hold them.
//
// Known limit, the first thing to fix: the grid is the batch, so a serving
// bucket of B <= 16 images fills at most 16 of the H100's 132 SMs. Row-band
// tiles with a one-row halo (several blocks per image) would fill the card.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCO = 8;  // output channels per thread
constexpr int kMaxSmem = 232448;

// 3x3 taps for output pixel (py, px), channels co0..co0+7, over a padded
// [H+2, W+2] plane with pixel stride CP.
template <int C, int CP>
__device__ __forceinline__ void conv3x3_point(const float* in,
                                              const float* __restrict__ w,
                                              int py, int px, int WP, int co0,
                                              float (&acc)[kCO]) {
#pragma unroll
  for (int j = 0; j < kCO; ++j) acc[j] = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const float* src = in + ((py + ky) * WP + px + kx) * CP;
      const float* wt = w + (ky * 3 + kx) * C * C + co0;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        const float v = src[ci];
        const float4 wa = __ldg(reinterpret_cast<const float4*>(wt + ci * C));
        const float4 wb =
            __ldg(reinterpret_cast<const float4*>(wt + ci * C + 4));
        acc[0] = fmaf(v, wa.x, acc[0]);
        acc[1] = fmaf(v, wa.y, acc[1]);
        acc[2] = fmaf(v, wa.z, acc[2]);
        acc[3] = fmaf(v, wa.w, acc[3]);
        acc[4] = fmaf(v, wb.x, acc[4]);
        acc[5] = fmaf(v, wb.y, acc[5]);
        acc[6] = fmaf(v, wb.z, acc[6]);
        acc[7] = fmaf(v, wb.w, acc[7]);
      }
    }
  }
}

__device__ __forceinline__ float sbr(float v, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), b), 0.f);
}

inline size_t smem_bytes(int H, int W, int C) {
  return 2ull * (H + 2) * (W + 2) * (C + 1) * sizeof(float);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    block_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ w2, const float* __restrict__ s1,
                     const float* __restrict__ b1, const float* __restrict__ s2,
                     const float* __restrict__ b2, T* __restrict__ y, int H,
                     int W) {
  constexpr int CP = C + 1;
  constexpr int G = C / kCO;  // channel groups per pixel
  extern __shared__ float smem[];
  const int WP = W + 2;
  const int plane = (H + 2) * WP * CP;
  float* pre1 = smem;          // relu(s1*x+b1), zero halo
  float* pre2 = smem + plane;  // relu(s2*conv1+b2), zero halo
  const long long base = (long long)blockIdx.x * H * W * C;
  const T* xi = x + base;
  T* yi = y + base;

  for (int i = threadIdx.x; i < 2 * plane; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < H * W * C; i += blockDim.x) {
    const int c = i % C, p = i / C;
    const int py = p / W, px = p - py * W;
    pre1[((py + 1) * WP + px + 1) * CP + c] =
        sbr(tr::to_f32(xi[i]), __ldg(s1 + c), __ldg(b1 + c));
  }
  __syncthreads();

  float acc[kCO];
  for (int t = threadIdx.x; t < H * W * G; t += blockDim.x) {
    const int co0 = (t % G) * kCO, p = t / G;
    const int py = p / W, px = p - py * W;
    conv3x3_point<C, CP>(pre1, w1, py, px, WP, co0, acc);
    float* dst = pre2 + ((py + 1) * WP + px + 1) * CP + co0;
#pragma unroll
    for (int j = 0; j < kCO; ++j)
      dst[j] = sbr(acc[j], __ldg(s2 + co0 + j), __ldg(b2 + co0 + j));
  }
  __syncthreads();

  for (int t = threadIdx.x; t < H * W * G; t += blockDim.x) {
    const int co0 = (t % G) * kCO, p = t / G;
    const int py = p / W, px = p - py * W;
    conv3x3_point<C, CP>(pre2, w2, py, px, WP, co0, acc);
    const long long o = (long long)p * C + co0;
#pragma unroll
    for (int j = 0; j < kCO; ++j)
      yi[o + j] = tr::from_f32<T>(tr::to_f32(xi[o + j]) + acc[j]);
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* w1, const void* w2,
                   const void* s1, const void* b1, const void* s2,
                   const void* b2, void* y, int B, int H, int W,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(H, W, C);
  auto kernel = block_fwd_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(y), H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(const void* x, const void* w1, const void* w2,
                       const void* s1, const void* b1, const void* s2,
                       const void* b2, void* y, int B, int H, int W, int C,
                       cudaStream_t st) {
  switch (C) {
    case 16:
      return launch<T, 16>(x, w1, w2, s1, b1, s2, b2, y, B, H, W, st);
    case 32:
      return launch<T, 32>(x, w1, w2, s1, b1, s2, b2, y, B, H, W, st);
    case 64:
      return launch<T, 64>(x, w1, w2, s1, b1, s2, b2, y, B, H, W, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [B,H,W,C] of `dtype` (tr::DType), contiguous; w1, w2: [3,3,C,C] f32
// HWIO, 16-byte aligned; s1, b1, s2, b2: C floats. C is 16, 32 or 64 and the
// two padded planes must fit in shared memory. Returns the cudaError_t.
extern "C" int tr_block_fwd(const void* x, const void* w1, const void* w2,
                            const void* s1, const void* b1, const void* s2,
                            const void* b2, void* y, int B, int H, int W,
                            int C, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || H < 1 || W < 1 || smem_bytes(H, W, C) > kMaxSmem)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return dispatch_c<float>(x, w1, w2, s1, b1, s2, b2, y, B, H, W, C, st);
    case tr::kBFloat16:
      return dispatch_c<__nv_bfloat16>(x, w1, w2, s1, b1, s2, b2, y, B, H, W,
                                       C, st);
    default:
      return cudaErrorInvalidValue;
  }
}
