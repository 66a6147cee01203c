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
//
// Residual-add variant (tr_sbr_add): y = relu(x * s[c] + b[c]) + r, with r
// of x's shape and type, summed in f32 and stored in x's type. Replaces:
// tpu_resnet/ops/epilogue.py::_sbr_add_kernel (through _sbr_add_call, the
// forward of scale_bias_relu_add), which the reference reaches through its
// autotune probe (probe_epilogue(include_add=True)) and
// scale_bias_relu_add_auto. Bound: device memory, x and r read once and y
// written once (3 elements x type size), five operations per element. The
// same one-pass grid-stride loop as tr_sbr with a second 16-byte load; the
// add is __fadd_rn too, so it agrees bit for bit with the plain version.
// Its backward is tr_sbr_bwd's, with dr = g.
//
// Backward (tr_sbr_bwd), given g = dL/dy:
//   mask = [x*s + b > 0]   dx = g*mask*s (in x's type)
//   ds = sum over B,H,W of g*mask*x     db = sum of g*mask  (f32, [C])
// Replaces: tpu_resnet/ops/epilogue.py::_sbr_bwd_kernel (through
// _sbr_bwd_call, the custom VJP of scale_bias_relu), run by every BN+ReLU
// site of the training step with model.fused_epilogue=on. Bound: device
// memory, x and g read once and dx written once (3 x elements x type size).
// Only x is kept from the forward: the mask is recomputed with the forward's
// exact roundings. The TPU kernel carries ds/db across its sequential grid;
// here blocks run in parallel, so each block writes a row of partial sums
// and a second small launch adds the rows in a fixed order. No float
// atomics, so runs repeat bit for bit.

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

template <typename T>
__global__ void sbr_add_kernel(const T* __restrict__ x,
                               const float* __restrict__ s,
                               const float* __restrict__ b,
                               const T* __restrict__ r, T* __restrict__ y,
                               long long nvec, int C) {
  constexpr int N = Vec<T>::N;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* rv = reinterpret_cast<const uint4*>(r);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    const uint4 xraw = __ldg(xv + i);
    const uint4 rraw = __ldg(rv + i);
    const T* in = reinterpret_cast<const T*>(&xraw);
    const T* res = reinterpret_cast<const T*>(&rraw);
    uint4 packed;
    T* out = reinterpret_cast<T*>(&packed);
    const int c0 = (int)((i * N) % C);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float v = __fadd_rn(__fmul_rn(tr::to_f32(in[j]), __ldg(s + c0 + j)),
                                __ldg(b + c0 + j));
      out[j] = tr::from_f32<T>(__fadd_rn(fmaxf(v, 0.f), tr::to_f32(res[j])));
    }
    yv[i] = packed;
  }
}

// Backward: one thread owns one 16-byte vector of channels (c0..c0+N-1, a
// fixed group for the thread) and walks the block's range of pixels with a
// stride of `rows`; it writes dx per element and keeps its channels' sums of
// g*mask*x and g*mask in registers. The block then sums its threads' rows in
// a fixed order through shared memory and writes one row of partial sums
// per block; sbr_bwd_sum_kernel adds the blocks' rows in block order.
template <typename T>
__global__ void sbr_bwd_kernel(const T* __restrict__ x,
                               const float* __restrict__ s,
                               const float* __restrict__ b,
                               const T* __restrict__ g, T* __restrict__ dx,
                               float* __restrict__ part, long long pixels,
                               int C, int rows) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float red[];  // [2][rows][C]: sums of g*m*x, of g*m
  const int vpp = C / N;          // vectors per pixel
  const int v = threadIdx.x % vpp;
  const int r = threadIdx.x / vpp;
  const int c0 = v * N;
  const long long per_block = (pixels + gridDim.x - 1) / gridDim.x;
  const long long p0 = (long long)blockIdx.x * per_block;
  const long long p1 = min(p0 + per_block, pixels);
  float sv[N], bv[N], ds[N], db[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    sv[j] = __ldg(s + c0 + j);
    bv[j] = __ldg(b + c0 + j);
    ds[j] = 0.f;
    db[j] = 0.f;
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* dxv = reinterpret_cast<uint4*>(dx);
  for (long long p = p0 + r; p < p1; p += rows) {
    const long long i = p * vpp + v;
    const uint4 xr = __ldg(xv + i);
    const uint4 gr = __ldg(gv + i);
    const T* xin = reinterpret_cast<const T*>(&xr);
    const T* gin = reinterpret_cast<const T*>(&gr);
    uint4 packed;
    T* out = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xf = tr::to_f32(xin[j]);
      // The forward's rounding exactly (no FMA): a pre-activation that
      // rounds to 0 there has mask 0 here too.
      const float pre = __fadd_rn(__fmul_rn(xf, sv[j]), bv[j]);
      const float gm = pre > 0.f ? tr::to_f32(gin[j]) : 0.f;
      out[j] = tr::from_f32<T>(__fmul_rn(gm, sv[j]));
      ds[j] += gm * xf;
      db[j] += gm;
    }
    dxv[i] = packed;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    red[r * C + c0 + j] = ds[j];
    red[(rows + r) * C + c0 + j] = db[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * C; k += blockDim.x) {
    const int which = k / C, c = k % C;
    float acc = 0.f;
    for (int rr = 0; rr < rows; ++rr) acc += red[(which * rows + rr) * C + c];
    part[((long long)which * gridDim.x + blockIdx.x) * C + c] = acc;
  }
}

// out[which * C + c] = sum over blocks, in block order, of
// part[which][block][c]; which 0 is ds, 1 is db.
__global__ void sbr_bwd_sum_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int nblocks,
                                   int C) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * C) return;
  const int which = k / C, c = k % C;
  const float* p = part + (long long)which * nblocks * C + c;
  float acc = 0.f;
  for (int blk = 0; blk < nblocks; ++blk) acc += p[(long long)blk * C];
  out[k] = acc;
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride beyond this

template <typename T>
cudaError_t launch_bwd(const void* x, const void* s, const void* b,
                       const void* g, void* dx, void* part, void* sums,
                       long long n, int C, int nblocks, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (C % N != 0 || n % C != 0 || nblocks <= 0) return cudaErrorInvalidValue;
  const int vpp = C / N;
  if (vpp > 1024) return cudaErrorInvalidValue;
  const int rows = vpp >= kThreads ? 1 : kThreads / vpp;
  const size_t smem = 2ull * rows * C * sizeof(float);  // <= 64 KB
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sbr_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long pixels = n / C;
  if (pixels == 0) return cudaMemsetAsync(sums, 0, 2 * C * sizeof(float),
                                          stream);
  sbr_bwd_kernel<T><<<nblocks, rows * vpp, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const float*>(b), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(part), pixels, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sbr_bwd_sum_kernel<<<(2 * C + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(static_cast<const float*>(part),
                                 static_cast<float*>(sums), nblocks, C);
  return cudaGetLastError();
}

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

template <typename T>
cudaError_t launch_add(const void* x, const void* s, const void* b,
                       const void* r, void* y, long long n, int C,
                       cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (C % N != 0 || n % C != 0) return cudaErrorInvalidValue;
  const long long nvec = n / N;
  if (nvec == 0) return cudaSuccess;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sbr_add_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const float*>(b), static_cast<const T*>(r),
      static_cast<T*>(y), nvec, C);
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

// y = relu(x * s + b) + r. x, r, y: n elements of `dtype`, NHWC-contiguous
// with C channels, 16-byte aligned; s, b: C floats.
extern "C" int tr_sbr_add(const void* x, const void* s, const void* b,
                          const void* r, void* y, long long n, int C,
                          int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return launch_add<float>(x, s, b, r, y, n, C, st);
    case tr::kBFloat16:
      return launch_add<__nv_bfloat16>(x, s, b, r, y, n, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward of tr_sbr. x, g, dx: n elements of `dtype`, NHWC-contiguous with
// C channels, 16-byte aligned; s, b: C floats; part: 2 * nblocks * C floats
// of scratch; sums: 2 * C floats, ds then db. Two launches on `stream`.
extern "C" int tr_sbr_bwd(const void* x, const void* s, const void* b,
                          const void* g, void* dx, void* part, void* sums,
                          long long n, int C, int nblocks, int dtype,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return launch_bwd<float>(x, s, b, g, dx, part, sums, n, C, nblocks, st);
    case tr::kBFloat16:
      return launch_bwd<__nv_bfloat16>(x, s, b, g, dx, part, sums, n, C,
                                       nblocks, st);
    default:
      return cudaErrorInvalidValue;
  }
}
