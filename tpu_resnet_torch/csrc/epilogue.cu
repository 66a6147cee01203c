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
// H100 stops being memory-bound. Nothing is reused, so what counts is the
// bytes in flight and few instructions per 16-byte vector. The layout is
// sbr_bwd's without its sums:
//   - A block covers a slice of a pixel's 16-byte channel vectors (8 bf16
//     or 4 f32 values; C is a multiple of the vector width, so a vector
//     never spans two pixels): all of them where a pixel has at most 256,
//     so that a block's rows of pixels are one contiguous run of memory.
//   - A thread keeps one vector of the slice and loads its s and b into
//     registers once, then walks pixels with a fixed stride, four (or two,
//     or one) independent 16-byte loads of x in flight before its stores.
//     No modulo in the loop.
//   - The plan (slice, threads, vectors in flight, blocks) comes from the
//     shape and the SM count (ops/epilogue.py sbr_plan): at most four
//     waves of the kSbrBlocksPerSM blocks an SM holds (four waves ran 3%
//     faster on an H100 than one at the ImageNet sites); where four
//     vectors a thread would leave SMs without a block (B=16 serving,
//     small planes), two or one, then fewer threads a block.
// Multiply and add are rounded separately (__fmul_rn, __fadd_rn, no
// contraction into an FMA), as the plain PyTorch version rounds them, so
// the two agree bit for bit.
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
// tr_noop replaces no TPU kernel: an empty launch, there only so that the
// device time a launch takes on its own (the floor under every small
// call's time) can be measured through the same path (chip_smoke.py,
// launch_floor_ms).
//
// Backward (tr_sbr_bwd), given g = dL/dy:
//   mask = [x*s + b > 0]   dx = g*mask*s (in x's type)
//   ds = sum over B,H,W of g*mask*x     db = sum of g*mask  (f32, [C])
// Replaces: tpu_resnet/ops/epilogue.py::_sbr_bwd_kernel (through
// _sbr_bwd_call, the custom VJP of scale_bias_relu), run by every BN+ReLU
// site of the training step with model.fused_epilogue=on. Bound: device
// memory, x and g read once and dx written once (3 x elements x type size).
// Only x is kept from the forward: the mask is recomputed with the forward's
// exact roundings and dx = g*mask*s rounds once, so dx is bit for bit the
// plain version's. The TPU kernel carries ds/db across its sequential grid;
// here it is one launch:
//   - A block covers a slice of a pixel's channels, 4 or 8 16-byte vectors
//     (8 where C has 32 vectors or more; all of C where C is smaller), and
//     walks chunks of pixels with a fixed stride. A thread keeps one vector
//     of the slice, with four independent vectors of x and four of g in
//     flight. The grid is one wave: the SM count times the blocks an SM
//     holds, at most kBlocksPerSM (one ran faster on an H100 than two, at
//     the CIFAR and at the ImageNet sites), shared among the slices. Each
//     block writes a row of partial sums, so few blocks keep the last
//     block's sum short.
//   - A block reduces its threads' sums in a fixed order (shuffles in a fixed
//     pattern, then the warps in order; where a slice's vectors are not a
//     power of two, its rows of threads in order) and writes one row [ds,
//     db] of its slice.
//   - The block that finishes its slice last adds the slice's rows. It is
//     found by an integer ticket: after a barrier one thread fences the
//     block's writes and takes an atomicAdd on the slice's counter; the last
//     one resets it to 0. The ticket decides only which block adds, never
//     the order, which is fixed, so two calls agree bit for bit. No float
//     atomics. Its loads go out 16 at a time before they are added: loaded
//     and added one by one they took 4-5 us of a 10 us call at the CIFAR
//     shapes.
// Slicing C keeps each slice's rows few, so the last block's sum stays short
// however wide C is.

#include <algorithm>

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

constexpr int kThreads = 256;
constexpr int kSbrBlocksPerSM = 4;  // forward blocks an SM holds, at least

// The forward: block (slice, bx) = blockIdx, one of nbx = gridDim.y blocks
// of its slice, covers vectors [slice*vs, (slice+1)*vs) of a pixel in the
// chunks bx, bx + nbx, ... of rows*U pixels; thread (v, r) = threadIdx,
// blockDim = (vs, rows), keeps vector v of the slice at pixels chunk +
// u*rows + r, u < U. The two-dimensional block and grid leave no division
// before the first load.
template <typename T, int U>
__global__ void __launch_bounds__(kThreads, kSbrBlocksPerSM) sbr_kernel(
    const T* __restrict__ x, const float* __restrict__ s,
    const float* __restrict__ b, T* __restrict__ y, long long pixels, int C) {
  constexpr int N = Vec<T>::N;
  const int vpp = C / N, rows = blockDim.y;
  const int vec = blockIdx.x * blockDim.x + threadIdx.x;  // of a pixel
  const uint4* xv = reinterpret_cast<const uint4*>(x) + vec;
  uint4* yv = reinterpret_cast<uint4*>(y) + vec;
  const long long chunk = (long long)rows * U;
  const long long first = blockIdx.y * chunk + threadIdx.y;
  const long long step = gridDim.y * chunk;
  // The first chunk's loads go out before the scale's and bias's.
  uint4 xr[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long p = first + u * rows;
    if (p < pixels) xr[u] = __ldg(xv + p * vpp);
  }
  float sv[N], bv[N];
  if (((reinterpret_cast<unsigned long long>(s) |
        reinterpret_cast<unsigned long long>(b)) & 15u) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(s + vec * N);
    const float4* b4 = reinterpret_cast<const float4*>(b + vec * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 sq = __ldg(s4 + q), bq = __ldg(b4 + q);
      sv[4 * q] = sq.x, sv[4 * q + 1] = sq.y, sv[4 * q + 2] = sq.z;
      sv[4 * q + 3] = sq.w;
      bv[4 * q] = bq.x, bv[4 * q + 1] = bq.y, bv[4 * q + 2] = bq.z;
      bv[4 * q + 3] = bq.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      sv[j] = __ldg(s + vec * N + j);
      bv[j] = __ldg(b + vec * N + j);
    }
  }
  for (long long p0 = first; p0 < pixels; p0 += step) {
    if (p0 != first) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long p = p0 + u * rows;
        if (p < pixels) xr[u] = __ldg(xv + p * vpp);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long p = p0 + u * rows;
      if (p >= pixels) break;
      const T* in = reinterpret_cast<const T*>(&xr[u]);
      uint4 packed;
      T* out = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = __fadd_rn(__fmul_rn(tr::to_f32(in[j]), sv[j]), bv[j]);
        out[j] = tr::from_f32<T>(fmaxf(f, 0.f));
      }
      yv[p * vpp] = packed;
    }
  }
}

__global__ void noop_kernel() {}

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

constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride beyond this
constexpr int kUnroll = 4;          // vectors of x and of g in flight a thread
constexpr int kBlocksPerSM = 1;     // backward blocks an SM, at most
constexpr int kTailLoads = 16;      // the last block's loads in flight a thread
constexpr int kRedFloats = 4096;    // a backward block's exchange
constexpr int kMaxSlices = 1024;    // the tickets the wrapper keeps

// The backward: block (bx, slice), slice = blockIdx.x % slices, one of nbx
// blocks of its slice, covers channels [slice*cw, (slice+1)*cw), cw = vs*N,
// of the chunks bx, bx + nbx, ... of rows*kUnroll pixels; thread (r, v)
// keeps vector v of the slice at pixels chunk + u*rows + r. part is
// [nbx][2C]: row bx holds ds then db.
template <typename T>
__global__ void __launch_bounds__(kThreads) sbr_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ s,
    const float* __restrict__ b, const T* __restrict__ g, T* __restrict__ dx,
    float* __restrict__ part, float* __restrict__ sums,
    unsigned* __restrict__ tickets, long long pixels, int C, int vs,
    int nbx) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[kRedFloats];  // [slots][2][cw], then [phases][2cw]
  __shared__ bool last;
  const int cw = vs * N, vpp = C / N, slices = C / cw;
  const int slice = blockIdx.x % slices, bx = blockIdx.x / slices;
  const int rows = blockDim.x / vs;
  const int v = threadIdx.x % vs, r = threadIdx.x / vs;
  const int vec = slice * vs + v;  // the thread's vector of a pixel
  float sv[N], bv[N], ds[N], db[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    sv[j] = __ldg(s + vec * N + j);
    bv[j] = __ldg(b + vec * N + j);
    ds[j] = 0.f;
    db[j] = 0.f;
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* dxv = reinterpret_cast<uint4*>(dx);
  const long long chunk = (long long)rows * kUnroll;
  for (long long p0 = bx * chunk; p0 < pixels; p0 += nbx * chunk) {
    uint4 xr[kUnroll], gr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = p0 + u * rows + r;
      if (p < pixels) {
        xr[u] = __ldg(xv + p * vpp + vec);
        gr[u] = __ldg(gv + p * vpp + vec);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = p0 + u * rows + r;
      if (p >= pixels) continue;
      const T* xin = reinterpret_cast<const T*>(&xr[u]);
      const T* gin = reinterpret_cast<const T*>(&gr[u]);
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
        ds[j] = fmaf(gm, xf, ds[j]);
        db[j] += gm;
      }
      dxv[p * vpp + vec] = packed;
    }
  }

  // The block's row: where vs is a power of two (it divides 32, and the
  // block is kThreads threads) the lanes of one vector lie vs apart, so
  // shuffles in a fixed pattern, then the warps in order; else the rows of
  // threads in order.
  const int lane = threadIdx.x & 31;
  const bool shfl = (vs & (vs - 1)) == 0;
  if (shfl) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      for (int o = vs; o < 32; o <<= 1) {
        ds[j] += __shfl_xor_sync(0xffffffffu, ds[j], o);
        db[j] += __shfl_xor_sync(0xffffffffu, db[j], o);
      }
  }
  const int slots = shfl ? blockDim.x / 32 : rows;
  const int slot = shfl ? threadIdx.x / 32 : r;
  if (!shfl || lane < vs) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      red[(slot * 2) * cw + v * N + j] = ds[j];
      red[(slot * 2 + 1) * cw + v * N + j] = db[j];
    }
  }
  __syncthreads();
  float* row = part + (long long)bx * 2 * C;
  for (int k = threadIdx.x; k < 2 * cw; k += blockDim.x) {
    const int which = k / cw, c = k % cw;
    float acc = 0.f;
    for (int q = 0; q < slots; ++q) acc += red[(q * 2 + which) * cw + c];
    row[which * C + slice * cw + c] = acc;
  }
  // The block's writes, the row among them, are ordered before the ticket by
  // the barrier and one fence (cumulative); the last block's reads after
  // the ticket by a fence and the barrier.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(tickets + slice, 1u) == (unsigned)(nbx - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // The slice's last block: column k of [ds, db] over the slice's rows.
  // Thread (phase, k) adds rows phase, phase + phases, ... in order, then
  // the phases are added in order. The rows are loaded kTailLoads at a time
  // before they are added, so that the loads overlap.
  const int cols = 2 * cw;
  const int phases = (int)blockDim.x >= cols ? blockDim.x / cols : 1;
  const int k = threadIdx.x % cols, phase = threadIdx.x / cols;
  if (phase < phases) {
    const float* col = part + (k / cw) * C + slice * cw + k % cw;
    float acc = 0.f;
    for (int q0 = phase; q0 < nbx; q0 += kTailLoads * phases) {
      float v[kTailLoads];
#pragma unroll
      for (int j = 0; j < kTailLoads; ++j) {
        const int q = q0 + j * phases;
        v[j] = q < nbx ? __ldcg(col + (long long)q * 2 * C) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTailLoads; ++j) acc += v[j];
    }
    red[phase * cols + k] = acc;
  }
  __syncthreads();
  for (int kk = threadIdx.x; kk < cols; kk += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < phases; ++q) acc += red[q * cols + kk];
    sums[(kk / cw) * C + slice * cw + kk % cw] = acc;
  }
  if (threadIdx.x == 0) tickets[slice] = 0;
}

// The largest divisor of n that is at most m.
int divisor_at_most(int n, int m) {
  for (int d = m < n ? m : n; d > 1; --d)
    if (n % d == 0) return d;
  return 1;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* s, const void* b,
                       const void* g, void* dx, void* part, void* sums,
                       void* tickets, long long n, int C, int part_rows,
                       int device, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (C % N != 0 || n % C != 0 || part_rows < 1) return cudaErrorInvalidValue;
  const long long pixels = n / C;
  if (pixels == 0)
    return cudaMemsetAsync(sums, 0, 2 * C * sizeof(float), stream);
  const int vpp = C / N;
  // A slice of 8 vectors (128 bytes of a pixel) where C has 32 vectors or
  // more, else 4: the faster on an H100 at the ImageNet and CIFAR sites
  // (PERF.md).
  const int vs = divisor_at_most(vpp, vpp >= 32 ? 8 : 4);
  const int slices = vpp / vs, threads = kThreads / vs * vs;
  if (slices > kMaxSlices) return cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sbr_bwd_kernel<T>, threads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // Blocks a slice: as many as run at once over all slices, no more than
  // the slice's chunks of pixels or the rows of partial sums.
  const long long chunk = (long long)(threads / vs) * kUnroll;
  const long long chunks = (pixels + chunk - 1) / chunk;
  const long long fill =
      ((long long)std::min(per_sm, kBlocksPerSM) * sms + slices - 1) / slices;
  const int nbx = (int)std::min<long long>({chunks, fill, part_rows});
  sbr_bwd_kernel<T><<<nbx * slices, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const float*>(b), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(part),
      static_cast<float*>(sums), static_cast<unsigned*>(tickets), pixels, C,
      vs, nbx);
  return cudaGetLastError();
}

// The forward's launch on the plan of ops/epilogue.py sbr_plan: slices of
// vs vectors, `threads` threads a block (rows of vs), `unroll` vectors in
// flight a thread, nbx blocks a slice. Any such plan covers every vector
// once; its numbers decide only the speed.
template <typename T>
cudaError_t launch(const void* x, const void* s, const void* b, void* y,
                   long long n, int C, int vs, int threads, int unroll,
                   int nbx, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (C <= 0 || C % N != 0 || n % C != 0) return cudaErrorInvalidValue;
  const long long pixels = n / C;
  if (pixels == 0) return cudaSuccess;
  const int vpp = C / N;
  if (vs < 1 || vpp % vs != 0 || threads < vs || threads > kThreads ||
      threads % vs != 0 || nbx < 1 || nbx > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(vpp / vs, nbx), block(vs, threads / vs);
  const T* xt = static_cast<const T*>(x);
  const float* st = static_cast<const float*>(s);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  switch (unroll) {
    case 4:
      sbr_kernel<T, 4><<<grid, block, 0, stream>>>(xt, st, bt, yt, pixels, C);
      break;
    case 2:
      sbr_kernel<T, 2><<<grid, block, 0, stream>>>(xt, st, bt, yt, pixels, C);
      break;
    case 1:
      sbr_kernel<T, 1><<<grid, block, 0, stream>>>(xt, st, bt, yt, pixels, C);
      break;
    default:
      return cudaErrorInvalidValue;
  }
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
// 16-byte aligned; s, b: C floats; vs, threads, unroll, nbx: the plan
// (ops/epilogue.py sbr_plan). Returns the launch's cudaError_t.
extern "C" int tr_sbr(const void* x, const void* s, const void* b, void* y,
                      long long n, int C, int vs, int threads, int unroll,
                      int nbx, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return launch<float>(x, s, b, y, n, C, vs, threads, unroll, nbx, st);
    case tr::kBFloat16:
      return launch<__nv_bfloat16>(x, s, b, y, n, C, vs, threads, unroll,
                                   nbx, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// One empty launch on `stream` (the launch floor; replaces no TPU kernel).
extern "C" int tr_noop(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
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
// C channels, 16-byte aligned; s, b: C floats; part: 2 * part_rows * C
// floats of scratch; sums: 2 * C floats, ds then db; tickets: 1024 unsigned
// zeros, left zero, used by no other call at the same time (the wrapper
// keeps them per device and stream). One launch on `stream`.
extern "C" int tr_sbr_bwd(const void* x, const void* s, const void* b,
                          const void* g, void* dx, void* part, void* sums,
                          void* tickets, long long n, int C, int part_rows,
                          int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return launch_bwd<float>(x, s, b, g, dx, part, sums, tickets, n, C,
                               part_rows, device, st);
    case tr::kBFloat16:
      return launch_bwd<__nv_bfloat16>(x, s, b, g, dx, part, sums, tickets, n,
                                       C, part_rows, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}
