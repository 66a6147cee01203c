// Softmax cross-entropy over [B, C] float32 logits with int32 or int64
// labels:
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
// that (backward); at the train step's heads (128 x 10 to 128 x 1000) that
// is well under a microsecond, so a launch's own floor is most of a call.
// Design: one warp a row, a few rows a block (8 at up to 128 classes, else
// 2: the rows of a B=128 head spread over 16 or 64 SMs). A lane loads its
// share of the row once, all its loads issued before any use (16-byte
// loads where the row is 16-byte aligned, else scalar ones, lanes on
// neighbouring addresses), and holds it in registers, 1 to 32 floats a
// lane: rows of up to 1024 classes. The row max and the sum of
// exp(x - max) come from those registers; the label's logit is one more
// load beside them (an out-of-range label picks 0). The backward writes dx
// from the same registers (the exponentials of the sum times one
// reciprocal of it): each logit is read once. Longer rows go chunk by
// chunk (1024 classes a chunk, the max and sum carried online); the
// backward then reads the row twice. The backward recomputes the row
// statistics from the logits, as the reference does; no probabilities are
// kept between the passes. g is read with its stride (0 for the mean's
// cotangent, a broadcast scalar), labels in their own width and stride, so
// the wrappers launch nothing else.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerLane = 32;  // floats a lane holds: 1024 classes a chunk
constexpr int kMaxRowsPerBlock = 8;

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

// The row's label, or -1 where it lies outside [0, C) (it then matches no
// class, padding slots included).
__device__ __forceinline__ int label_of(const void* labels, int wide,
                                        long long stride, int row, int C) {
  const long long lab =
      wide ? __ldg(static_cast<const long long*>(labels) + row * stride)
           : (long long)__ldg(static_cast<const int*>(labels) + row * stride);
  return lab >= 0 && lab < C ? (int)lab : -1;
}

// The class of a lane's slot k in the chunk that starts at `base`: F
// floats a lane, as F/4 float4 at vector lane + 32*(k/4) (VEC) or as F
// scalars at lane + 32*k.
template <int F, bool VEC>
__device__ __forceinline__ int class_of(int base, int lane, int k) {
  return VEC ? base + (lane + kWarp * (k / 4)) * 4 + k % 4
             : base + lane + kWarp * k;
}

// A lane's share of the chunk at `base`, every load issued before any
// use; slots past C hold -inf (they add 0 to the sum and never win the
// max).
template <int F, bool VEC>
__device__ __forceinline__ void load_chunk(const float* __restrict__ row,
                                           int base, int C, int lane,
                                           float (&v)[F]) {
  if (VEC) {  // C % 4 == 0 and the row 16-byte aligned
    const float4* r4 = reinterpret_cast<const float4*>(row + base);
#pragma unroll
    for (int k = 0; k < F / 4; ++k) {
      float4 q = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (class_of<F, VEC>(base, lane, 4 * k) < C)
        q = __ldg(r4 + lane + kWarp * k);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int c = class_of<F, VEC>(base, lane, k);
      v[k] = c < C ? __ldg(row + c) : -INFINITY;
    }
  }
}

// The row's max and sum of exp(x - max) over all chunks, identical on
// every lane. v ends holding exp(x - max) of the last chunk: of the row,
// where it is one chunk.
template <int F, bool VEC>
__device__ __forceinline__ void row_stats(const float* __restrict__ row,
                                          int C, int lane, float (&v)[F],
                                          float* m, float* s) {
  float mx = -INFINITY, sum = 0.f;
  for (int base = 0; base < C; base += kWarp * F) {
    load_chunk<F, VEC>(row, base, C, lane, v);
    float cm = -INFINITY;
#pragma unroll
    for (int k = 0; k < F; ++k) cm = fmaxf(cm, v[k]);
    const float nm = fmaxf(mx, warp_max(cm));
    float cs = 0.f;
#pragma unroll
    for (int k = 0; k < F; ++k) {
      v[k] = expf(v[k] - nm);
      cs += v[k];
    }
    cs = warp_sum(cs);
    sum = base == 0 ? cs : sum * expf(mx - nm) + cs;
    mx = nm;
  }
  *m = mx;
  *s = sum;
}

template <int F, bool VEC>
__global__ void __launch_bounds__(kWarp * kMaxRowsPerBlock) xent_fwd_kernel(
    const float* __restrict__ x, const void* __restrict__ labels, int wide,
    long long label_stride, float* __restrict__ loss, int B, int C) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y, lane = threadIdx.x;
  if (row >= B) return;  // whole warps leave together
  const float* xr = x + (long long)row * C;
  const int lab = label_of(labels, wide, label_stride, row, C);
  // Lane 0 loads the label's logit itself, beside the row's loads.
  const float picked = lane == 0 && lab >= 0 ? __ldg(xr + lab) : 0.f;
  float v[F], m, s;
  row_stats<F, VEC>(xr, C, lane, v, &m, &s);
  if (lane == 0) loss[row] = (logf(s) + m) - picked;
}

// dx of the chunk at `base` from e = exp(x - max) and 1/sum: one multiply
// a class where the reference divides (within 2 ulp of its softmax).
template <int F, bool VEC>
__device__ __forceinline__ void store_chunk(float* __restrict__ out, int base,
                                            int C, int lane, int lab,
                                            const float (&e)[F], float inv,
                                            float g) {
  float d[F];
#pragma unroll
  for (int k = 0; k < F; ++k) {
    const int c = class_of<F, VEC>(base, lane, k);
    d[k] = (e[k] * inv - (c == lab ? 1.f : 0.f)) * g;
  }
  if (VEC) {
    float4* o4 = reinterpret_cast<float4*>(out + base);
#pragma unroll
    for (int k = 0; k < F / 4; ++k)
      if (class_of<F, VEC>(base, lane, 4 * k) < C)
        o4[lane + kWarp * k] =
            make_float4(d[4 * k], d[4 * k + 1], d[4 * k + 2], d[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int c = class_of<F, VEC>(base, lane, k);
      if (c < C) out[c] = d[k];
    }
  }
}

template <int F, bool VEC>
__global__ void __launch_bounds__(kWarp * kMaxRowsPerBlock) xent_bwd_kernel(
    const float* __restrict__ x, const void* __restrict__ labels, int wide,
    long long label_stride, const float* __restrict__ g, long long g_stride,
    float* __restrict__ dx, int B, int C) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y, lane = threadIdx.x;
  if (row >= B) return;
  const int lab = label_of(labels, wide, label_stride, row, C);
  const float gr = __ldg(g + row * g_stride);
  const float* xr = x + (long long)row * C;
  float* out = dx + (long long)row * C;
  float v[F], m, s;
  row_stats<F, VEC>(xr, C, lane, v, &m, &s);
  const float inv = 1.f / s;
  if (C <= kWarp * F) {  // v holds the row's exp(x - max): one read
    store_chunk<F, VEC>(out, 0, C, lane, lab, v, inv, gr);
    return;
  }
  for (int base = 0; base < C; base += kWarp * F) {
    load_chunk<F, VEC>(xr, base, C, lane, v);
#pragma unroll
    for (int k = 0; k < F; ++k) v[k] = expf(v[k] - m);
    store_chunk<F, VEC>(out, base, C, lane, lab, v, inv, gr);
  }
}

// Floats a lane holds: the smallest of 1, 2, 4, 8, 16, 32 that holds the
// row (32 beyond, chunk by chunk); 16-byte loads take 4 at least.
int floats_per_lane(int C) {
  const int need = (C + kWarp - 1) / kWarp;
  return need <= 1 ? 0 : need <= 2 ? 1 : need <= 4 ? 2 : need <= 8 ? 3
         : need <= 16 ? 4 : 5;
}

// Rows (warps) a block: 8 where a row is a few classes a lane, 2 beyond
// (on an H100 at [128, 10], [128, 100] and [128, 1000] the faster of 1, 2,
// 4 and 8 by up to 0.1 us a call, PERF.md).
int rows_per_block(int C) { return C <= 128 ? 8 : 2; }

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

struct Args {
  const float* x;
  const void* labels;
  int wide;
  long long label_stride;
  const float* g;
  long long g_stride;
  float* out;
  int B, C;
  cudaStream_t stream;
};

template <int F, bool VEC>
cudaError_t launch_fwd(const Args& a) {
  const int rows = rows_per_block(a.C);
  xent_fwd_kernel<F, VEC><<<(a.B + rows - 1) / rows, dim3(kWarp, rows), 0,
                            a.stream>>>(a.x, a.labels, a.wide,
                                        a.label_stride, a.out, a.B, a.C);
  return cudaGetLastError();
}

template <int F, bool VEC>
cudaError_t launch_bwd(const Args& a) {
  const int rows = rows_per_block(a.C);
  xent_bwd_kernel<F, VEC><<<(a.B + rows - 1) / rows, dim3(kWarp, rows), 0,
                            a.stream>>>(a.x, a.labels, a.wide,
                                        a.label_stride, a.g, a.g_stride,
                                        a.out, a.B, a.C);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const Args&);
// [VEC][floats_per_lane]; 16-byte loads from 4 floats a lane up.
constexpr Launch kFwd[2][6] = {
    {launch_fwd<1, false>, launch_fwd<2, false>, launch_fwd<4, false>,
     launch_fwd<8, false>, launch_fwd<16, false>,
     launch_fwd<kMaxPerLane, false>},
    {launch_fwd<1, false>, launch_fwd<2, false>, launch_fwd<4, true>,
     launch_fwd<8, true>, launch_fwd<16, true>,
     launch_fwd<kMaxPerLane, true>}};
constexpr Launch kBwd[2][6] = {
    {launch_bwd<1, false>, launch_bwd<2, false>, launch_bwd<4, false>,
     launch_bwd<8, false>, launch_bwd<16, false>,
     launch_bwd<kMaxPerLane, false>},
    {launch_bwd<1, false>, launch_bwd<2, false>, launch_bwd<4, true>,
     launch_bwd<8, true>, launch_bwd<16, true>,
     launch_bwd<kMaxPerLane, true>}};

}  // namespace

// logits: B*C floats, row-major; labels: B int32 (wide = 0) or int64
// (wide = 1) at `label_stride` elements apart; loss: B floats. One launch.
extern "C" int tr_xent_fwd(const void* logits, const void* labels, int wide,
                           long long label_stride, void* loss, int B, int C,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || C <= 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const Args a{static_cast<const float*>(logits), labels, wide, label_stride,
               nullptr, 0, static_cast<float*>(loss), B, C,
               static_cast<cudaStream_t>(stream)};
  return kFwd[C % 4 == 0 && aligned16(logits)][floats_per_lane(C)](a);
}

// logits, dx: B*C floats, row-major; labels as tr_xent_fwd's; g: B floats
// at `g_stride` elements apart (0: one value for every row). One launch.
extern "C" int tr_xent_bwd(const void* logits, const void* labels, int wide,
                           long long label_stride, const void* g,
                           long long g_stride, void* dx, int B, int C,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || C <= 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const Args a{static_cast<const float*>(logits), labels, wide, label_stride,
               static_cast<const float*>(g), g_stride, static_cast<float*>(dx),
               B, C, static_cast<cudaStream_t>(stream)};
  return kBwd[C % 4 == 0 && aligned16(logits) && aligned16(dx)]
             [floats_per_lane(C)](a);
}
