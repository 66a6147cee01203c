// Fused ResNet-v2 bottleneck block, forward with folded BN:
//   p2 = relu(s2 * (relu(s1 * x + b1) . W1) + b2)          1x1, 4f -> f
//   p3 = relu(s3 * conv3x3_SAME(p2, w2) + b3)                3x3, f -> f
//   y  = x + p3 . W3                                         1x1, f -> 4f
// for stride 1 and an identity shortcut. x and y are NHWC [B,H,W,4f] (f32 or
// bf16); W1 is f32 [4f,f], w2 f32 HWIO [3,3,f,f], W3 f32 [f,4f]; s1, b1 are
// f32 [4f], s2, b2, s3, b3 f32 [f]. All arithmetic is f32; y is stored in
// x's type.
//
// Replaces: tpu_resnet/ops/fused_bottleneck.py::_fwd_kernel (launched by
// bottleneck_fwd), which the eval path of every stride-1 identity bottleneck
// of width f in {64, 128, 256} runs when model.fused_blocks=true (10 blocks
// of ImageNet ResNet-50).
//
// Bound: arithmetic. Per pixel the block does 2*(2*4f*f + 9f^2) = 34f^2
// flops against 2*4f elements moved: at f=64, 139 kflop for 1 KB in bf16,
// and the math is f32 off the tensor cores (67 TFLOP/s on an H100), so
// operations, not bytes, set the bound (~0.1 ms per 16-image launch at every
// ResNet-50 stage, which all do the same work).
//
// Design: one thread block per (image, band of R output rows), so a batch of
// 16 gives over a hundred blocks at every ResNet-50 stage instead of 16. The
// block computes
//   1. p2 on the R+2 rows of the band and its one-row halo (the halo rows of
//      the reduce are recomputed by both neighbouring bands, as the TPU
//      kernel does). Rows outside the image are stored as zeros, not as
//      relu(b2): SAME padding pads p2 itself. p2 lives in shared memory, f32,
//      with a zero column on each side;
//   2. the 3x3 conv over that buffer, into p3 = relu(s3*mid+b3), also in
//      shared memory (R*W*f floats);
//   3. the 1x1 expand in four output-channel tiles of width f, adding x and
//      storing y straight to device memory.
// Neither intermediate touches device memory; x is read twice (the reduce,
// the residual), y written once. Each stage is a matrix product in
// 256-thread tiles: a thread owns 4 pixels x 8 channels in registers, reads
// its A operand as 16-byte vectors (a quarter warp shares one pixel, so
// those loads broadcast) and its B operand (the weights) from a staged
// [32 x f] chunk whose two 16-byte reads per row fall on distinct banks.
// Weight chunks (and, for the reduce, the chunk of relu(s1*x+b1)) are loaded
// into registers one chunk ahead and stored into the other of two shared
// buffers, so one __syncthreads per chunk suffices and the loads overlap
// the arithmetic. Weights stay in device memory (W1, W3 up to 1 MB, w2 up to
// 2.4 MB); L2 holds them for all blocks.
//
// R is picked per launch from {4, 2, 1}: a smaller band means more blocks
// but recomputes more halo rows (the reduce costs (R+2)/R of its share), so
// the launch takes the R with the least estimated time from the blocks per
// SM that the occupancy calculator allows.
//
// Known limit, the first thing to make fast: the products run on f32 FMAs.
// bf16 tensor cores (mma/wgmma) would raise the ceiling ~15x.

#include <algorithm>

#include "tile_fma.cuh"

namespace {

using namespace tr;

// Shared memory, in floats: p2 with halo rows and columns, then a region
// that holds the reduce's two A chunks and later p3, then two B chunks.
template <int F>
__host__ __device__ inline int p2_floats(int R, int W) {
  return (R + 2) * (W + 2) * F;
}
template <int F>
__host__ __device__ inline int mid_floats(int R, int W) {
  return R * W * F > 2 * Tile<F>::BM * kKC ? R * W * F : 2 * Tile<F>::BM * kKC;
}
template <int F>
inline size_t smem_bytes(int R, int W) {
  return sizeof(float) *
         (size_t)(p2_floats<F>(R, W) + mid_floats<F>(R, W) + 2 * kKC * F);
}

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    bottleneck_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                          const float* __restrict__ w2,
                          const float* __restrict__ w3,
                          const float* __restrict__ s1,
                          const float* __restrict__ b1,
                          const float* __restrict__ s2,
                          const float* __restrict__ b2,
                          const float* __restrict__ s3,
                          const float* __restrict__ b3, T* __restrict__ y,
                          int H, int W, int R, int bands) {
  using TL = Tile<F>;
  constexpr int C4 = 4 * F;
  extern __shared__ __align__(16) float smem[];
  float* p2 = smem;                               // [R+2][W+2][F]
  float* mid = p2 + p2_floats<F>(R, W);           // A chunks, then p3 [R*W][F]
  float* bbuf = mid + mid_floats<F>(R, W);        // [2][kKC][F]

  const int tid = threadIdx.x;
  const int tx = tid % TL::TX, ty = tid / TL::TX;
  const int img = blockIdx.x / bands;
  const int r0 = (blockIdx.x % bands) * R;  // first output row of the band
  const int WP = W + 2;
  const T* xi = x + (long long)img * H * W * C4;
  T* yi = y + (long long)img * H * W * C4;
  float acc[kTM][kTN];
  const float* a[kTM];
  BChunk<F> bc;

  // Zero p2's halo columns; the reduce writes every other position.
  for (int i = tid; i < (R + 2) * 2 * F; i += kThreads) {
    const int e = i / (2 * F), side = (i / F) & 1, ch = i % F;
    p2[(e * WP + side * (W + 1)) * F + ch] = 0.f;
  }

  // 1. Reduce: c1 = relu(s1*x+b1) . W1 over the R+2 rows r0-1 .. r0+R.
  {
    const int M = (R + 2) * W;
    constexpr int NK = C4 / kKC;
    float* abuf = mid;  // [2][BM][kKC]
    float4 ar[TL::AG];
    // The chunk of x (4 channels of one pixel per float4), zero outside the
    // image: those rows are masked again below, this only keeps them finite.
    auto load_a = [&](int m0, int k0) {
#pragma unroll
      for (int q = 0; q < TL::AG; ++q) {
        const int idx = tid + q * kThreads;
        const int m = m0 + idx / (kKC / 4);
        const int g = r0 - 1 + m / W;
        ar[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < M && g >= 0 && g < H)
          ar[q] = load4(xi + ((long long)g * W + m % W) * C4 + k0 +
                        (idx % (kKC / 4)) * 4);
      }
    };
    auto store_a = [&](float* buf, int k0) {
#pragma unroll
      for (int q = 0; q < TL::AG; ++q) {
        const int idx = tid + q * kThreads;
        const int c = k0 + (idx % (kKC / 4)) * 4;
        store4(buf + idx * 4, sbr4(ar[q], load4(s1 + c), load4(b1 + c)));
      }
    };
    for (int m0 = 0; m0 < M; m0 += TL::BM) {
      zero(acc);
      load_a(m0, 0);
      bc.load(w1, F, tid);
      store_a(abuf, 0);
      bc.store(bbuf, tid);
      __syncthreads();
      for (int kc = 0; kc < NK; ++kc) {
        const int cur = kc & 1;
        if (kc + 1 < NK) {
          load_a(m0, (kc + 1) * kKC);
          bc.load(w1 + (kc + 1) * kKC * F, F, tid);
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          a[i] = abuf + cur * TL::BM * kKC + (ty * kTM + i) * kKC;
        fma_chunk<F>(a, bbuf + cur * kKC * F, tx, acc);
        if (kc + 1 < NK) {
          store_a(abuf + (cur ^ 1) * TL::BM * kKC, (kc + 1) * kKC);
          bc.store(bbuf + (cur ^ 1) * kKC * F, tid);
        }
        __syncthreads();
      }
      // p2 = relu(s2*c1+b2) inside the image, 0 on rows outside it.
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int m = m0 + ty * kTM + i;
        if (m >= M) continue;
        const int e = m / W, g = r0 - 1 + e;
        const bool inside = g >= 0 && g < H;
        float* dst = p2 + (e * WP + m % W + 1) * F;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = chan<F>(tx, 4 * h);
          float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                 acc[i][4 * h + 2], acc[i][4 * h + 3]);
          v = inside ? sbr4(v, load4(s2 + c), load4(b2 + c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
          store4(dst + c, v);
        }
      }
    }
  }

  // 2. The 3x3 conv over p2 (K = 9F, one tap per F/kKC chunks), into p3.
  const int M = R * W;
  {
    constexpr int NK = 9 * F / kKC;
    for (int m0 = 0; m0 < M; m0 += TL::BM) {
      zero(acc);
      int base[kTM];  // p2 offset of each pixel's top-left tap
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int m = min(m0 + ty * kTM + i, M - 1);
        base[i] = ((m / W) * WP + m % W) * F;
      }
      bc.load(w2, F, tid);
      bc.store(bbuf, tid);
      __syncthreads();  // also orders the reduce's p2 stores before reads
      for (int kc = 0; kc < NK; ++kc) {
        const int cur = kc & 1;
        if (kc + 1 < NK) bc.load(w2 + (kc + 1) * kKC * F, F, tid);
        const int tap = kc * kKC / F, ci0 = kc * kKC % F;
        const int off = ((tap / 3) * WP + tap % 3) * F + ci0;
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = p2 + base[i] + off;
        fma_chunk<F>(a, bbuf + cur * kKC * F, tx, acc);
        if (kc + 1 < NK) bc.store(bbuf + (cur ^ 1) * kKC * F, tid);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int m = m0 + ty * kTM + i;
        if (m >= M) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = chan<F>(tx, 4 * h);
          const float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                       acc[i][4 * h + 2], acc[i][4 * h + 3]);
          store4(mid + m * F + c, sbr4(v, load4(s3 + c), load4(b3 + c)));
        }
      }
    }
  }

  // 3. Expand: y = x + p3 . W3, in output-channel tiles of width F.
  {
    constexpr int NK = F / kKC;
    for (int nt = 0; nt < 4; ++nt) {
      const float* w3t = w3 + nt * F;
      for (int m0 = 0; m0 < M; m0 += TL::BM) {
        zero(acc);
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          a[i] = mid + min(m0 + ty * kTM + i, M - 1) * F;
        bc.load(w3t, C4, tid);
        bc.store(bbuf, tid);
        __syncthreads();  // also orders the conv's p3 stores before reads
        for (int kc = 0; kc < NK; ++kc) {
          const int cur = kc & 1;
          if (kc + 1 < NK) bc.load(w3t + (kc + 1) * kKC * C4, C4, tid);
          fma_chunk<F>(a, bbuf + cur * kKC * F, tx, acc);
#pragma unroll
          for (int i = 0; i < kTM; ++i) a[i] += kKC;
          if (kc + 1 < NK) bc.store(bbuf + (cur ^ 1) * kKC * F, tid);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int m = m0 + ty * kTM + i;
          const int g = r0 + m / W;
          if (m >= M || g >= H) continue;
          const long long o = ((long long)g * W + m % W) * C4 + nt * F;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = chan<F>(tx, 4 * h);
            const float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                         acc[i][4 * h + 2], acc[i][4 * h + 3]);
            store4(yi + o + c, add4(load4(xi + o + c), v));
          }
        }
      }
    }
  }
}

// Rows per band: the R in {4, 2, 1} with the least estimated time. A block
// does W*F^2 * (4(R+2) + 13R) multiply-adds (reduce over R+2 rows, 3x3 and
// expand over R); blocks run in waves of (SMs x blocks per SM), and blocks
// that share an SM share its arithmetic.
template <typename T, int F>
int pick_rows(int B, int H, int W, int sms) {
  auto kernel = bottleneck_fwd_kernel<T, F>;
  int best = 0;
  long long best_cost = 0;
  for (int R : {4, 2, 1}) {
    const size_t smem = smem_bytes<F>(R, W);
    if (smem > (size_t)kMaxSmem) continue;
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem) !=
            cudaSuccess ||
        per_sm < 1)
      continue;
    const long long blocks = (long long)B * ((H + R - 1) / R);
    const long long slots = (long long)per_sm * sms;
    const long long waves = (blocks + slots - 1) / slots;
    const long long share = std::min<long long>(per_sm, (blocks + sms - 1) / sms);
    const long long cost = waves * share * (4 * (R + 2) + 13 * R);
    if (best == 0 || cost < best_cost) best = R, best_cost = cost;
  }
  return best;
}

template <typename T, int F>
cudaError_t launch(const void* x, const void* const* p, void* y, int B, int H,
                   int W, int device, cudaStream_t stream) {
  auto kernel = bottleneck_fwd_kernel<T, F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int R = pick_rows<T, F>(B, H, W, sms);
  if (R == 0) return cudaErrorInvalidValue;
  const int bands = (H + R - 1) / R;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  kernel<<<B * bands, kThreads, smem_bytes<F>(R, W), stream>>>(
      static_cast<const T*>(x), f(p[0]), f(p[1]), f(p[2]), f(p[3]), f(p[4]),
      f(p[5]), f(p[6]), f(p[7]), f(p[8]), static_cast<T*>(y), H, W, R, bands);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_f(const void* x, const void* const* p, void* y, int B,
                       int H, int W, int F, int device, cudaStream_t st) {
  switch (F) {
    case 64:
      return launch<T, 64>(x, p, y, B, H, W, device, st);
    case 128:
      return launch<T, 128>(x, p, y, B, H, W, device, st);
    case 256:
      return launch<T, 256>(x, p, y, B, H, W, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [B,H,W,4F] of `dtype` (tr::DType), contiguous, 16-byte aligned;
// w1 [4F,F], w2 [3,3,F,F], w3 [F,4F], s1, b1 [4F], s2, b2, s3, b3 [F]: f32,
// contiguous, 16-byte aligned. F is 64, 128 or 256 and a one-row band must
// fit in shared memory. Returns the cudaError_t.
extern "C" int tr_bottleneck_fwd(const void* x, const void* w1, const void* w2,
                                 const void* w3, const void* s1,
                                 const void* b1, const void* s2,
                                 const void* b2, const void* s3,
                                 const void* b3, void* y, int B, int H, int W,
                                 int F, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || H < 1 || W < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const void* p[9] = {w1, w2, w3, s1, b1, s2, b2, s3, b3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return dispatch_f<float>(x, p, y, B, H, W, F, device, st);
    case tr::kBFloat16:
      return dispatch_f<__nv_bfloat16>(x, p, y, B, H, W, F, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}
