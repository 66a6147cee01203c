// Fused ResNet-v2 bottleneck: with live batch-norm statistics, the two moment
// passes of the training forward and the four backward passes; with folded
// (frozen) batch norm, the one backward pass. Stride 1,
// identity shortcut, 3x3 SAME; x is NHWC [B,H,W,4F] (f32 or bf16), gy f32 of
// x's shape, W1 f32 [4F,F], w2 f32 HWIO [3,3,F,F], W3 f32 [F,4F], BN vectors
// f32 ([4F] for BN1, [F] for BN2 and BN3). All arithmetic is f32.
//
// Replaces, in tpu_resnet/ops/fused_bottleneck.py (bottleneck_train_apply,
// which every stride-1 identity bottleneck of width 64, 128 or 256 runs in
// training when model.fused_blocks=true: 10 blocks of ImageNet ResNet-50):
//   mode 0 stats_a  _stats_a_kernel: sum c1, sum c1^2, c1 = p1 . W1;
//   mode 1 stats_b  _stats_b_kernel: sum mid, sum mid^2, mid = conv3x3(p2);
//   mode 2 bwd1     _train_bwd_calls pass1: T3a = sum dm3, T3b = sum dm3*mhat,
//                   and p3 for dw3 = sum p3^T gy;
//   mode 3 bwd2     pass2: T2a = sum dm2, T2b = sum dm2*chat, and p2, dmid for
//                   dw2 = sum p2-patch^T dmid;
//   mode 4 bwd3     pass3: T1a = sum dm1, T1b = sum dm1*x1hat, and dc1 for
//                   dw1 = sum p1^T dc1;
//   mode 5 bwd4     pass4: dx = gy + g1*i1*(dm1 - T1a/n - x1hat*(T1b/n)).
// and (bottleneck_apply, the folded-BN bottleneck under a gradient: the
// eval-mode model differentiated, tools/fused_bottleneck_ab.py's fwd_bwd arm):
//   mode 6 bwd      _bwd_kernel: dx, the six BN sums and the operands p3, p2,
//                   dmid, dc1 of dW3 = sum p3^T gy, dw2 = sum p2-patch^T dmid,
//                   dW1 = sum p1^T dc1, in one pass.
// The chain, recomputed from x and the saved moments (i = 1/sigma), as the
// reference's _chain_train / _chain_train_full:
//   x1hat = (x-mu1)*i1, m1 = g1*x1hat + be1, p1 = relu(m1), c1 = p1 . W1,
//   chat = (c1-mu2)*i2, m2 = g2*chat + be2, p2 = relu(m2) (0 outside the
//   image), mid = conv3x3(p2, w2), mhat = (mid-mu3)*i3, m3 = g3*mhat + be3,
//   p3 = relu(m3);
// and the backward: dm3 = (gy . W3^T)*[m3>0], dmid = g3*i3*(dm3 - T3a/n -
// mhat*(T3b/n)) (0 outside the image), dm2 = convT(dmid, w2)*[m2>0], dc1 =
// g2*i2*(dm2 - T2a/n - chat*(T2b/n)), dm1 = (dc1 . W1^T)*[m1>0]. Mode 6 runs
// the same chain on the folded affines, as the reference's _chain_fwd and
// _bwd_kernel: m1 = x*s1 + b1, m2 = c1*s2 + b2, m3 = mid*s3 + b3, and with
// no correction terms dmid = dm3*s3, dc1 = dm2*s2, dx = gy + dm1*s1; its
// sums are db = sum dm and ds = sum dm*v, v the BN's input (x, c1, mid).
// The kernel reads s, b where the live modes read g, be; where they hold a
// normalised value (chat, mhat, x1hat) it holds the raw one. Every
// elementwise formula rounds as written (__fmul_rn, __fadd_rn, no FMA
// contraction), as the plain PyTorch version does, so a mask [m > 0] agrees
// with the plain version's wherever the products do. stats_a normalises as
// the reference's _stats_a_kernel rounds it: (g1*(x-mu1))*i1 + be1.
//
// Bound: arithmetic. Per centre pixel, c1 is 8F^2 flops, mid 18F^2, gy . W3^T
// 8F^2, convT 18F^2, dc1 . W1^T 8F^2 and each weight gradient 8F^2 (dw1,
// dw3) or 18F^2 (dw2): 8, 26, 42, 70, 68 and 60 F^2 for the six, and 94F^2
// for mode 6 with its three weight gradients, against
// ~2*4F elements moved, on f32 FMAs (67 TFLOP/s on an H100). H*W*F^2 is the
// same at every ResNet-50 stage, so each pass has one bound per launch at
// all three stages (0.20 to 1.72 ms at B=128).
//
// Design: the row kernel. One thread block per (image, band of R output
// rows), as bottleneck_fwd (csrc/fused_bottleneck.cu), with its register-
// tiled products (tile_fma.cuh). The band recomputes the chain on its rows
// and a halo: none for stats_a, one row for stats_b and bwd1 (the 3x3 needs
// p2 at +-1), two for bwd2-4 and mode 6 (convT needs dmid at +-1, hence mid
// at +-1 and
// p2 at +-2); halo rows are recomputed by both neighbours, as the TPU kernel
// does. Phases, each a product into registers with an elementwise epilogue:
//   A  c1 over the E = R + 2*halo rows: p2 into shared memory (zero rows
//      outside the image, zero side columns), chat of the centre rows;
//   B  mid = conv3x3(p2) over E-2 rows: mhat into shared memory (or, for
//      stats_b, the sums);
//   C  gy . W3^T over the same rows: dm3, then dmid in place of mhat (zeroed
//      outside the image, where the correction terms are not zero);
//   D  dp2 = convT(dmid) over the R centre rows: dm2, then dc1 in place of
//      chat;
//   E  dc1 . W1^T in four tiles of F output channels: dm1, then T1 or dx.
// Mode 6 runs all five phases: C gives dmid and the BN3 sums on the centre
// rows, D dc1 and the BN2 sums, E dx and the BN1 sums.
// Neither intermediate is written to device memory except the one operand
// each weight gradient needs (p3, p2 and dmid, dc1: [B,H,W,F] f32 scratch).
// The A operand of a reduce phase (x or gy, 4F channels) streams from device
// memory in chunks staged through a shared buffer that is free in that
// phase. R is picked per launch from {4, 2, 1} for the least estimated time,
// among those whose buffers fit in shared memory.
//
// Design: the weight gradients. dw = A^T B summed over all B*H*W pixels is a
// product whose long dimension is the pixels. bottleneck_wgrad_kernel tiles
// the output into 64x64 blocks (a thread owns 4x4) and splits the pixels
// into a fixed number of chunks chosen from the shapes, one block per (tile,
// chunk); A is p3 (dw3), p2 shifted by the tap with SAME zero padding (dw2,
// one grid slice per tap) or p1 = relu(g1*x1hat + be1) computed from x as it
// is loaded (dw1); B is gy, dmid or dc1. Mode 6's dW1 passes (g1, be1, mu1,
// i1) = (s1, b1, 0, 1): bn_relu rounds g*((v-0)*1) + be, and v-0 and v*1
// are exact, so p1 is relu(x*s1 + b1) bit for bit.
//
// Sums without atomics: the row kernel writes one row of channel sums per
// block, the weight-gradient kernel one partial product per chunk, and
// bottleneck_sum_kernel adds them in block order. Inside a block each channel sum adds
// the thread's pixels in order, then the threads in order. Two calls agree
// bit for bit.
//
// Known limit, the first thing to make fast: every product runs on f32 FMAs;
// the recomputed halo costs up to 5x the centre rows' c1 at F=256 (R=1).

#include <algorithm>

#include "tile_fma.cuh"

namespace {

using namespace tr;

enum Mode : int {
  kStatsA = 0,
  kStatsB = 1,
  kBwd1 = 2,
  kBwd2 = 3,
  kBwd3 = 4,
  kBwd4 = 5,
  kBwd = 6  // the frozen-BN backward
};
enum AMode : int { kRows = 0, kShifted = 1, kBnRelu = 2 };

struct Args {
  const void* x;      // [B,H,W,4F]
  const float* gy;    // [B,H,W,4F]
  const float* w1;    // [4F,F]
  const float* w2;    // [3,3,F,F] HWIO
  const float* w2t;   // [3,3,F,F]: w2 flipped in space, in/out swapped
  const float* w3t;   // [4F,F]: W3 transposed
  const float* w1t;   // [F,4F]: W1 transposed
  const float* v[12];  // g1 be1 mu1 i1 ([4F]) g2 be2 mu2 i2 g3 be3 mu3 i3
  const float* t[6];   // T3a T3b T2a T2b T1a T1b
  float* part;        // [blocks][row_len] channel sums
  float* out;         // [row_len] their sum
  float* s0;          // [B,H,W,F] scratch: p3 (bwd1), p2 (bwd2, bwd),
                      // dc1 (bwd3)
  float* s1;          // [B,H,W,F] scratch: dmid (bwd2, bwd)
  void* dx;           // [B,H,W,4F] (bwd4, bwd)
  float* s2;          // [B,H,W,F] scratch: p3 (bwd)
  float* s3;          // [B,H,W,F] scratch: dc1 (bwd)
  int H, W, R, bands;
  float n;  // B*H*W
};

__host__ __device__ constexpr int halo(int mode) {
  return mode == kStatsA ? 0 : mode <= kBwd1 ? 1 : 2;
}
__host__ __device__ constexpr int row_len(int mode, int F) {
  return mode == kBwd    ? 12 * F
         : mode == kBwd4 ? 0
         : mode == kBwd3 ? 8 * F
                         : 2 * F;
}

// Shared memory, in floats: region 0 holds p2 [E][W+2][F], later the staged
// gy chunks and the channel-sum reduction; region 1 mhat, then dmid, [E-2]
// [W+2][F] (first the staged x chunks); region 2 chat, then dc1, [R][W][F];
// region 3 two staged weight chunks.
struct Layout {
  int o1, o2, o3, total;
};
template <int F>
__host__ __device__ inline Layout layout(int mode, int R, int W) {
  const int E = R + 2 * halo(mode), WP = W + 2;
  const int stage = 2 * Tile<F>::BM * kKC, red = 2 * kThreads * kTN;
  int s0 = mode == kStatsA ? 0 : E * WP * F;
  s0 = s0 > stage ? s0 : stage;
  s0 = s0 > red ? s0 : red;
  int s1 = mode >= kBwd1 ? (E - 2) * WP * F : 0;
  s1 = s1 > stage ? s1 : stage;
  const int s2 = mode >= kBwd2 ? R * W * F : 0;
  return {s0, s0 + s1, s0 + s1 + s2, s0 + s1 + s2 + 2 * kKC * F};
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 f4(const float (&o)[4]) {
  return make_float4(o[0], o[1], o[2], o[3]);
}
// relu(g*((v-m)*i) + b): the training chain's BN+ReLU, rounded as written.
__device__ __forceinline__ float bn_relu(float v, float m, float i, float g,
                                         float b) {
  return fmaxf(add(mul(g, mul(sub(v, m), i)), b), 0.f);
}

// Rows [0, nrows) of a band, 4F -> F: acc = xf(src) . Bm, where band row e is
// image row g0 + e (A is zero outside the image) and Bm is [4F][F]. The A
// chunks pass through xf(float4, first channel) on their way to `abuf`
// (2*BM*kKC floats). epi(m, h, c, v) gets pixel m of the band and the
// thread's channels c..c+3, c = chan(tx, 4h).
template <int F, typename T, class Xf, class Epi>
__device__ __forceinline__ void reduce_rows(const T* __restrict__ src, int g0,
                                            int nrows, int H, int W,
                                            const float* __restrict__ Bm,
                                            float* abuf, float* bbuf, Xf xf,
                                            Epi epi) {
  using TL = Tile<F>;
  constexpr int C4 = 4 * F;
  constexpr int NK = C4 / kKC;
  const int tid = threadIdx.x, tx = tid % TL::TX, ty = tid / TL::TX;
  const int M = nrows * W;
  float acc[kTM][kTN];
  const float* a[kTM];
  BChunk<F> bc;
  float4 ar[TL::AG];
  auto load_a = [&](int m0, int k0) {
#pragma unroll
    for (int q = 0; q < TL::AG; ++q) {
      const int idx = tid + q * kThreads;
      const int m = m0 + idx / (kKC / 4);
      const int g = g0 + m / W;
      ar[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && g >= 0 && g < H)
        ar[q] = load4(src + ((long long)g * W + m % W) * C4 + k0 +
                      (idx % (kKC / 4)) * 4);
    }
  };
  auto store_a = [&](float* buf, int k0) {
#pragma unroll
    for (int q = 0; q < TL::AG; ++q) {
      const int idx = tid + q * kThreads;
      store4(buf + idx * 4, xf(ar[q], k0 + (idx % (kKC / 4)) * 4));
    }
  };
  for (int m0 = 0; m0 < M; m0 += TL::BM) {
    zero(acc);
    load_a(m0, 0);
    bc.load(Bm, F, tid);
    store_a(abuf, 0);
    bc.store(bbuf, tid);
    __syncthreads();
    for (int kc = 0; kc < NK; ++kc) {
      const int cur = kc & 1;
      if (kc + 1 < NK) {
        load_a(m0, (kc + 1) * kKC);
        bc.load(Bm + (kc + 1) * kKC * F, F, tid);
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
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + ty * kTM + i;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(m, h, chan<F>(tx, 4 * h),
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]));
    }
  }
}

// The 3x3 over a padded plane `in` [nrows+2][W+2][F] (weights Bm [9F][F],
// one tap per F/kKC chunks): output row e reads plane rows e..e+2.
template <int F, class Epi>
__device__ __forceinline__ void conv_rows(const float* in, int nrows, int W,
                                          const float* __restrict__ Bm,
                                          float* bbuf, Epi epi) {
  using TL = Tile<F>;
  constexpr int NK = 9 * F / kKC;
  const int tid = threadIdx.x, tx = tid % TL::TX, ty = tid / TL::TX;
  const int M = nrows * W, WP = W + 2;
  float acc[kTM][kTN];
  const float* a[kTM];
  BChunk<F> bc;
  for (int m0 = 0; m0 < M; m0 += TL::BM) {
    zero(acc);
    int base[kTM];  // plane offset of each pixel's top-left tap
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = min(m0 + ty * kTM + i, M - 1);
      base[i] = ((m / W) * WP + m % W) * F;
    }
    bc.load(Bm, F, tid);
    bc.store(bbuf, tid);
    __syncthreads();
    for (int kc = 0; kc < NK; ++kc) {
      const int cur = kc & 1;
      if (kc + 1 < NK) bc.load(Bm + (kc + 1) * kKC * F, F, tid);
      const int tap = kc * kKC / F, ci0 = kc * kKC % F;
      const int off = ((tap / 3) * WP + tap % 3) * F + ci0;
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = in + base[i] + off;
      fma_chunk<F>(a, bbuf + cur * kKC * F, tx, acc);
      if (kc + 1 < NK) bc.store(bbuf + (cur ^ 1) * kKC * F, tid);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + ty * kTM + i;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(m, h, chan<F>(tx, 4 * h),
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]));
    }
  }
}

// M pixels of `in` [M][F] (shared) times F columns of a row-major [F][ld]
// matrix starting at Bm.
template <int F, class Epi>
__device__ __forceinline__ void expand_rows(const float* in, int M,
                                            const float* __restrict__ Bm,
                                            int ld, float* bbuf, Epi epi) {
  using TL = Tile<F>;
  constexpr int NK = F / kKC;
  const int tid = threadIdx.x, tx = tid % TL::TX, ty = tid / TL::TX;
  float acc[kTM][kTN];
  const float* a[kTM];
  BChunk<F> bc;
  for (int m0 = 0; m0 < M; m0 += TL::BM) {
    zero(acc);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      a[i] = in + min(m0 + ty * kTM + i, M - 1) * F;
    bc.load(Bm, ld, tid);
    bc.store(bbuf, tid);
    __syncthreads();
    for (int kc = 0; kc < NK; ++kc) {
      const int cur = kc & 1;
      if (kc + 1 < NK) bc.load(Bm + (kc + 1) * kKC * ld, ld, tid);
      fma_chunk<F>(a, bbuf + cur * kKC * F, tx, acc);
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] += kKC;
      if (kc + 1 < NK) bc.store(bbuf + (cur ^ 1) * kKC * F, tid);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + ty * kTM + i;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(m, h, chan<F>(tx, 4 * h),
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]));
    }
  }
}

// The block's two sums of each of F channels: thread (tx, ty) holds
// channels chan(tx, j); channel c adds the TY threads of its tx in order.
// Writes first[c] and second[c]; `red` is 2*kThreads*kTN free floats.
template <int F>
__device__ __forceinline__ void flush_sums(float (&sa)[kTN], float (&sb)[kTN],
                                           float* red, float* first,
                                           float* second) {
  using TL = Tile<F>;
  const int tid = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    red[tid * kTN + j] = sa[j];
    red[(kThreads + tid) * kTN + j] = sb[j];
    sa[j] = sb[j] = 0.f;
  }
  __syncthreads();
  for (int k = tid; k < 2 * F; k += kThreads) {
    const int which = k / F, c = k % F;
    const int tx = (c % (F / 2)) / 4, j = (c < F / 2 ? 0 : 4) + c % 4;
    float s = 0.f;
    for (int r = 0; r < TL::TY; ++r)
      s += red[(which * kThreads + r * TL::TX + tx) * kTN + j];
    (which ? second : first)[c] = s;
  }
  __syncthreads();
}

template <typename T, int F, int MODE>
__device__ __forceinline__ void train_body(const Args& a) {
  constexpr int C4 = 4 * F;
  constexpr int HALO = halo(MODE);
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, W = a.W, R = a.R, WP = W + 2;
  const int E = R + 2 * HALO;
  const Layout L = layout<F>(MODE, R, W);
  float* reg0 = smem;            // p2; staged gy; reduction
  float* reg1 = smem + L.o1;     // staged x; mhat -> dmid
  float* reg2 = smem + L.o2;     // chat -> dc1
  float* bbuf = smem + L.o3;
  const int tid = threadIdx.x;
  const int img = blockIdx.x / a.bands;
  const int r0 = (blockIdx.x % a.bands) * R;  // first centre row
  const long long pix0 = (long long)img * H * W;
  const T* xi = static_cast<const T*>(a.x) + pix0 * C4;
  float* prow = a.part + (long long)blockIdx.x * row_len(MODE, F);
  const float *g1 = a.v[0], *be1 = a.v[1], *mu1 = a.v[2], *i1 = a.v[3];
  const float *g2 = a.v[4], *be2 = a.v[5], *mu2 = a.v[6], *i2 = a.v[7];
  const float *g3 = a.v[8], *be3 = a.v[9], *mu3 = a.v[10], *i3 = a.v[11];
  float sa[kTN], sb[kTN];  // the thread's channel sums
#pragma unroll
  for (int j = 0; j < kTN; ++j) sa[j] = sb[j] = 0.f;
  auto sum2 = [&](int h, int q, float u, float w) {
    sa[4 * h + q] += u;
    sb[4 * h + q] = fmaf(u, w, sb[4 * h + q]);
  };

  // Zero the side columns of a padded plane of `rows` rows (SAME padding).
  auto zero_sides = [&](float* plane, int rows) {
    for (int i = tid; i < rows * 2 * F; i += kThreads) {
      const int e = i / (2 * F), side = (i / F) & 1, ch = i % F;
      plane[(e * WP + side * (W + 1)) * F + ch] = 0.f;
    }
  };
  if (MODE != kStatsA) zero_sides(reg0, E);

  // A. c1 = p1 . W1 over the E rows from r0 - HALO.
  if constexpr (MODE == kStatsA) {
    reduce_rows<F>(
        xi, r0, R, H, W, a.w1, reg1, bbuf,
        [&](float4 v, int c) {
          float o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            o[q] = fmaxf(add(mul(mul(__ldg(g1 + c + q),
                                     sub(at(v, q), __ldg(mu1 + c + q))),
                                 __ldg(i1 + c + q)),
                             __ldg(be1 + c + q)),
                         0.f);
          return f4(o);
        },
        [&](int m, int h, int c, float4 v) {
          if (r0 + m / W >= H) return;
#pragma unroll
          for (int q = 0; q < 4; ++q) sum2(h, q, at(v, q), at(v, q));
        });
  } else {
    reduce_rows<F>(
        xi, r0 - HALO, E, H, W, a.w1, reg1, bbuf,
        [&](float4 v, int c) {
          float o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            o[q] = MODE == kBwd
                       ? sbr(at(v, q), __ldg(g1 + c + q), __ldg(be1 + c + q))
                       : bn_relu(at(v, q), __ldg(mu1 + c + q),
                                 __ldg(i1 + c + q), __ldg(g1 + c + q),
                                 __ldg(be1 + c + q));
          return f4(o);
        },
        [&](int m, int h, int c, float4 v) {
          const int e = m / W, px = m % W, g = r0 - HALO + e;
          const bool inside = g >= 0 && g < H;
          float ch[4], p[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ch[q] = MODE == kBwd ? at(v, q)
                                 : mul(sub(at(v, q), __ldg(mu2 + c + q)),
                                       __ldg(i2 + c + q));
            p[q] = inside ? fmaxf(add(mul(__ldg(g2 + c + q), ch[q]),
                                      __ldg(be2 + c + q)),
                                  0.f)
                          : 0.f;
          }
          store4(reg0 + (e * WP + px + 1) * F + c, f4(p));
          if constexpr (MODE >= kBwd2) {
            const int ce = e - HALO;
            if (ce >= 0 && ce < R && inside) {
              store4(reg2 + (ce * W + px) * F + c, f4(ch));
              if (MODE == kBwd2 || MODE == kBwd)
                store4(a.s0 + (pix0 + (long long)g * W + px) * F + c, f4(p));
            }
          }
        });
  }

  // B. mid = conv3x3(p2) over E-2 rows.
  if constexpr (MODE >= kStatsB) {
    __syncthreads();
    // dmid's side columns, once phase A's x chunks have left region 1.
    if (MODE >= kBwd2) zero_sides(reg1, E - 2);
    conv_rows<F>(reg0, E - 2, W, a.w2, bbuf,
                 [&](int m, int h, int c, float4 v) {
                   const int e = m / W;
                   if constexpr (MODE == kStatsB) {
                     if (r0 + e >= H) return;
#pragma unroll
                     for (int q = 0; q < 4; ++q)
                       sum2(h, q, at(v, q), at(v, q));
                   } else {
                     float mh[4];
#pragma unroll
                     for (int q = 0; q < 4; ++q)
                       mh[q] = MODE == kBwd
                                   ? at(v, q)
                                   : mul(sub(at(v, q), __ldg(mu3 + c + q)),
                                         __ldg(i3 + c + q));
                     store4(reg1 + (e * WP + m % W + 1) * F + c, f4(mh));
                   }
                 });
  }

  // C. dp3 = gy . W3^T over the rows of mhat: dm3, then T3 or dmid.
  if constexpr (MODE >= kBwd1) {
    __syncthreads();
    const int g0 = r0 - (HALO - 1);
    const float n = a.n;
    reduce_rows<F>(
        a.gy + pix0 * C4, g0, E - 2, H, W, a.w3t, reg0, bbuf,
        [](float4 v, int) { return v; },
        [&](int m, int h, int c, float4 v) {
          const int e = m / W, px = m % W, g = g0 + e;
          const bool inside = g >= 0 && g < H;
          const bool centre = inside && e >= 1 && e <= R;  // HALO 2 modes
          float* mp = reg1 + (e * WP + px + 1) * F + c;
          float o[4], p3[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float mh = mp[q];
            const float m3 = add(mul(__ldg(g3 + c + q), mh), __ldg(be3 + c + q));
            const float dm3 = m3 > 0.f ? at(v, q) : 0.f;
            if constexpr (MODE == kBwd1) {
              if (inside) sum2(h, q, dm3, mh);
              o[q] = fmaxf(m3, 0.f);  // p3
            } else if constexpr (MODE == kBwd) {
              if (centre) sum2(h, q, dm3, mh);
              p3[q] = fmaxf(m3, 0.f);
              o[q] = inside ? mul(dm3, __ldg(g3 + c + q)) : 0.f;  // dmid
            } else {
              o[q] = inside
                         ? mul(mul(__ldg(g3 + c + q), __ldg(i3 + c + q)),
                               sub(sub(dm3, __fdiv_rn(__ldg(a.t[0] + c + q), n)),
                                   mul(mh, __fdiv_rn(__ldg(a.t[1] + c + q), n))))
                         : 0.f;  // dmid
            }
          }
          const long long so = (pix0 + (long long)g * W + px) * F + c;
          if constexpr (MODE == kBwd1) {
            if (inside) store4(a.s0 + so, f4(o));
          } else {
            store4(mp, f4(o));
            if ((MODE == kBwd2 || MODE == kBwd) && centre)
              store4(a.s1 + so, f4(o));
            if (MODE == kBwd && centre) store4(a.s2 + so, f4(p3));
          }
        });
  }
  if constexpr (MODE == kBwd1 || MODE == kStatsA || MODE == kStatsB)
    flush_sums<F>(sa, sb, reg0, prow, prow + F);
  if constexpr (MODE == kBwd)
    flush_sums<F>(sa, sb, reg0, prow + 10 * F, prow + 11 * F);

  // D. dp2 = convT(dmid) over the R centre rows: dm2, then T2 or dc1.
  if constexpr (MODE >= kBwd2) {
    __syncthreads();
    const float n = a.n;
    conv_rows<F>(
        reg1, R, W, a.w2t, bbuf, [&](int m, int h, int c, float4 v) {
          const int e = m / W, px = m % W, g = r0 + e;
          float* cp = reg2 + (e * W + px) * F + c;
          if (g >= H) {
            if (MODE != kBwd2) store4(cp, make_float4(0.f, 0.f, 0.f, 0.f));
            return;
          }
          float o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float ch = cp[q];
            const float m2 = add(mul(__ldg(g2 + c + q), ch), __ldg(be2 + c + q));
            const float dm2 = m2 > 0.f ? at(v, q) : 0.f;
            if constexpr (MODE == kBwd2) {
              sum2(h, q, dm2, ch);
            } else if constexpr (MODE == kBwd) {
              sum2(h, q, dm2, ch);
              o[q] = mul(dm2, __ldg(g2 + c + q));
            } else {
              o[q] = mul(mul(__ldg(g2 + c + q), __ldg(i2 + c + q)),
                         sub(sub(dm2, __fdiv_rn(__ldg(a.t[2] + c + q), n)),
                             mul(ch, __fdiv_rn(__ldg(a.t[3] + c + q), n))));
            }
          }
          if constexpr (MODE != kBwd2) {
            store4(cp, f4(o));  // dc1, in place of chat
            if (MODE == kBwd3 || MODE == kBwd)
              store4((MODE == kBwd ? a.s3 : a.s0) +
                         (pix0 + (long long)g * W + px) * F + c,
                     f4(o));
          }
        });
    if constexpr (MODE == kBwd2) flush_sums<F>(sa, sb, reg0, prow, prow + F);
    if constexpr (MODE == kBwd)
      flush_sums<F>(sa, sb, reg0, prow + 8 * F, prow + 9 * F);
  }

  // E. dp1 = dc1 . W1^T, in four tiles of F channels: dm1, then T1 or dx.
  if constexpr (MODE >= kBwd3) {
    const float n = a.n;
    for (int nt = 0; nt < 4; ++nt) {
      __syncthreads();
      expand_rows<F>(
          reg2, R * W, a.w1t + nt * F, C4, bbuf,
          [&](int m, int h, int c, float4 v) {
            const int g = r0 + m / W;
            if (g >= H) return;
            const long long o = (pix0 + (long long)g * W + m % W) * C4 +
                                nt * F + c;
            const int cc = nt * F + c;
            const float4 xv = load4(static_cast<const T*>(a.x) + o);
            float d[4];
            float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
            if constexpr (MODE != kBwd3) gv = load4(a.gy + o);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float xh = MODE == kBwd
                                   ? at(xv, q)
                                   : mul(sub(at(xv, q), __ldg(mu1 + cc + q)),
                                         __ldg(i1 + cc + q));
              const float m1 =
                  add(mul(__ldg(g1 + cc + q), xh), __ldg(be1 + cc + q));
              const float dm1 = m1 > 0.f ? at(v, q) : 0.f;
              if constexpr (MODE == kBwd3) {
                sum2(h, q, dm1, xh);
              } else if constexpr (MODE == kBwd) {
                sum2(h, q, dm1, xh);
                d[q] = add(at(gv, q), mul(dm1, __ldg(g1 + cc + q)));
              } else {
                d[q] = add(at(gv, q),
                           mul(mul(__ldg(g1 + cc + q), __ldg(i1 + cc + q)),
                               sub(sub(dm1,
                                       __fdiv_rn(__ldg(a.t[4] + cc + q), n)),
                                   mul(xh, __fdiv_rn(__ldg(a.t[5] + cc + q),
                                                     n)))));
              }
            }
            if constexpr (MODE != kBwd3)
              store4(static_cast<T*>(a.dx) + o, f4(d));
          });
      if constexpr (MODE == kBwd3 || MODE == kBwd)
        flush_sums<F>(sa, sb, reg0, prow + nt * F, prow + C4 + nt * F);
    }
  }
}

// One entry point per mode, so that a profile names the pass.
#define TR_ROW_KERNEL(name, MODE)                                 \
  template <typename T, int F>                                    \
  __global__ void __launch_bounds__(kThreads) name(const Args a) { \
    train_body<T, F, MODE>(a);                                    \
  }
TR_ROW_KERNEL(bottleneck_stats_a_kernel, kStatsA)
TR_ROW_KERNEL(bottleneck_stats_b_kernel, kStatsB)
TR_ROW_KERNEL(bottleneck_bwd1_kernel, kBwd1)
TR_ROW_KERNEL(bottleneck_bwd2_kernel, kBwd2)
TR_ROW_KERNEL(bottleneck_bwd3_kernel, kBwd3)
TR_ROW_KERNEL(bottleneck_bwd4_kernel, kBwd4)
TR_ROW_KERNEL(bottleneck_bwd_kernel, kBwd)
#undef TR_ROW_KERNEL

template <typename T, int F, int MODE>
auto row_kernel() {
  if constexpr (MODE == kStatsA) return bottleneck_stats_a_kernel<T, F>;
  else if constexpr (MODE == kStatsB) return bottleneck_stats_b_kernel<T, F>;
  else if constexpr (MODE == kBwd1) return bottleneck_bwd1_kernel<T, F>;
  else if constexpr (MODE == kBwd2) return bottleneck_bwd2_kernel<T, F>;
  else if constexpr (MODE == kBwd3) return bottleneck_bwd3_kernel<T, F>;
  else if constexpr (MODE == kBwd4) return bottleneck_bwd4_kernel<T, F>;
  else return bottleneck_bwd_kernel<T, F>;
}

// out[k] = sum over rows, in row order, of part[row][k].
__global__ void bottleneck_sum_kernel(const float* __restrict__ part,
                           float* __restrict__ out, int rows, long long L) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= L) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(long long)r * L + k];
  out[k] = s;
}

cudaError_t sum_rows(const float* part, float* out, int rows, long long L,
                     cudaStream_t st) {
  if (L == 0) return cudaSuccess;
  bottleneck_sum_kernel<<<(unsigned)((L + 255) / 256), 256, 0, st>>>(
      part, out, rows, L);
  return cudaGetLastError();
}

// Chunks (BM pixels x kKC x F) a block of band R multiplies through.
template <int F>
long long block_work(int mode, int R, int W) {
  const int E = R + 2 * halo(mode);
  auto tiles = [&](int rows) {
    return (long long)(rows * W + Tile<F>::BM - 1) / Tile<F>::BM;
  };
  long long w = tiles(mode == kStatsA ? R : E) * 4 * F / kKC;
  if (mode >= kStatsB) w += tiles(E - 2) * 9 * F / kKC;
  if (mode >= kBwd1) w += tiles(E - 2) * 4 * F / kKC;
  if (mode >= kBwd2) w += tiles(R) * 9 * F / kKC;
  if (mode >= kBwd3) w += 4 * tiles(R) * F / kKC;
  return w;
}

template <typename T, int F, int MODE>
cudaError_t launch_rows(Args a, int B, int device, cudaStream_t st) {
  auto kernel = row_kernel<T, F, MODE>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // The band height with the least estimated time: waves of (SMs x blocks
  // per SM), blocks sharing an SM sharing its arithmetic.
  int best = 0;
  long long best_cost = 0;
  for (int R : {4, 2, 1}) {
    const size_t smem = sizeof(float) * layout<F>(MODE, R, a.W).total;
    int per_sm = 0;
    if (smem > (size_t)kMaxSmem ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem) !=
            cudaSuccess ||
        per_sm < 1)
      continue;
    const long long blocks = (long long)B * ((a.H + R - 1) / R);
    const long long slots = (long long)per_sm * sms;
    const long long share =
        std::min<long long>(per_sm, (blocks + sms - 1) / sms);
    const long long cost =
        (blocks + slots - 1) / slots * share * block_work<F>(MODE, R, a.W);
    if (best == 0 || cost < best_cost) best = R, best_cost = cost;
  }
  if (best == 0) return cudaErrorInvalidValue;
  a.R = best;
  a.bands = (a.H + best - 1) / best;
  const int blocks = B * a.bands;
  kernel<<<blocks, kThreads, sizeof(float) * layout<F>(MODE, best, a.W).total,
           st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_rows(a.part, a.out, blocks, row_len(MODE, F), st);
}

template <typename T, int MODE>
cudaError_t dispatch_f(const Args& a, int B, int F, int device,
                       cudaStream_t st) {
  switch (F) {
    case 64:
      return launch_rows<T, 64, MODE>(a, B, device, st);
    case 128:
      return launch_rows<T, 128, MODE>(a, B, device, st);
    case 256:
      return launch_rows<T, 256, MODE>(a, B, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_mode(int mode, const Args& a, int B, int F, int device,
                          cudaStream_t st) {
  switch (mode) {
    case kStatsA:
      return dispatch_f<T, kStatsA>(a, B, F, device, st);
    case kStatsB:
      return dispatch_f<T, kStatsB>(a, B, F, device, st);
    case kBwd1:
      return dispatch_f<T, kBwd1>(a, B, F, device, st);
    case kBwd2:
      return dispatch_f<T, kBwd2>(a, B, F, device, st);
    case kBwd3:
      return dispatch_f<T, kBwd3>(a, B, F, device, st);
    case kBwd4:
      return dispatch_f<T, kBwd4>(a, B, F, device, st);
    case kBwd:
      return dispatch_f<T, kBwd>(a, B, F, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- the weight gradients
constexpr int kWT = 64;  // output tile edge
constexpr int kWK = 16;  // pixels per staged chunk

struct WArgs {
  const void* a;  // kRows: f32 [P][Ka]; kShifted: f32 [B,H,W,Ka]; kBnRelu: x
  const float* b;                      // f32 [P][Nb]
  const float *g1, *be1, *mu1, *i1;    // kBnRelu: BN1 ([Ka])
  float* part;                         // [splits][taps][Ka][Nb]
  int P, Ka, Nb, H, W, chunk;          // chunk: pixels per split
};

// part[split][tap][k][n] = sum over the split's pixels p of A(p, tap)[k] *
// b[p][n]; one block per 64x64 output tile, split and tap.
template <typename T, int AM>
__global__ void __launch_bounds__(256) bottleneck_wgrad_kernel(const WArgs a) {
  __shared__ __align__(16) float As[kWK][kWT];
  __shared__ __align__(16) float Bs[kWK][kWT];
  constexpr int taps = AM == kShifted ? 9 : 1;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kWT, k0 = blockIdx.y * kWT;
  const int split = blockIdx.z / taps, tap = blockIdx.z % taps;
  const int dy = tap / 3 - 1, dxo = tap % 3 - 1;
  const int p_begin = split * a.chunk;
  const int p_end = min(a.P, p_begin + a.chunk);
  const int lk = tid / 16, lc = (tid % 16) * 4;  // loader: pixel, 4 columns
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_a = [&](int p) -> float4 {
    if (p >= p_end) return z;
    if constexpr (AM == kRows) {
      return load4(static_cast<const float*>(a.a) + (long long)p * a.Ka + k0 +
                   lc);
    } else if constexpr (AM == kShifted) {
      const int hw = a.H * a.W, r = p % hw;
      const int y = r / a.W + dy, x = r % a.W + dxo;
      if (y < 0 || y >= a.H || x < 0 || x >= a.W) return z;
      return load4(static_cast<const float*>(a.a) +
                   ((long long)(p - r) + y * a.W + x) * a.Ka + k0 + lc);
    } else {
      const float4 v =
          load4(static_cast<const T*>(a.a) + (long long)p * a.Ka + k0 + lc);
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = k0 + lc + q;
        o[q] = bn_relu(at(v, q), __ldg(a.mu1 + c), __ldg(a.i1 + c),
                       __ldg(a.g1 + c), __ldg(a.be1 + c));
      }
      return f4(o);
    }
  };
  auto load_b = [&](int p) -> float4 {
    return p < p_end ? load4(a.b + (long long)p * a.Nb + n0 + lc) : z;
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float4 ra = load_a(p_begin + lk), rb = load_b(p_begin + lk);
  for (int p0 = p_begin; p0 < p_end; p0 += kWK) {
    __syncthreads();
    store4(&As[lk][lc], ra);
    store4(&Bs[lk][lc], rb);
    __syncthreads();
    if (p0 + kWK < p_end) {
      ra = load_a(p0 + kWK + lk);
      rb = load_b(p0 + kWK + lk);
    }
#pragma unroll
    for (int k = 0; k < kWK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(at(av, i), at(bv, j), acc[i][j]);
    }
  }
  float* out =
      a.part + ((long long)blockIdx.z * a.Ka + k0 + ty * 4) * a.Nb + n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    store4(out + (long long)i * a.Nb,
           make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

template <typename T>
cudaError_t launch_wgrad(int amode, const WArgs& w, int splits, float* out,
                         cudaStream_t st) {
  const int taps = amode == kShifted ? 9 : 1;
  const dim3 grid(w.Nb / kWT, w.Ka / kWT, splits * taps);
  switch (amode) {
    case kRows:
      bottleneck_wgrad_kernel<T, kRows><<<grid, 256, 0, st>>>(w);
      break;
    case kShifted:
      bottleneck_wgrad_kernel<T, kShifted><<<grid, 256, 0, st>>>(w);
      break;
    case kBnRelu:
      bottleneck_wgrad_kernel<T, kBnRelu><<<grid, 256, 0, st>>>(w);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_rows(w.part, out, splits, (long long)taps * w.Ka * w.Nb, st);
}

}  // namespace

// p[32], null where a mode does not read it: x, gy, w1, w2, w2t, w3t, w1t,
// g1, be1, mu1, i1, g2, be2, mu2, i2, g3, be3, mu3, i3, T3a, T3b, T2a, T2b,
// T1a, T1b, part, out, s0, s1, dx, s2, s3 (see Args); mode 6 takes the
// folded s1, b1, s2, b2, s3, b3 in the places of g1, be1, g2, be2, g3, be3.
// x, gy, dx [B,H,W,4F], s0..s3 [B,H,W,F]; x and dx of `dtype` (tr::DType),
// the rest f32; all contiguous and 16-byte aligned. part holds B*H*row_len
// floats, row_len = 2F (modes 0-3), 8F (mode 4), 0 (mode 5) or 12F (mode
// 6); out row_len floats: [sum a (F or 4F), sum b], for mode 6 [db1, ds1
// (4F each), db2, ds2, db3, ds3 (F each)], db = sum dm and ds = sum dm*v.
// F is 64, 128 or 256. Returns the cudaError_t of the launches on `stream`
// (the row kernel and, but for mode 5, the sum of its rows).
extern "C" int tr_bottleneck_train(int mode, const void* const* p, int B,
                                   int H, int W, int F, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || H < 1 || W < 1 || mode < kStatsA || mode > kBwd)
    return cudaErrorInvalidValue;
  Args a = {};
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  a.x = p[0];
  a.gy = f(p[1]);
  a.w1 = f(p[2]);
  a.w2 = f(p[3]);
  a.w2t = f(p[4]);
  a.w3t = f(p[5]);
  a.w1t = f(p[6]);
  for (int i = 0; i < 12; ++i) a.v[i] = f(p[7 + i]);
  for (int i = 0; i < 6; ++i) a.t[i] = f(p[19 + i]);
  a.part = static_cast<float*>(const_cast<void*>(p[25]));
  a.out = static_cast<float*>(const_cast<void*>(p[26]));
  a.s0 = static_cast<float*>(const_cast<void*>(p[27]));
  a.s1 = static_cast<float*>(const_cast<void*>(p[28]));
  a.dx = const_cast<void*>(p[29]);
  a.s2 = static_cast<float*>(const_cast<void*>(p[30]));
  a.s3 = static_cast<float*>(const_cast<void*>(p[31]));
  a.H = H;
  a.W = W;
  a.n = (float)((long long)B * H * W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return dispatch_mode<float>(mode, a, B, F, device, st);
    case tr::kBFloat16:
      return dispatch_mode<__nv_bfloat16>(mode, a, B, F, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// out[taps][Ka][Nb] = sum over the P = B*H*W pixels of A^T b, A by `amode`:
// 0 f32 rows [P][Ka]; 1 f32 [B,H,W,Ka] shifted by each of the 9 taps of a
// 3x3 with SAME zero padding; 2 relu(g1*((x-mu1)*i1) + be1) of x [P][Ka] of
// `dtype`. p[8]: a, b [P][Nb] f32, g1, be1, mu1, i1 (amode 2), part
// (splits*taps*Ka*Nb floats), out. Ka and Nb are multiples of 64. The pixels
// go in `splits` chunks, added in order by a second launch.
extern "C" int tr_bottleneck_wgrad(int amode, const void* const* p, int P,
                                   int Ka, int Nb, int H, int W, int splits,
                                   int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (P < 1 || Ka % kWT || Nb % kWT || Ka < 1 || Nb < 1 || splits < 1 ||
      (amode == kShifted && P % (H * W)))
    return cudaErrorInvalidValue;
  WArgs w = {};
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  w.a = p[0];
  w.b = f(p[1]);
  w.g1 = f(p[2]);
  w.be1 = f(p[3]);
  w.mu1 = f(p[4]);
  w.i1 = f(p[5]);
  w.part = static_cast<float*>(const_cast<void*>(p[6]));
  w.P = P;
  w.Ka = Ka;
  w.Nb = Nb;
  w.H = H;
  w.W = W;
  w.chunk = ((P + splits - 1) / splits + kWK - 1) / kWK * kWK;
  float* out = static_cast<float*>(const_cast<void*>(p[7]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return launch_wgrad<float>(amode, w, splits, out, st);
    case tr::kBFloat16:
      return launch_wgrad<__nv_bfloat16>(amode, w, splits, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}
