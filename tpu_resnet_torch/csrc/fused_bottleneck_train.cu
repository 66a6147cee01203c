// Fused ResNet-v2 bottleneck with folded (frozen) batch norm: its one
// backward pass, tr_bottleneck_train (the training passes live in
// fused_bottleneck_tc.cu, the weight-gradient products in
// bottleneck_wgrad.cu). Stride 1, identity shortcut, 3x3 SAME; x is NHWC
// [B,H,W,4F] (f32 or bf16), gy f32 of x's shape, W1 f32 [4F,F], w2 f32 HWIO
// [3,3,F,F], W3 f32 [F,4F], the folded BN vectors f32 ([4F] for BN1, [F] for
// BN2 and BN3). All arithmetic is f32.
//
// Replaces, in tpu_resnet/ops/fused_bottleneck.py (bottleneck_apply, the
// folded-BN bottleneck under a gradient: the eval-mode model differentiated,
// tools/fused_bottleneck_ab.py's fwd_bwd arm):
//   _bwd_kernel: dx, the six BN sums and the operands p3, p2, dmid, dc1 of
//   dW3 = sum p3^T gy, dw2 = sum p2-patch^T dmid, dW1 = sum p1^T dc1, in
//   one pass.
// The chain on the folded affines, as the reference's _chain_fwd and
// _bwd_kernel: m1 = x*s1 + b1, p1 = relu(m1), c1 = p1 . W1, m2 = c1*s2 + b2,
// m3 = mid*s3 + b3, p3 = relu(m3); then dm3 = (gy . W3^T)*[m3>0], dmid =
// dm3*s3 (0 outside the image), dm2 = convT(dmid, w2)*[m2>0], dc1 = dm2*s2,
// dm1 = (dc1 . W1^T)*[m1>0], dx = gy + dm1*s1; its sums are db = sum dm and
// ds = sum dm*v, v the BN's input (x, c1, mid). Every elementwise formula
// rounds as written (__fmul_rn, __fadd_rn, no FMA contraction), as the plain
// PyTorch version does, so a mask [m > 0] agrees with the plain version's
// wherever the products do.
//
// Bound: arithmetic. Per centre pixel, c1 is 8F^2 flops, mid 18F^2, gy . W3^T
// 8F^2, convT 18F^2, dc1 . W1^T 8F^2 (and the weight gradients 34F^2), 94F^2
// with them, against ~2*4F elements moved, on f32 FMAs (67 TFLOP/s on an
// H100). H*W*F^2 is the same at every ResNet-50 stage, so the pass has one
// bound per launch at all three stages.
//
// Design: the row kernel. One thread block per (image, band of R output
// rows), with register-tiled products (tile_fma.cuh). The band recomputes
// the chain on its rows and a halo of two (convT needs dmid at +-1, hence
// mid at +-1 and p2 at +-2); halo rows are recomputed by both neighbours, as
// the TPU kernel does. Phases, each a product into registers with an
// elementwise epilogue:
//   A  c1 over the E = R + 4 rows: p2 into shared memory (zero rows outside
//      the image, zero side columns) and c1 of the centre rows;
//   B  mid = conv3x3(p2) over E-2 rows, into shared memory;
//   C  gy . W3^T over the same rows: dm3, then dmid in place of mid (zeroed
//      outside the image) and the BN3 sums on the centre rows;
//   D  dp2 = convT(dmid) over the R centre rows: dm2, the BN2 sums, and dc1
//      in place of c1;
//   E  dc1 . W1^T in four tiles of F output channels: dm1, the BN1 sums, dx.
// Neither intermediate is written to device memory except the operands the
// weight gradients need (p3, p2 and dmid, dc1: [B,H,W,F] f32 scratch). The
// A operand of a reduce phase (x or gy, 4F channels) streams from device
// memory in chunks staged through a shared buffer that is free in that
// phase. R is picked per launch from {4, 2, 1} for the least estimated time,
// among those whose buffers fit in shared memory.
//
// Sums without atomics: the row kernel writes one row of channel sums per
// block, and bottleneck_sum_kernel (row_sums.cuh) adds them in block order.
// Inside a block each channel sum adds the thread's pixels in order, then
// the threads in order. Two calls agree bit for bit.
//
// Known limit, the first thing to make fast: every product runs on f32 FMAs,
// and the recomputed halo costs up to 5x the centre rows' c1 at F=256 (R=1).
// fused_bottleneck_tc.cu shows the way out: tensor cores, and a pass that
// reads what the pass before it wrote.

#include <algorithm>

#include "row_sums.cuh"
#include "tile_fma.cuh"

namespace {

using namespace tr;

constexpr int kHalo = 2;
constexpr int kRowLen = 12;  // channel sums per block, in F

struct Args {
  const void* x;      // [B,H,W,4F]
  const float* gy;    // [B,H,W,4F]
  const float* w1;    // [4F,F]
  const float* w2;    // [3,3,F,F] HWIO
  const float* w2t;   // [3,3,F,F]: w2 flipped in space, in/out swapped
  const float* w3t;   // [4F,F]: W3 transposed
  const float* w1t;   // [F,4F]: W1 transposed
  const float* v[12];  // g1 be1 mu1 i1 ([4F]) g2 be2 mu2 i2 g3 be3 mu3 i3
  float* part;        // [blocks][12F] channel sums
  float* out;         // [12F] their sum
  float* s0;          // [B,H,W,F] scratch: p2 (bwd)
  float* s1;          // [B,H,W,F] scratch: dmid (bwd)
  void* dx;           // [B,H,W,4F] (bwd)
  float* s2;          // [B,H,W,F] scratch: p3 (bwd)
  float* s3;          // [B,H,W,F] scratch: dc1 (bwd)
  int H, W, R, bands;
};

// Shared memory, in floats: region 0 holds p2 [E][W+2][F], later the staged
// gy chunks and the channel-sum reduction; region 1 mid, then dmid,
// [E-2][W+2][F] (first the staged x chunks); region 2 c1, then dc1,
// [R][W][F]; region 3 two staged weight chunks.
struct Layout {
  int o1, o2, o3, total;
};
template <int F>
__host__ __device__ inline Layout layout(int R, int W) {
  const int E = R + 2 * kHalo, WP = W + 2;
  const int stage = 2 * Tile<F>::BM * kKC, red = 2 * kThreads * kTN;
  int s0 = E * WP * F;
  s0 = s0 > stage ? s0 : stage;
  s0 = s0 > red ? s0 : red;
  int s1 = (E - 2) * WP * F;
  s1 = s1 > stage ? s1 : stage;
  const int s2 = R * W * F;
  return {s0, s0 + s1, s0 + s1 + s2, s0 + s1 + s2 + 2 * kKC * F};
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 f4(const float (&o)[4]) {
  return make_float4(o[0], o[1], o[2], o[3]);
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

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    bottleneck_bwd_kernel(const Args a) {
  constexpr int C4 = 4 * F;
  constexpr int HALO = kHalo;
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, W = a.W, R = a.R, WP = W + 2;
  const int E = R + 2 * HALO;
  const Layout L = layout<F>(R, W);
  float* reg0 = smem;            // p2; staged gy; reduction
  float* reg1 = smem + L.o1;     // staged x; mid -> dmid
  float* reg2 = smem + L.o2;     // c1 -> dc1
  float* bbuf = smem + L.o3;
  const int tid = threadIdx.x;
  const int img = blockIdx.x / a.bands;
  const int r0 = (blockIdx.x % a.bands) * R;  // first centre row
  const long long pix0 = (long long)img * H * W;
  const T* xi = static_cast<const T*>(a.x) + pix0 * C4;
  float* prow = a.part + (long long)blockIdx.x * kRowLen * F;
  const float *g1 = a.v[0], *be1 = a.v[1];
  const float *g2 = a.v[4], *be2 = a.v[5];
  const float *g3 = a.v[8], *be3 = a.v[9];
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
  zero_sides(reg0, E);

  // A. c1 = p1 . W1 over the E rows from r0 - HALO.
  {
    reduce_rows<F>(
        xi, r0 - HALO, E, H, W, a.w1, reg1, bbuf,
        [&](float4 v, int c) {
          float o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            o[q] = sbr(at(v, q), __ldg(g1 + c + q), __ldg(be1 + c + q));
          return f4(o);
        },
        [&](int m, int h, int c, float4 v) {
          const int e = m / W, px = m % W, g = r0 - HALO + e;
          const bool inside = g >= 0 && g < H;
          float p[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            p[q] = inside ? fmaxf(add(mul(__ldg(g2 + c + q), at(v, q)),
                                      __ldg(be2 + c + q)),
                                  0.f)
                          : 0.f;
          store4(reg0 + (e * WP + px + 1) * F + c, f4(p));
          const int ce = e - HALO;
          if (ce >= 0 && ce < R && inside) {
            store4(reg2 + (ce * W + px) * F + c, v);  // c1
            store4(a.s0 + (pix0 + (long long)g * W + px) * F + c, f4(p));
          }
        });
  }

  // B. mid = conv3x3(p2) over E-2 rows.
  {
    __syncthreads();
    // dmid's side columns, once phase A's x chunks have left region 1.
    zero_sides(reg1, E - 2);
    conv_rows<F>(reg0, E - 2, W, a.w2, bbuf,
                 [&](int m, int h, int c, float4 v) {
                   store4(reg1 + ((m / W) * WP + m % W + 1) * F + c, v);
                 });
  }

  // C. dp3 = gy . W3^T over the rows of mid: dm3, then dmid.
  {
    __syncthreads();
    const int g0 = r0 - (HALO - 1);
    reduce_rows<F>(
        a.gy + pix0 * C4, g0, E - 2, H, W, a.w3t, reg0, bbuf,
        [](float4 v, int) { return v; },
        [&](int m, int h, int c, float4 v) {
          const int e = m / W, px = m % W, g = g0 + e;
          const bool inside = g >= 0 && g < H;
          const bool centre = inside && e >= 1 && e <= R;
          float* mp = reg1 + (e * WP + px + 1) * F + c;
          float o[4], p3[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float mh = mp[q];
            const float m3 = add(mul(__ldg(g3 + c + q), mh), __ldg(be3 + c + q));
            const float dm3 = m3 > 0.f ? at(v, q) : 0.f;
            if (centre) sum2(h, q, dm3, mh);
            p3[q] = fmaxf(m3, 0.f);
            o[q] = inside ? mul(dm3, __ldg(g3 + c + q)) : 0.f;  // dmid
          }
          const long long so = (pix0 + (long long)g * W + px) * F + c;
          store4(mp, f4(o));
          if (centre) {
            store4(a.s1 + so, f4(o));
            store4(a.s2 + so, f4(p3));
          }
        });
    flush_sums<F>(sa, sb, reg0, prow + 10 * F, prow + 11 * F);
  }

  // D. dp2 = convT(dmid) over the R centre rows: dm2, then dc1.
  {
    __syncthreads();
    conv_rows<F>(
        reg1, R, W, a.w2t, bbuf, [&](int m, int h, int c, float4 v) {
          const int e = m / W, px = m % W, g = r0 + e;
          float* cp = reg2 + (e * W + px) * F + c;
          if (g >= H) {
            store4(cp, make_float4(0.f, 0.f, 0.f, 0.f));
            return;
          }
          float o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float ch = cp[q];
            const float m2 = add(mul(__ldg(g2 + c + q), ch), __ldg(be2 + c + q));
            const float dm2 = m2 > 0.f ? at(v, q) : 0.f;
            sum2(h, q, dm2, ch);
            o[q] = mul(dm2, __ldg(g2 + c + q));
          }
          store4(cp, f4(o));  // dc1, in place of c1
          store4(a.s3 + (pix0 + (long long)g * W + px) * F + c, f4(o));
        });
    flush_sums<F>(sa, sb, reg0, prow + 8 * F, prow + 9 * F);
  }

  // E. dp1 = dc1 . W1^T, in four tiles of F channels: dm1, then dx.
  {
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
            const float4 gv = load4(a.gy + o);
            float d[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float xh = at(xv, q);
              const float m1 =
                  add(mul(__ldg(g1 + cc + q), xh), __ldg(be1 + cc + q));
              const float dm1 = m1 > 0.f ? at(v, q) : 0.f;
              sum2(h, q, dm1, xh);
              d[q] = add(at(gv, q), mul(dm1, __ldg(g1 + cc + q)));
            }
            store4(static_cast<T*>(a.dx) + o, f4(d));
          });
      flush_sums<F>(sa, sb, reg0, prow + nt * F, prow + C4 + nt * F);
    }
  }
}

// Chunks (BM pixels x kKC x F) a block of band R multiplies through.
template <int F>
long long block_work(int R, int W) {
  const int E = R + 2 * kHalo;
  auto tiles = [&](int rows) {
    return (long long)(rows * W + Tile<F>::BM - 1) / Tile<F>::BM;
  };
  return tiles(E) * 4 * F / kKC + tiles(E - 2) * 9 * F / kKC +
         tiles(E - 2) * 4 * F / kKC + tiles(R) * 9 * F / kKC +
         4 * tiles(R) * F / kKC;
}

template <typename T, int F>
cudaError_t launch_rows(Args a, int B, int device, cudaStream_t st) {
  auto kernel = bottleneck_bwd_kernel<T, F>;
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
    const size_t smem = sizeof(float) * layout<F>(R, a.W).total;
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
        (blocks + slots - 1) / slots * share * block_work<F>(R, a.W);
    if (best == 0 || cost < best_cost) best = R, best_cost = cost;
  }
  if (best == 0) return cudaErrorInvalidValue;
  a.R = best;
  a.bands = (a.H + best - 1) / best;
  const int blocks = B * a.bands;
  kernel<<<blocks, kThreads, sizeof(float) * layout<F>(best, a.W).total,
           st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_rows(a.part, a.out, blocks, (long long)kRowLen * F, st);
}

template <typename T>
cudaError_t dispatch_f(const Args& a, int B, int F, int device,
                       cudaStream_t st) {
  switch (F) {
    case 64:
      return launch_rows<T, 64>(a, B, device, st);
    case 128:
      return launch_rows<T, 128>(a, B, device, st);
    case 256:
      return launch_rows<T, 256>(a, B, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// p[26], null where the pass does not read it: x, gy, w1, w2, w2t, w3t,
// w1t, g1, be1, mu1, i1, g2, be2, mu2, i2, g3, be3, mu3, i3, part, out, s0,
// s1, dx, s2, s3 (see Args); the folded s1, b1, s2, b2, s3, b3 in the
// places of g1, be1, g2, be2, g3, be3.
// x, gy, dx [B,H,W,4F], s0..s3 [B,H,W,F]; x and dx of `dtype` (tr::DType),
// the rest f32; all contiguous and 16-byte aligned. part holds B*H*12F
// floats; out 12F floats: [db1, ds1 (4F each), db2, ds2, db3, ds3 (F
// each)], db = sum dm and ds = sum dm*v. F is 64, 128 or 256.
// Returns the cudaError_t of the launches on `stream` (the row kernel and
// the sum of its rows).
extern "C" int tr_bottleneck_train(const void* const* p, int B, int H, int W,
                                   int F, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
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
  a.part = static_cast<float*>(const_cast<void*>(p[19]));
  a.out = static_cast<float*>(const_cast<void*>(p[20]));
  a.s0 = static_cast<float*>(const_cast<void*>(p[21]));
  a.s1 = static_cast<float*>(const_cast<void*>(p[22]));
  a.dx = const_cast<void*>(p[23]);
  a.s2 = static_cast<float*>(const_cast<void*>(p[24]));
  a.s3 = static_cast<float*>(const_cast<void*>(p[25]));
  a.H = H;
  a.W = W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return dispatch_f<float>(a, B, F, device, st);
    case tr::kBFloat16:
      return dispatch_f<__nv_bfloat16>(a, B, F, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}
