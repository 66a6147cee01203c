// Fused ResNet-v2 basic block: the conv1 moments of the training forward,
// the three backward passes with live batch-norm statistics, and the one
// backward pass with folded (frozen) batch norm. Stride 1, equal in/out
// channels, 3x3 SAME convs; x is NHWC (f32 or bf16), gy f32, w1 and w2 HWIO
// f32 [3,3,C,C], every BN vector f32 [C]. All arithmetic is f32.
//
// Replaces, in tpu_resnet/ops/fused_block.py (block_train_apply, which every
// stride-1 identity block of the CIFAR ResNet runs in training when
// model.fused_blocks=true):
//   tr_block_stats  _stats_kernel (through _c1_moments): sum c1, sum c1^2,
//                   c1 = conv3x3(relu(s1*x + b1), w1), recomputed, not
//                   stored;
//   tr_block_bwd1   _train_bwd_calls pass1: T1 = sum dz2, T2 = sum dz2*z2hat,
//                   dw2 = sum r2-patch^T gy, with dz2 = convT(gy, w2)*[z2>0];
//   tr_block_bwd2   pass2: dc1 = g2*i2*(dz2 - T1/n - z2hat*(T2/n)),
//                   U1 = sum dz1, U2 = sum dz1*z1hat,
//                   dw1 = sum r1-patch^T dc1,
//                   with dz1 = convT(dc1, w1)*[z1>0];
//   tr_block_bwd3   pass3: dx = gy + g1*i1*(dz1 - U1/n - z1hat*(U2/n)).
// and (block_apply, the folded-BN block under a gradient: the eval-mode
// model differentiated, tools/fused_block_ab.py's fwd_bwd arm):
//   tr_block_bwd    _block_bwd_kernel: with a1 = x*s1 + b1, r1 = relu(a1),
//                   c1 = conv(r1, w1), a2 = c1*s2 + b2, r2 = relu(a2):
//                   da2 = convT(gy, w2)*[a2>0], dc1 = da2*s2,
//                   da1 = convT(dc1, w1)*[a1>0], dx = gy + da1*s1,
//                   dw1 = sum r1-patch^T dc1, dw2 = sum r2-patch^T gy,
//                   ds1 = sum da1*x, db1 = sum da1, ds2 = sum da2*c1,
//                   db2 = sum da2.
// The live-BN backward recomputes the chain from x and the saved moments (m,
// i = 1/sigma): z1hat = (x-m1)*i1, z1 = g1*z1hat + b1, r1 = relu(z1), c1 =
// conv(r1, w1), z2hat = (c1-m2)*i2, z2 = g2*z2hat + b2, r2 = relu(z2); the
// frozen one from the folded affines, a = v*s + b, as block_fwd
// (csrc/fused_block.cu) and the reference kernel round them. Each
// elementwise formula is rounded as written (__fmul_rn, __fadd_rn, no FMA
// contraction), as the plain PyTorch version rounds it, so a mask [z > 0]
// matches the plain version's wherever the conv sums do.
//
// Bound: arithmetic. One 3x3 product is 2*B*H*W*9*C*C flops (0.604 GFLOP at
// every CIFAR stage at B=128, 9.0 us at 67 TFLOP/s f32) for B*H*W*C elements
// moved: tens to hundreds of operations per byte, off the tensor cores. The
// stats kernel runs one product, bwd1 three (conv1, convT of gy, dw2), bwd2
// four (conv1, two convT, dw1), bwd3 three, the frozen bwd five (conv1, two
// convT, dw1, dw2).
//
// Design: one thread block per image, as block_fwd (csrc/fused_block.cu).
// The recomputed planes live in shared memory, f32, zero-haloed, with a pixel
// stride of C+1 words (odd, so a warp reading neighbouring pixels hits
// distinct banks). The constraint is room: the passes need r1, r2 or dc1, gy and
// c1 (or z2hat) planes, four at most, and at 32x32x16 one padded plane is
// 78.6 KB. Instead of row bands with a two-row halo, each pass reuses and
// rebuilds planes in phases, because r1 and gy are cheap elementwise
// functions of x and gy that can be written again, while c1 is a product:
//   stats: A = r1 (folded BN1); c1 per pixel, summed.            1 plane
//   bwd1:  A = r1; B = r2, Z = z2hat (unpadded); A = gy; dz2 from convT(A)
//          and the mask r2 > 0; dw2 from B and A.   2 planes + Z: 226.8 KB
//   bwd2:  A = r1; B = z2hat; A = gy; B = dc1 in place (each pixel's dc1
//          needs only its own z2hat); A = r1 again; dz1 from convT(B); dw1
//          from A and B.                                         2 planes
//   bwd3:  as bwd2 without the second r1; dx from convT(B), x and gy in A.
//   bwd:   A = r1; Z = c1, B = r2; A = gy; dw2 from B and A; da2 from
//          convT(A) and the mask r2 > 0, ds2 and db2 with c1 from Z, and
//          B = dc1 in place; A = r1 again; dw1 from A and B; da1 from
//          convT(B) and the mask from x, dx with gy read from device
//          memory, ds1 and db1.                     2 planes + Z: 226.8 KB
// Neither plane touches device memory. At 16x16x32 and 8x8x64 all fit with
// room to spare.
//
// Sums across the batch: blocks run in no order, so each block writes one
// row of partial sums (its image's channel sums and its whole dw) to a
// scratch the wrapper allocates, and a second launch adds the rows in image
// order. Inside a block every channel sum is a fixed set of threads added in
// thread order, and every dw element belongs to one thread. No float
// atomics: two calls agree bit for bit.
//
// Work split: a conv item is one pixel and 8 output channels (a thread's
// channel group is fixed, since the block size is a multiple of C/8, so its
// channel sums stay in registers); a dw item is one tap, one input channel
// and 8 output channels, summed over the image's pixels.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCO = 8;  // output channels per item
constexpr int kMaxSmem = 232448;
enum Mode : int { kStats = 0, kBwd1 = 1, kBwd2 = 2, kBwd3 = 3, kBwd = 4 };

struct Args {
  const void* x;
  const float* gy;
  const float* w1;
  const float* w2;
  const float* s1;  // stats, bwd: folded BN1 scale and bias
  const float* sb1;
  const float* s2;  // bwd: folded BN2 scale and bias
  const float* sb2;
  const float* g1;  // backward: BN gammas, betas, means, 1/sigma
  const float* b1;
  const float* g2;
  const float* b2;
  const float* m1;
  const float* i1;
  const float* m2;
  const float* i2;
  const float* t1;  // pass 1's sums (bwd2, bwd3)
  const float* t2;
  const float* u1;  // pass 2's sums (bwd3)
  const float* u2;
  void* dx;     // bwd3, bwd
  float* part;  // [B][row_len] partial rows
  float* out;   // [row_len] the batch's sums
  int H, W;
  float n;  // B*H*W
};

__host__ __device__ constexpr int row_len(int mode, int C) {
  return mode == kStats ? 2 * C
         : mode == kBwd ? 4 * C + 18 * C * C
                        : 2 * C + 9 * C * C;
}

// One rounding each, never contracted into an FMA.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// relu(g * ((v - m) * i) + b), rounded as written.
__device__ __forceinline__ float bn_relu(float v, float m, float i, float g,
                                         float b) {
  return fmaxf(add(mul(g, mul(sub(v, m), i)), b), 0.f);
}

// 3x3 taps for output pixel (py, px), channels co0..co0+7, over a padded
// plane with pixel stride CP; weights w[tap][ci][co] (the forward conv).
template <int C, int CP>
__device__ __forceinline__ void conv_point(const float* in,
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

// The transposed SAME conv (gradient of conv_point with respect to its
// input): out[p, o] = sum over taps t and channels i of
// in[p + t - 1, i] * w[2 - ty][2 - tx][o][i]. For fixed o the weights are
// contiguous in i, so both operands stream in 16-byte rows.
template <int C, int CP>
__device__ __forceinline__ void convT_point(const float* in,
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
      const float* wt = w + ((2 - ky) * 3 + (2 - kx)) * C * C + co0 * C;
#pragma unroll 2
      for (int ci = 0; ci < C; ci += 4) {
        const float v0 = src[ci], v1 = src[ci + 1], v2 = src[ci + 2],
                    v3 = src[ci + 3];
#pragma unroll
        for (int j = 0; j < kCO; ++j) {
          const float4 wv =
              __ldg(reinterpret_cast<const float4*>(wt + j * C + ci));
          acc[j] = fmaf(v0, wv.x, acc[j]);
          acc[j] = fmaf(v1, wv.y, acc[j]);
          acc[j] = fmaf(v2, wv.z, acc[j]);
          acc[j] = fmaf(v3, wv.w, acc[j]);
        }
      }
    }
  }
}

// dw[ky][kx][ci][co] = sum over the image's pixels p of
// R[p + (ky, kx) in the padded plane][ci] * D[p's interior cell][co], one
// (tap, ci, 8 co) item per thread; written to out (9*C*C floats).
template <int C, int CP>
__device__ __forceinline__ void wgrad(const float* R, const float* D, int H,
                                      int W, int WP, float* __restrict__ out) {
  constexpr int G = C / kCO;
  for (int q = threadIdx.x; q < 9 * C * G; q += kThreads) {
    const int cg = q % G, ci = (q / G) % C, tap = q / (G * C);
    const int ky = tap / 3, kx = tap - 3 * ky;
    float acc[kCO];
#pragma unroll
    for (int j = 0; j < kCO; ++j) acc[j] = 0.f;
    for (int py = 0; py < H; ++py) {
      const float* r = R + ((py + ky) * WP + kx) * CP + ci;
      const float* d = D + ((py + 1) * WP + 1) * CP + cg * kCO;
      for (int px = 0; px < W; ++px) {
        const float v = r[px * CP];
#pragma unroll
        for (int j = 0; j < kCO; ++j) acc[j] = fmaf(v, d[px * CP + j], acc[j]);
      }
    }
    float* o = out + (tap * C + ci) * C + cg * kCO;
#pragma unroll
    for (int j = 0; j < kCO; ++j) o[j] = acc[j];
  }
}

// Offset of pixel p's interior cell in a padded plane.
__device__ __forceinline__ int cell(int p, int W, int WP, int CP) {
  const int py = p / W;
  return ((py + 1) * WP + p - py * W + 1) * CP;
}

// A block's two channel sums: thread t holds channels co0..co0+7 of group
// t % G in sa and sb; channel c adds the threads of its group in thread
// order. Writes out[c] (sa's) and out[C + c] (sb's); `red` is the free
// shared memory, 2 * kThreads * kCO floats.
template <int C>
__device__ __forceinline__ void channel_sums(const float (&sa)[kCO],
                                             const float (&sb)[kCO],
                                             float* red, float* out) {
  constexpr int G = C / kCO;
  __syncthreads();  // the planes are free: reuse them
#pragma unroll
  for (int j = 0; j < kCO; ++j) {
    red[threadIdx.x * kCO + j] = sa[j];
    red[(kThreads + threadIdx.x) * kCO + j] = sb[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * C; k += kThreads) {
    const int which = k / C, c = k % C, g = c / kCO, j = c % kCO;
    float s = 0.f;
    for (int r = g; r < kThreads; r += G)
      s += red[(which * kThreads + r) * kCO + j];
    out[k] = s;
  }
}

// The shared body of the four live-BN kernels; MODE picks the pass.
template <typename T, int C, int MODE>
__device__ __forceinline__ void train_body(const Args& a) {
  constexpr int CP = C + 1;
  constexpr int G = C / kCO;  // channel groups per pixel
  constexpr int L = row_len(MODE, C);
  extern __shared__ float smem[];
  const int H = a.H, W = a.W, WP = W + 2, HW = H * W;
  const int plane = (H + 2) * WP * CP;
  float* A = smem;
  float* Bp = smem + plane;
  float* Z = smem + 2 * plane;  // bwd1: z2hat, unpadded
  const long long base = (long long)blockIdx.x * HW * C;
  const T* xi = static_cast<const T*>(a.x) + base;
  const float* gyi = MODE == kStats ? nullptr : a.gy + base;
  float* prow = a.part + (long long)blockIdx.x * L;
  const int co0 = (threadIdx.x % G) * kCO;  // this thread's channel group
  float sa[kCO], sb[kCO];                   // its two channel sums
#pragma unroll
  for (int j = 0; j < kCO; ++j) sa[j] = sb[j] = 0.f;
  float acc[kCO];

  for (int i = threadIdx.x; i < (MODE == kStats ? 1 : 2) * plane;
       i += kThreads)
    smem[i] = 0.f;
  __syncthreads();
  // A <- r1: the folded BN1 for the stats (as the forward), else the
  // unfolded z1 from the saved moments (as the reference's backward).
  for (int i = threadIdx.x; i < HW * C; i += kThreads) {
    const int c = i % C;
    const float v = tr::to_f32(xi[i]);
    A[cell(i / C, W, WP, CP) + c] =
        MODE == kStats
            ? fmaxf(add(mul(v, __ldg(a.s1 + c)), __ldg(a.sb1 + c)), 0.f)
            : bn_relu(v, __ldg(a.m1 + c), __ldg(a.i1 + c), __ldg(a.g1 + c),
                      __ldg(a.b1 + c));
  }
  __syncthreads();

  if constexpr (MODE == kStats) {
    for (int t = threadIdx.x; t < HW * G; t += kThreads) {
      const int p = t / G, py = p / W;
      conv_point<C, CP>(A, a.w1, py, p - py * W, WP, co0, acc);
#pragma unroll
      for (int j = 0; j < kCO; ++j) {
        sa[j] += acc[j];
        sb[j] = fmaf(acc[j], acc[j], sb[j]);
      }
    }
  } else {
    // c1 -> z2hat (bwd1 also keeps r2 = relu(z2) for dw2 and the mask).
    for (int t = threadIdx.x; t < HW * G; t += kThreads) {
      const int p = t / G, py = p / W;
      conv_point<C, CP>(A, a.w1, py, p - py * W, WP, co0, acc);
      float* dst = Bp + cell(p, W, WP, CP) + co0;
#pragma unroll
      for (int j = 0; j < kCO; ++j) {
        const int c = co0 + j;
        const float zh = mul(sub(acc[j], __ldg(a.m2 + c)), __ldg(a.i2 + c));
        if constexpr (MODE == kBwd1) {
          Z[p * CP + c] = zh;
          dst[j] = fmaxf(add(mul(__ldg(a.g2 + c), zh), __ldg(a.b2 + c)), 0.f);
        } else {
          dst[j] = zh;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < HW * C; i += kThreads)
      A[cell(i / C, W, WP, CP) + i % C] = gyi[i];  // A <- gy
    __syncthreads();
    // dr2 = convT(gy, w2); dz2 = dr2 * [z2 > 0].
    for (int t = threadIdx.x; t < HW * G; t += kThreads) {
      const int p = t / G, py = p / W;
      convT_point<C, CP>(A, a.w2, py, p - py * W, WP, co0, acc);
      float* bc = Bp + cell(p, W, WP, CP) + co0;
#pragma unroll
      for (int j = 0; j < kCO; ++j) {
        const int c = co0 + j;
        if constexpr (MODE == kBwd1) {
          const float dz = bc[j] > 0.f ? acc[j] : 0.f;  // r2 > 0 iff z2 > 0
          sa[j] += dz;
          sb[j] = fmaf(dz, Z[p * CP + c], sb[j]);
        } else {
          const float zh = bc[j];
          const float g2 = __ldg(a.g2 + c);
          const float dz = add(mul(g2, zh), __ldg(a.b2 + c)) > 0.f ? acc[j]
                                                                 : 0.f;
          const float inner =
              sub(sub(dz, __fdiv_rn(__ldg(a.t1 + c), a.n)),
                  mul(zh, __fdiv_rn(__ldg(a.t2 + c), a.n)));
          bc[j] = mul(mul(g2, __ldg(a.i2 + c)), inner);  // dc1, in place
        }
      }
    }
    __syncthreads();
    if constexpr (MODE == kBwd1) {
      wgrad<C, CP>(Bp, A, H, W, WP, prow + 2 * C);  // dw2: r2p, gy
    } else {
      if constexpr (MODE == kBwd2) {
        for (int i = threadIdx.x; i < HW * C; i += kThreads) {
          const int c = i % C;
          A[cell(i / C, W, WP, CP) + c] =
              bn_relu(tr::to_f32(xi[i]), __ldg(a.m1 + c), __ldg(a.i1 + c),
                      __ldg(a.g1 + c), __ldg(a.b1 + c));  // A <- r1 again
        }
        __syncthreads();
      }
      // dr1 = convT(dc1, w1); dz1 = dr1 * [z1 > 0].
      for (int t = threadIdx.x; t < HW * G; t += kThreads) {
        const int p = t / G, py = p / W;
        convT_point<C, CP>(Bp, a.w1, py, p - py * W, WP, co0, acc);
#pragma unroll
        for (int j = 0; j < kCO; ++j) {
          const int c = co0 + j;
          const long long e = (long long)p * C + c;
          const float g1 = __ldg(a.g1 + c);
          const float zh = mul(sub(tr::to_f32(xi[e]), __ldg(a.m1 + c)),
                               __ldg(a.i1 + c));
          const float dz = add(mul(g1, zh), __ldg(a.b1 + c)) > 0.f ? acc[j]
                                                                 : 0.f;
          if constexpr (MODE == kBwd2) {
            sa[j] += dz;
            sb[j] = fmaf(dz, zh, sb[j]);
          } else {
            const float inner =
                sub(sub(dz, __fdiv_rn(__ldg(a.u1 + c), a.n)),
                    mul(zh, __fdiv_rn(__ldg(a.u2 + c), a.n)));
            const float v =
                add(gyi[e], mul(mul(g1, __ldg(a.i1 + c)), inner));
            static_cast<T*>(a.dx)[base + e] = tr::from_f32<T>(v);
          }
        }
      }
      if constexpr (MODE == kBwd2) {
        __syncthreads();
        wgrad<C, CP>(A, Bp, H, W, WP, prow + 2 * C);  // dw1: r1p, dc1
      }
    }
  }

  if constexpr (MODE != kBwd3) channel_sums<C>(sa, sb, smem, prow);
}

// Kernel 7 (tr_block_bwd): the VJP of the folded-BN block, one pass per
// image; see the plan at the top. Row: [ds1, db1, ds2, db2 (C each), dw1,
// dw2 (9C^2 each, HWIO)].
template <typename T, int C>
__device__ __forceinline__ void frozen_bwd_body(const Args& a) {
  constexpr int CP = C + 1;
  constexpr int G = C / kCO;
  constexpr int L = row_len(kBwd, C);
  extern __shared__ float smem[];
  const int H = a.H, W = a.W, WP = W + 2, HW = H * W;
  const int plane = (H + 2) * WP * CP;
  float* A = smem;
  float* Bp = smem + plane;
  float* Z = smem + 2 * plane;  // c1, unpadded
  const long long base = (long long)blockIdx.x * HW * C;
  const T* xi = static_cast<const T*>(a.x) + base;
  const float* gyi = a.gy + base;
  float* prow = a.part + (long long)blockIdx.x * L;
  const int co0 = (threadIdx.x % G) * kCO;  // this thread's channel group
  float ds1[kCO], db1[kCO], ds2[kCO], db2[kCO];
#pragma unroll
  for (int j = 0; j < kCO; ++j) ds1[j] = db1[j] = ds2[j] = db2[j] = 0.f;
  float acc[kCO];
  auto load_r1 = [&]() {  // A <- r1 = relu(x*s1 + b1)
    for (int i = threadIdx.x; i < HW * C; i += kThreads) {
      const int c = i % C;
      A[cell(i / C, W, WP, CP) + c] = fmaxf(
          add(mul(tr::to_f32(xi[i]), __ldg(a.s1 + c)), __ldg(a.sb1 + c)),
          0.f);
    }
  };

  for (int i = threadIdx.x; i < 2 * plane; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  load_r1();
  __syncthreads();
  // c1 = conv(r1, w1) into Z; B <- r2 = relu(c1*s2 + b2).
  for (int t = threadIdx.x; t < HW * G; t += kThreads) {
    const int p = t / G, py = p / W;
    conv_point<C, CP>(A, a.w1, py, p - py * W, WP, co0, acc);
    float* dst = Bp + cell(p, W, WP, CP) + co0;
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      const int c = co0 + j;
      Z[p * CP + c] = acc[j];
      dst[j] = fmaxf(add(mul(acc[j], __ldg(a.s2 + c)), __ldg(a.sb2 + c)),
                     0.f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HW * C; i += kThreads)
    A[cell(i / C, W, WP, CP) + i % C] = gyi[i];  // A <- gy
  __syncthreads();
  wgrad<C, CP>(Bp, A, H, W, WP, prow + 4 * C + 9 * C * C);  // dw2: r2p, gy
  __syncthreads();
  // da2 = convT(gy, w2)*[a2 > 0]; dc1 = da2*s2, in place of r2.
  for (int t = threadIdx.x; t < HW * G; t += kThreads) {
    const int p = t / G, py = p / W;
    convT_point<C, CP>(A, a.w2, py, p - py * W, WP, co0, acc);
    float* bc = Bp + cell(p, W, WP, CP) + co0;
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      const int c = co0 + j;
      const float da = bc[j] > 0.f ? acc[j] : 0.f;  // r2 > 0 iff a2 > 0
      db2[j] += da;
      ds2[j] = fmaf(da, Z[p * CP + c], ds2[j]);
      bc[j] = mul(da, __ldg(a.s2 + c));
    }
  }
  __syncthreads();
  load_r1();
  __syncthreads();
  wgrad<C, CP>(A, Bp, H, W, WP, prow + 4 * C);  // dw1: r1p, dc1
  // da1 = convT(dc1, w1)*[a1 > 0]; dx = gy + da1*s1.
  for (int t = threadIdx.x; t < HW * G; t += kThreads) {
    const int p = t / G, py = p / W;
    convT_point<C, CP>(Bp, a.w1, py, p - py * W, WP, co0, acc);
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      const int c = co0 + j;
      const long long e = (long long)p * C + c;
      const float v = tr::to_f32(xi[e]), s1 = __ldg(a.s1 + c);
      const float da = add(mul(v, s1), __ldg(a.sb1 + c)) > 0.f ? acc[j] : 0.f;
      db1[j] += da;
      ds1[j] = fmaf(da, v, ds1[j]);
      static_cast<T*>(a.dx)[base + e] = tr::from_f32<T>(add(gyi[e],
                                                            mul(da, s1)));
    }
  }
  channel_sums<C>(ds1, db1, smem, prow);
  channel_sums<C>(ds2, db2, smem, prow + 2 * C);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) block_stats_kernel(const Args a) {
  train_body<T, C, kStats>(a);
}
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) block_bwd1_kernel(const Args a) {
  train_body<T, C, kBwd1>(a);
}
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) block_bwd2_kernel(const Args a) {
  train_body<T, C, kBwd2>(a);
}
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) block_bwd3_kernel(const Args a) {
  train_body<T, C, kBwd3>(a);
}
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) block_bwd_kernel(const Args a) {
  frozen_bwd_body<T, C>(a);
}

// out[k] = sum over rows, in row order, of part[row][k].
__global__ void train_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int rows, int L) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= L) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(long long)r * L + k];
  out[k] = s;
}

size_t smem_bytes(int mode, int H, int W, int C) {
  const size_t plane = (size_t)(H + 2) * (W + 2) * (C + 1) * sizeof(float);
  size_t s = mode == kStats ? plane : 2 * plane;
  if (mode == kBwd1 || mode == kBwd)
    s += (size_t)H * W * (C + 1) * sizeof(float);
  const size_t red = 2ull * kThreads * kCO * sizeof(float);
  return s > red ? s : red;
}

template <typename T, int C, int MODE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(MODE, a.H, a.W, C);
  void (*kernel)(const Args) = &block_bwd3_kernel<T, C>;
  if constexpr (MODE == kStats) kernel = &block_stats_kernel<T, C>;
  if constexpr (MODE == kBwd1) kernel = &block_bwd1_kernel<T, C>;
  if constexpr (MODE == kBwd2) kernel = &block_bwd2_kernel<T, C>;
  if constexpr (MODE == kBwd) kernel = &block_bwd_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || MODE == kBwd3) return err;
  constexpr int L = row_len(MODE, C);
  train_sum_kernel<<<(L + 255) / 256, 256, 0, stream>>>(a.part, a.out, B, L);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t dispatch_c(const Args& a, int B, int C, cudaStream_t st) {
  switch (C) {
    case 16:
      return launch<T, 16, MODE>(a, B, st);
    case 32:
      return launch<T, 32, MODE>(a, B, st);
    case 64:
      return launch<T, 64, MODE>(a, B, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int MODE>
int run(Args a, int B, int H, int W, int C, int dtype, int device,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || H < 1 || W < 1 || (C != 16 && C != 32 && C != 64) ||
      smem_bytes(MODE, H, W, C) > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0)
    return MODE == kBwd3 ? cudaSuccess
                         : cudaMemsetAsync(a.out, 0,
                                           row_len(MODE, C) * sizeof(float),
                                           st);
  a.H = H;
  a.W = W;
  a.n = (float)((long long)B * H * W);
  switch (dtype) {
    case tr::kFloat32:
      return dispatch_c<float, MODE>(a, B, C, st);
    case tr::kBFloat16:
      return dispatch_c<__nv_bfloat16, MODE>(a, B, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Common to all five: x [B,H,W,C] of `dtype` (tr::DType) and gy [B,H,W,C]
// f32, contiguous; w1, w2 [3,3,C,C] f32 HWIO, 16-byte aligned; vectors C
// floats; C is 16, 32 or 64. part: B * row_len floats of scratch, row_len =
// 2C (stats), 2C + 9C^2 (bwd1, bwd2) or 4C + 18C^2 (bwd); out: row_len
// floats. Each returns the cudaError_t of its launches on `stream` (two, but
// bwd3's one).

// out = [sum c1 (C), sum c1^2 (C)], c1 = conv3x3(relu(s1*x + b1), w1).
extern "C" int tr_block_stats(const void* x, const void* w1, const void* s1,
                              const void* b1, void* part, void* out, int B,
                              int H, int W, int C, int dtype, int device,
                              void* stream) {
  Args a = {};
  a.x = x;
  a.w1 = static_cast<const float*>(w1);
  a.s1 = static_cast<const float*>(s1);
  a.sb1 = static_cast<const float*>(b1);
  a.part = static_cast<float*>(part);
  a.out = static_cast<float*>(out);
  return run<kStats>(a, B, H, W, C, dtype, device, stream);
}

#define TR_BWD_ARGS                                                         \
  const void *x, const void *gy, const void *w1, const void *w2,            \
      const void *g1, const void *b1, const void *g2, const void *b2,       \
      const void *m1, const void *i1, const void *m2, const void *i2

static Args bwd_args(TR_BWD_ARGS) {
  Args a = {};
  a.x = x;
  a.gy = static_cast<const float*>(gy);
  a.w1 = static_cast<const float*>(w1);
  a.w2 = static_cast<const float*>(w2);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.m1 = static_cast<const float*>(m1);
  a.i1 = static_cast<const float*>(i1);
  a.m2 = static_cast<const float*>(m2);
  a.i2 = static_cast<const float*>(i2);
  return a;
}

// out = [T1 (C), T2 (C), dw2 (9C^2, HWIO)].
extern "C" int tr_block_bwd1(TR_BWD_ARGS, void* part, void* out, int B, int H,
                             int W, int C, int dtype, int device,
                             void* stream) {
  Args a = bwd_args(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2);
  a.part = static_cast<float*>(part);
  a.out = static_cast<float*>(out);
  return run<kBwd1>(a, B, H, W, C, dtype, device, stream);
}

// out = [U1 (C), U2 (C), dw1 (9C^2, HWIO)], given pass 1's T1, T2.
extern "C" int tr_block_bwd2(TR_BWD_ARGS, const void* t1, const void* t2,
                             void* part, void* out, int B, int H, int W,
                             int C, int dtype, int device, void* stream) {
  Args a = bwd_args(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2);
  a.t1 = static_cast<const float*>(t1);
  a.t2 = static_cast<const float*>(t2);
  a.part = static_cast<float*>(part);
  a.out = static_cast<float*>(out);
  return run<kBwd2>(a, B, H, W, C, dtype, device, stream);
}

// dx [B,H,W,C] of `dtype`, given T1, T2 and pass 2's U1, U2.
extern "C" int tr_block_bwd3(TR_BWD_ARGS, const void* t1, const void* t2,
                             const void* u1, const void* u2, void* dx, int B,
                             int H, int W, int C, int dtype, int device,
                             void* stream) {
  Args a = bwd_args(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2);
  a.t1 = static_cast<const float*>(t1);
  a.t2 = static_cast<const float*>(t2);
  a.u1 = static_cast<const float*>(u1);
  a.u2 = static_cast<const float*>(u2);
  a.dx = dx;
  return run<kBwd3>(a, B, H, W, C, dtype, device, stream);
}

// The frozen-BN backward: out = [ds1, db1, ds2, db2 (C each), dw1, dw2 (9C^2
// each, HWIO)] and dx [B,H,W,C] of `dtype`, given the folded BN vectors s1,
// b1, s2, b2.
extern "C" int tr_block_bwd(const void* x, const void* gy, const void* w1,
                            const void* w2, const void* s1, const void* b1,
                            const void* s2, const void* b2, void* part,
                            void* out, void* dx, int B, int H, int W, int C,
                            int dtype, int device, void* stream) {
  Args a = {};
  a.x = x;
  a.gy = static_cast<const float*>(gy);
  a.w1 = static_cast<const float*>(w1);
  a.w2 = static_cast<const float*>(w2);
  a.s1 = static_cast<const float*>(s1);
  a.sb1 = static_cast<const float*>(b1);
  a.s2 = static_cast<const float*>(s2);
  a.sb2 = static_cast<const float*>(b2);
  a.part = static_cast<float*>(part);
  a.out = static_cast<float*>(out);
  a.dx = dx;
  return run<kBwd>(a, B, H, W, C, dtype, device, stream);
}
