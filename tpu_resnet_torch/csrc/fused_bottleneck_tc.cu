// Fused ResNet-v2 bottleneck on the tensor cores: the forward with folded
// batch norm and that forward's gradient, and with live batch-norm
// statistics the two moment passes and the four backward passes. Stride 1, identity shortcut, 3x3 SAME; x is
// NHWC [B,H,W,4F] (f32 or bf16), y (the forward's output) of x's shape and
// type, gy f32 of x's shape, W1 f32 [4F,F], w2 f32 HWIO [3,3,F,F], W3 f32
// [F,4F], BN vectors f32 ([4F] for BN1, [F] for BN2 and BN3), and the
// tensors a launch hands the next, f32 [B,H,W,F]: p2 (the first launch of
// fwd, stats_b and bwd1 to the second), mid, dm3 (pass 1 to 2), dmid (2 to
// 3), dc1 (3 to 4); the folded gradient's p2 and dmid (step 1 to 2).
//
// Replaces, in tpu_resnet/ops/fused_bottleneck.py (every stride-1 identity
// bottleneck of width 64, 128 or 256 runs these when model.fused_blocks=true:
// 10 blocks of ImageNet ResNet-50):
//   mode 5 fwd     _fwd_kernel (:154): y = x + p3 . W3 on the folded affines
//                  (s, b) of the three BNs (serving; in training with the
//                  live moments folded);
//   mode 6 stats_a _stats_a_kernel (:445): sum c1, sum c1^2;
//   mode 4 stats_b _stats_b_kernel (:464): sum mid, sum mid^2;
// and in _train_bwd_calls:
//   mode 2 bwd1  pass1 (:644): T3a = sum dm3, T3b = sum dm3*mhat, and p2,
//                mid, dm3 for pass 2 (dw3 = sum p3^T gy is
//                tr_bottleneck_wgrad's, in bottleneck_wgrad.cu, with p3 from
//                mid);
//   mode 3 bwd2  pass2 (:678): dmid, T2a = sum dm2, T2b = sum dm2*chat (dw2
//                = sum p2-patch^T dmid is tr_bottleneck_wgrad's);
//   mode 0 bwd3  pass3 (:729): T1a = sum dm1, T1b = sum dm1*x1hat, and dc1
//                for dw1 = sum p1^T dc1 (tr_bottleneck_wgrad's);
//   mode 1 bwd4  pass4 (:754): dx = gy + g1*i1*(dm1 - T1a/n - x1hat*(T1b/n));
// and the folded forward's gradient, _bwd_kernel (:241, bottleneck_bwd), on
// the folds as (g, be, mu, i) = (s, b, 0, 1) with no batch-wide correction:
//   mode 7 fold1 fwd's p2 launch writing c1 too, then bwd1's tile pass:
//                db3 = sum dm3, ds3 = sum dm3*mid, p3 (for dW3 = sum p3^T
//                gy) and dmid = s3*dm3; c1 and dmid handed to step 2;
//   mode 8 fold2 bwd3's tile pass and bwd4's in one, from step 1's c1 and
//                dmid:
//                db2 = sum dm2, ds2 = sum dm2*c1, dc1 = s2*dm2 (for dW1 = sum
//                p1^T dc1), then dm1 = (dc1 . W1^T)*[m1>0], db1 = sum dm1,
//                ds1 = sum dm1*x and dx = gy + s1*dm1 (dw2 = sum p2-patch^T
//                dmid is tr_bottleneck_wgrad's too).
// The reference recomputes the chain from x in every kernel, with a halo of
// one or two rows: its VMEM keeps nothing between calls. On this card each
// launch reads what the launch before it wrote, and recomputes only c1, a
// 1x1 product on the tile's own pixels. Per pixel (i = 1/sigma, as the
// reference's _chain_train):
//   c1    x1hat = (x-mu1)*i1, p1 = relu(g1*x1hat + be1), c1 = p1 . W1,
//         chat = (c1-mu2)*i2, m2 = g2*chat + be2;
//   stats_a c1, and the two sums; p1 rounded as the reference's
//         _stats_a_kernel rounds it, relu((g1*(x-mu1))*i1 + be1);
//   p2    launch 1 of fwd, stats_b and bwd1: c1, then p2 = relu(m2), stored.
//         fwd passes its folds as (g, be, mu, i) = (s, b, 0, 1): v - 0 and
//         v * 1 are exact, so p1 = relu(x*s1 + b1) and p2 = relu(c1*s2 + b2)
//         bit for bit, the reference's folded chain;
//   fwd   launch 2: mid = conv3x3(p2, w2), the sum over the 9 taps of p2
//         shifted by the tap times w2[tap]; p3 = relu(s3*mid + b3); y = x +
//         p3 . W3 in x's dtype;
//   stats_b launch 2: mid, and the two sums;
//   bwd1  launch 2: mid, stored; mhat = (mid-mu3)*i3, m3 = g3*mhat + be3;
//         dp3 = gy . W3^T, dm3 = dp3*[m3>0], stored, and the two sums;
//   bwd2  launch 1: dmid = g3*i3*(dm3 - T3a/n - mhat*(T3b/n)), stored;
//         launch 2: c1, dp2 = convT(dmid, w2) (the taps over w2t, w2 flipped
//         in space, in/out swapped), dm2 = dp2*[m2>0], and the two sums;
//   bwd3  c1, dp2 and dm2 as bwd2, dc1 = g2*i2*(dm2 - T2a/n - chat*(T2b/n)),
//         stored; dp1 = dc1 . W1^T, m1 = g1*x1hat + be1, dm1 = dp1*[m1>0],
//         and the two sums;
//   bwd4  dp1 = dc1 . W1^T, dm1 as in bwd3, dx in x's dtype;
//   fold1 launch 2: bwd1's with mhat = mid, p3 stored in mid's place and
//         dmid = s3*dm3 in dm3's: no pass waits for a batch-wide sum;
//   fold2 bwd3's from the handed-over c1 in place of its c1 product, with
//         the BN2 sums, dc1 = s2*dm2, and the BN1 sums and dx = gy + s1*dm1
//         from each round of dp1: bwd2's dmid launch, its c1 and convT,
//         bwd3's c1 and bwd4's pass all drop out.
// Every elementwise formula rounds as written (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, no FMA contraction), as the plain PyTorch version
// does, so a mask [m > 0] agrees with the plain version's wherever the
// products do; p2 and c1 run the same code in every pass, so stats_b's and
// bwd1's p2 and the masks [m2 > 0] of passes 2 and 3 agree bit for bit.
//
// Bound, per pixel (flops; dw's products are the weight-gradient kernel's):
// fwd 34F^2 (c1 8, mid 18, p3 . W3 8), stats_a 8F^2 (c1), stats_b 26F^2
// (c1, mid), bwd1 34F^2 (c1 8, mid 18, dp3 8; dw3 8 more), bwd2 26F^2 (c1
// 8, convT 18; dw2 18 more), bwd3 34F^2 (c1, convT, dp1 8; dw1 8 more),
// bwd4 8F^2, fold1 26F^2 (mid, dp3; its p2 launch c1 8, dW3 8 more), fold2
// 26F^2 (convT, dp1; dw2 18 and dW1 8 more), against a few times 4F items
// moved: operations, but for bwd4 at F=64.
//
// Design. Tiles of 64 consecutive pixels of the [B*H*W] pixel matrix,
// whatever W, so a 14-pixel image row leaves no tile half empty; as many
// blocks as the card holds at once, each walking the tiles with a fixed
// stride. fwd's launches and the folded gradient's take 32-pixel tiles where
// 64-pixel ones would leave SMs idle (B=16 at 14^2: 49 tiles for 132 SMs),
// stats_a 128-pixel tiles
// where F <= 128 (fewer tile epilogues and pipeline fills a pixel). Each
// product runs on mma.sync m16n8k8 in TF32 with the three-term split
// (mma_tf32x3.cuh), 256 threads, 2x4 warps, a warp owning 32 (or 16, or 64)
// pixels x F/4 channels; each k-step's three products start from zero and
// join the running f32 sum rounding to nearest (the tensor cores' own
// accumulation truncates, and over K = 9F that bias broke the sums'
// tolerance). K streams through a
// ring of three shared buffers by cp.async, 16 bytes a thread, A and the
// weight chunk alike (the weights come from L2; they need no region of
// their own): for c1 the tile's x (BN1 and ReLU applied as the fragments are
// read), for gy . W3^T the tile's gy, for the 3x3 products (mid, convT) the
// tap's shifted p2 or dmid rows straight from device memory (zero fill
// outside the image: SAME pads p2 itself with zeros, not relu(b2), and no
// halo is recomputed; at 14^2 the whole plane fits in the 50 MB L2), for
// p3 . W3 and dc1 . W1^T the tile buffer, in four rounds of F output
// channels. A value an epilogue or a later product needs waits in the tile
// buffer [BM][F + 4]: p3 (fwd), mhat (bwd1), chat then dc1 (bwd2, bwd3).
// bwd2's dmid is its own elementwise launch: T3a and T3b are sums over the
// whole batch, and the convT reads dmid at neighbouring pixels.
//
// Sums without atomics: each block adds its tiles' channel sums in tile
// order (a warp's rows by shuffles in a fixed pattern, then the two warps of
// a column in order), writes one row, and bottleneck_sum_kernel adds the
// rows in block order. Two calls agree bit for bit.

#include <algorithm>
#include <type_traits>

#include "mma_tf32x3.cuh"
#include "row_sums.cuh"
#include "tile_fma.cuh"

namespace {

using namespace tr;

// Modes 0-8 are tr_bottleneck_tc's (one pass or kernel each). The rest are
// first launches: p2 on the live moments (bwd1, stats_b) or on the folded
// affines (fwd; fold1, which writes c1 too), each its own entry point so
// that a profile books it to its kernel.
enum Mode : int {
  kBwd3 = 0,
  kBwd4 = 1,
  kBwd1 = 2,
  kBwd2 = 3,
  kStatsB = 4,
  kFwd = 5,
  kStatsA = 6,
  kFold1 = 7,
  kFold2 = 8,
  kP2 = 9,
  kStatsBP2 = 10,
  kFwdP2 = 11,
  kFoldP2 = 12
};
__host__ __device__ constexpr bool p2_mode(int mode) { return mode >= kP2; }

constexpr int kTC = 256;    // threads per block
constexpr int kBK = 32;     // K per staged chunk
constexpr int kStages = 3;  // the cp.async ring
constexpr int kWarpsN = 4;  // warps across channels; 2 across pixels
constexpr int kMT = 2;      // 16-pixel mma tiles per warp: 64-pixel tiles

// Shared memory, in bytes, for tiles of BM = 32*MT pixels: the ring (each
// stage an A chunk [BM][32 + pad] and a weight chunk [32][F + 8] f32); the
// tile buffer [BM][F + 4] f32 (bwd1-4, fwd); BN1's vectors [4F] float4 (g1,
// be1, mu1, i1; the launches that recompute c1); then the block's sums, [2F]
// f32 (bwd1, bwd2, stats_a, stats_b, fold1), [8F] (bwd3) or [10F] (fold2),
// or for bwd4 [4F] float4 (g1*i1, T1a/n, T1b/n). The pads keep the fragment reads free of
// bank conflicts. stats_a takes tiles of 128 pixels where F <= 128.
template <int F, int MT = kMT>
struct Plan {
  static constexpr int BM = 32 * MT;      // pixels per tile
  static constexpr int WN = F / kWarpsN;  // channels per warp
  static constexpr int NT = WN / 8;       // 8-channel mma tiles per warp
  static constexpr int BS = F + 8;        // weight chunk row stride, floats
  static constexpr int CS = F + 4;        // tile buffer row stride, floats
  static constexpr int A_BYTES = BM * (kBK + 4) * 4;
  static constexpr int STAGE = A_BYTES + kBK * BS * 4;
  static constexpr int RING = kStages * STAGE;
  static constexpr int C_BYTES = BM * CS * 4;
  static constexpr int E0_BYTES = 4 * F * 16;
  static constexpr int SMEM_P2 = RING + E0_BYTES;
  static constexpr int SMEM_FWD = RING + C_BYTES;
  static constexpr int SMEM_STATS_A = RING + E0_BYTES + 2 * F * 4;
  static constexpr int SMEM_STATS_B = RING + 2 * F * 4;
  static constexpr int SMEM_BWD1 = RING + C_BYTES + 2 * F * 4;
  static constexpr int SMEM_BWD2 = RING + C_BYTES + E0_BYTES + 2 * F * 4;
  static constexpr int SMEM_BWD3 = RING + C_BYTES + E0_BYTES + 8 * F * 4;
  static constexpr int SMEM_BWD4 = RING + C_BYTES + E0_BYTES + 4 * F * 16;
  static constexpr int SMEM_FOLD2 = RING + C_BYTES + E0_BYTES + 10 * F * 4;
  static_assert(SMEM_P2 <= kMaxSmem && SMEM_FWD <= kMaxSmem &&
                    SMEM_STATS_A <= kMaxSmem && SMEM_STATS_B <= kMaxSmem &&
                    SMEM_BWD1 <= kMaxSmem && SMEM_BWD2 <= kMaxSmem &&
                    SMEM_BWD3 <= kMaxSmem && SMEM_BWD4 <= kMaxSmem &&
                    SMEM_FOLD2 <= kMaxSmem,
                "smem");
  static_assert(F % kBK == 0 && NT >= 1 && (MT == 1 || MT == 2 || MT == 4),
                "tile");
  __host__ __device__ static constexpr int e0_off(int mode) {
    return p2_mode(mode) || mode == kStatsA ? RING : RING + C_BYTES;
  }
  __host__ __device__ static constexpr int sums_off(int mode) {
    return mode == kStatsB   ? RING
           : mode == kStatsA ? RING + E0_BYTES
           : mode == kBwd1 || mode == kFold1 ? RING + C_BYTES
                                               : RING + C_BYTES + E0_BYTES;
  }
  __host__ __device__ static constexpr int smem(int mode) {
    return p2_mode(mode)      ? SMEM_P2
           : mode == kFwd     ? SMEM_FWD
           : mode == kStatsA  ? SMEM_STATS_A
           : mode == kStatsB  ? SMEM_STATS_B
           : mode == kBwd1 || mode == kFold1 ? SMEM_BWD1
           : mode == kBwd2                   ? SMEM_BWD2
           : mode == kBwd3                   ? SMEM_BWD3
           : mode == kFold2                  ? SMEM_FOLD2
                                             : SMEM_BWD4;
  }
};
// The largest width, in bytes: every mode fits one block of 256 threads on
// an SM.
static_assert(Plan<256>::SMEM_P2 == 145408 && Plan<256>::SMEM_FWD == 195584 &&
                  Plan<256>::SMEM_STATS_A == 147456 &&
                  Plan<256>::SMEM_STATS_B == 131072 &&
                  Plan<256>::SMEM_BWD1 == 197632 &&
                  Plan<256>::SMEM_BWD2 == 214016 &&
                  Plan<256>::SMEM_BWD3 == 220160 &&
                  Plan<256>::SMEM_BWD4 == 228352 &&
                  Plan<256>::SMEM_FOLD2 == 222208 &&
                  Plan<256, 1>::SMEM_P2 == 131584 &&
                  Plan<256, 1>::SMEM_FWD == 148480,
              "the plan at F = 256");

struct TcArgs {
  const void* x;      // [P][4F] (not the tile passes of bwd1, stats_b)
  const float* gy;    // [P][4F] (bwd1, bwd4)
  const float* w1;    // [4F][F]
  const float* w2;    // [9F][F] (fwd, stats_b, bwd1)
  const float* w2t;   // [9F][F] (bwd2, bwd3)
  const float* w3t;   // [4F][F]: W3 transposed (bwd1)
  const float* w1t;   // [F][4F]
  const float* w3;    // [F][4F] (fwd)
  // BN1-3; fwd and the folded steps read the folds (s, b) as (g, be) and
  // no mu, i.
  const float *g1, *be1, *mu1, *i1;  // [4F]
  const float *g2, *be2, *mu2, *i2;  // [F]
  const float *g3, *be3, *mu3, *i3;  // [F] (fwd, bwd1, bwd2)
  const float *t3a, *t3b;            // [F] (bwd2)
  const float *t2a, *t2b;            // [F] (bwd3)
  const float *t1a, *t1b;            // [4F] (bwd4)
  float* p2;          // [P][F]: the first launch writes it, the 3x3 reads it
                      // (and bwd1 returns it, for pass 2's dw2)
  float* mid;         // [P][F]: bwd1 writes it, bwd2 reads it
  float* p3;          // [P][F]: fold1 writes it for dW3
  float* c1;          // [P][F]: fold1's p2 launch writes it, fold2 reads it
  float* dm3;         // [P][F]: bwd1 writes it, bwd2 reads it
  float* dmid;        // [P][F]: bwd2 writes it, bwd3 reads it (fold1, fold2)
  float* dc1;         // [P][F]: bwd3 writes it, bwd4 reads it (fold2 writes
                      // it for dW1)
  void* dx;           // [P][4F] (bwd4, fold2)
  void* y;            // [P][4F] (fwd)
  float* part;        // [gridDim.x][2F, 8F or 10F] (stats, bwd1-3, folds)
  int P, H, W;
  float n;  // B*H*W
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// relu(g*((v-mu)*i) + be), p = (g, be, mu, i): a BN and its ReLU.
__device__ __forceinline__ float bn_relu(float v, float4 p) {
  return fmaxf(add(mul(p.x, mul(sub(v, p.z), p.w)), p.y), 0.f);
}
// relu((g*(v-mu))*i + be): the order of the reference's _stats_a_kernel.
__device__ __forceinline__ float bn_relu_stats_a(float v, float4 p) {
  return fmaxf(add(mul(mul(p.x, sub(v, p.z)), p.w), p.y), 0.f);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc += A . Bm over `chunks` chunks of kBK: issue(c, stage) starts the
// thread's cp.async copies of chunk c into a ring stage, frag(stage, c, kk,
// mi, big, small) gives the split A fragment of mma tile mi at k-step kk;
// the weight chunk sits after the stage's A chunk. Leaves the ring idle
// (every copy landed, every thread past its last read).
template <int F, int MT, class Issue, class Frag>
__device__ __forceinline__ void tc_gemm(float (&acc)[MT][Plan<F>::NT][4],
                                        int chunks, unsigned char* ring,
                                        Issue issue, Frag frag) {
  using PL = Plan<F, MT>;
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) % kWarpsN;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < PL::NT; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) issue(s, ring + s * PL::STAGE);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c's copies (this thread's)
    __syncthreads();               // everyone's; stage c-1 is free again
    const int next = c + kStages - 1;
    if (next < chunks) issue(next, ring + (next % kStages) * PL::STAGE);
    cp_async_commit();
    const unsigned char* st = ring + (c % kStages) * PL::STAGE;
    const float* bs = reinterpret_cast<const float*>(st + PL::A_BYTES);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t a_big[MT][4], a_small[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        frag(st, c, kk, mi, a_big[mi], a_small[mi]);
#pragma unroll
      for (int ni = 0; ni < PL::NT; ++ni) {
        const int col = wn * PL::WN + ni * 8 + g;
        const Split b0 = split(bs[(kk + t) * PL::BS + col]);
        const Split b1 = split(bs[(kk + t + 4) * PL::BS + col]);
        const uint32_t b_big[2] = {b0.big, b1.big};
        const uint32_t b_small[2] = {b0.small, b1.small};
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          // One k-step's three products from zero, added rounding to
          // nearest (see the design note).
          float step[4] = {0.f, 0.f, 0.f, 0.f};
          mma_x3(step, a_big[mi], a_small[mi], b_big, b_small);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[mi][ni][q] = __fadd_rn(acc[mi][ni][q], step[q]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Adds a tile's channel sums, sa and sb over the thread's column pairs, to
// first[col] and second[col] for the F columns: a warp's 32 rows by shuffles
// (lanes of one t hold one column pair) in a fixed pattern, then the two
// warps of a column in order. red: 4F floats of the idle ring.
template <int F>
__device__ __forceinline__ void add_tile_sums(float (&sa)[Plan<F>::NT][2],
                                              float (&sb)[Plan<F>::NT][2],
                                              float* red, float* first,
                                              float* second) {
  using PL = Plan<F>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < PL::NT; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float u = sa[ni][j], v = sb[ni][j];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        u += __shfl_xor_sync(0xffffffffu, u, o);
        v += __shfl_xor_sync(0xffffffffu, v, o);
      }
      if (g == 0) {
        const int col = wn * PL::WN + ni * 8 + 2 * t + j;
        red[(wm * 2) * F + col] = u;
        red[(wm * 2 + 1) * F + col] = v;
      }
    }
  __syncthreads();
  for (int k = tid; k < 2 * F; k += kTC) {
    const int which = k / F, col = k % F;
    (which ? second : first)[col] +=
        red[which * F + col] + red[(2 + which) * F + col];
  }
  __syncthreads();  // red lives in the ring the next product fills
}

template <typename T, int F, int MODE, int MT = kMT>
__device__ __forceinline__ void tc_body(const TcArgs& a) {
  using PL = Plan<F, MT>;
  constexpr int C4 = 4 * F;
  constexpr int NT = PL::NT;
  constexpr int BM = PL::BM;
  // The launches that recompute c1 keep BN1's vectors in shared memory.
  constexpr bool kBn1 = p2_mode(MODE) || MODE == kStatsA || MODE == kBwd2 ||
                       MODE == kBwd3 || MODE == kBwd4 || MODE == kFold2;
  // The folded steps: BN's (mu, i) are (0, 1), the correction none.
  constexpr bool kFolded = MODE == kFwdP2 || MODE == kFoldP2 ||
                          MODE == kFold1 || MODE == kFold2;
  constexpr int NSUM = MODE == kBwd3    ? 2 * C4
                       : MODE == kFold2 ? 2 * C4 + 2 * F
                       : MODE == kBwd1 || MODE == kBwd2 || MODE == kStatsA ||
                               MODE == kStatsB || MODE == kFold1
                           ? 2 * F
                           : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* cbuf = reinterpret_cast<float*>(smem + PL::RING);
  float4* e0 = reinterpret_cast<float4*>(smem + PL::e0_off(MODE));
  float* sums = reinterpret_cast<float*>(smem + PL::sums_off(MODE));
  float4* e1 = reinterpret_cast<float4*>(smem + PL::sums_off(MODE));  // bwd4
  float* red = reinterpret_cast<float*>(smem);  // the idle ring, [2][2][F]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = wm * 16 * MT;  // the warp's first row in the tile
  const float n = a.n;
  const T* xg = static_cast<const T*>(a.x);

  if constexpr (kBn1) {
    for (int c = tid; c < C4; c += kTC) {
      if constexpr (kFolded)  // the folds (s1, b1) as (s1, b1, 0, 1)
        e0[c] = make_float4(a.g1[c], a.be1[c], 0.f, 1.f);
      else
        e0[c] = make_float4(a.g1[c], a.be1[c], a.mu1[c], a.i1[c]);
      if constexpr (MODE == kBwd4)
        e1[c] = make_float4(mul(a.g1[c], a.i1[c]), __fdiv_rn(a.t1a[c], n),
                            __fdiv_rn(a.t1b[c], n), 0.f);
    }
  }
  for (int k = tid; k < NSUM; k += kTC) sums[k] = 0.f;
  __syncthreads();

  // The thread's share of a weight chunk: kBK rows of F floats from a
  // row-major matrix with row stride ld.
  auto issue_w = [&](unsigned char* st, const float* src, int ld) {
    float* bs = reinterpret_cast<float*>(st + PL::A_BYTES);
    constexpr int SEGS = F / 4;
#pragma unroll
    for (int q = 0; q < kBK * SEGS / kTC; ++q) {
      const int idx = tid + q * kTC, k = idx / SEGS, s = idx % SEGS;
      cp_async16(bs + k * PL::BS + s * 4, src + (long long)k * ld + s * 4,
                 true);
    }
  };
  // A fragments from f32 rows of stride rs: rows r, r+8 at columns k, k+4.
  auto frag_rows = [&](const float* base, int rs, int k, int mi,
                       uint32_t(&big)[4], uint32_t(&small)[4]) {
    const int r = row0 + mi * 16 + g;
    const float v[4] = {base[r * rs + k], base[(r + 8) * rs + k],
                        base[r * rs + k + 4], base[(r + 8) * rs + k + 4]};
    split4(v, big, small);
  };
  auto frag_stage = [&](const unsigned char* st, int, int kk, int mi,
                        uint32_t(&big)[4], uint32_t(&small)[4]) {
    frag_rows(reinterpret_cast<const float*>(st), kBK + 4, kk + t, mi, big,
              small);
  };

  float acc[MT][NT][4];
  float sa[NT][2], sb[NT][2];  // the thread's share of a tile's sums
  auto zero_sums = [&] {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      sa[ni][0] = sa[ni][1] = sb[ni][0] = sb[ni][1] = 0.f;
  };
  // The position of each of the thread's MT A rows in a chunk: image, y,
  // x, inside P.
  int rb[MT], ry[MT], rx[MT];
  bool rv[MT];
  long long p0 = 0;

  // c1 = p1 . W1 on the tile; the A chunks are raw x, BN1 and ReLU applied
  // as the fragments are read, in stats_a's order there.
  auto bn1 = [](float v, float4 p) {
    if constexpr (MODE == kStatsA) return bn_relu_stats_a(v, p);
    else return bn_relu(v, p);
  };
  auto gemm_c1 = [&] {
    constexpr int ARS = kBK + 16 / (int)sizeof(T);  // A row stride, items
    constexpr int ASEG = kBK * (int)sizeof(T) / 16;  // 16 B per row chunk
    constexpr int AQ = (BM * ASEG + kTC - 1) / kTC;  // copies per thread
    tc_gemm<F, MT>(
        acc, C4 / kBK, ring,
        [&](int c, unsigned char* st) {
          T* as = reinterpret_cast<T*>(st);
#pragma unroll
          for (int q = 0; q < AQ; ++q) {
            const int idx = tid + q * kTC, r = idx / ASEG, s = idx % ASEG;
            if (BM * ASEG % kTC != 0 && idx >= BM * ASEG) break;
            const long long p = p0 + r;
            const bool ok = p < a.P;
            cp_async16(as + r * ARS + s * (16 / (int)sizeof(T)),
                       xg + (ok ? p : 0) * C4 + c * kBK +
                           s * (16 / (int)sizeof(T)),
                       ok);
          }
          issue_w(st, a.w1 + (long long)c * kBK * F, F);
        },
        [&](const unsigned char* st, int c, int kk, int mi, uint32_t(&big)[4],
            uint32_t(&small)[4]) {
          const T* as = reinterpret_cast<const T*>(st);
          const int r = row0 + mi * 16 + g, k = kk + t;
          const float4 pa = e0[c * kBK + k], pb = e0[c * kBK + k + 4];
          const float v[4] = {bn1(to_f32(as[r * ARS + k]), pa),
                              bn1(to_f32(as[(r + 8) * ARS + k]), pa),
                              bn1(to_f32(as[r * ARS + k + 4]), pb),
                              bn1(to_f32(as[(r + 8) * ARS + k + 4]), pb)};
          split4(v, big, small);
        });
  };
  // A 3x3 SAME product on the tile: per chunk one tap's shifted rows of src
  // [P][F] (zero outside the image), times wsrc [9F][F].
  auto gemm_3x3 = [&](const float* src, const float* wsrc) {
    tc_gemm<F, MT>(
        acc, 9 * F / kBK, ring,
        [&](int c, unsigned char* st) {
          float* as = reinterpret_cast<float*>(st);
          const int k0 = c * kBK, tap = k0 / F, ci0 = k0 % F;
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
          for (int q = 0; q < MT; ++q) {
            const int idx = tid + q * kTC, r = idx >> 3, s = idx & 7;
            const int y = ry[q] + dy, xx = rx[q] + dx;
            const bool ok = rv[q] && y >= 0 && y < a.H && xx >= 0 && xx < a.W;
            const long long pix =
                ok ? ((long long)rb[q] * a.H + y) * a.W + xx : 0;
            cp_async16(as + r * (kBK + 4) + s * 4, src + pix * F + ci0 + s * 4,
                       ok);
          }
          issue_w(st, wsrc + (long long)k0 * F, F);
        },
        frag_stage);
  };
  // Output channels n0 .. n0+F of the tile buffer [BM][F] times wt [F][4F]
  // (p3 . W3, dc1 . W1^T): one of four rounds.
  auto gemm_expand = [&](const float* wt, int n0) {
    tc_gemm<F, MT>(
        acc, F / kBK, ring,
        [&](int c, unsigned char* st) {
          issue_w(st, wt + (long long)c * kBK * C4 + n0, C4);
        },
        [&](const unsigned char*, int c, int kk, int mi, uint32_t(&big)[4],
            uint32_t(&small)[4]) {
          frag_rows(cbuf, PL::CS, c * kBK + kk + t, mi, big, small);
        });
  };
  // The tile's rows of src [P][F] into the tile buffer.
  auto load_tile = [&](const float* src) {
    constexpr int SEGS = F / 4;
#pragma unroll
    for (int q = 0; q < BM * SEGS / kTC; ++q) {
      const int idx = tid + q * kTC, r = idx / SEGS, s = idx % SEGS;
      const long long p = p0 + r;
      const bool ok = p < a.P;
      cp_async16(cbuf + r * PL::CS + s * 4, src + (ok ? p : 0) * F + s * 4,
                 ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };
  // chat = (c1-mu2)*i2 (folded: c1) into the tile buffer.
  auto store_chat = [&] {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int col = wn * PL::WN + ni * 8 + 2 * t;
        const float2 mu = kFolded ? make_float2(0.f, 0.f) : load2(a.mu2 + col);
        const float2 iv = kFolded ? make_float2(1.f, 1.f) : load2(a.i2 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* cp = cbuf + (row0 + mi * 16 + g + 8 * h) * PL::CS + col;
          cp[0] = mul(sub(acc[mi][ni][2 * h], mu.x), iv.x);
          cp[1] = mul(sub(acc[mi][ni][2 * h + 1], mu.y), iv.y);
        }
      }
  };

  const int tiles = (a.P + BM - 1) / BM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    p0 = (long long)tile * BM;
    if constexpr (MODE == kBwd1 || MODE == kBwd2 || MODE == kBwd3 ||
                  MODE == kFwd || MODE == kStatsB || MODE == kFold1 ||
                  MODE == kFold2) {
#pragma unroll
      for (int q = 0; q < MT; ++q) {
        const long long p = p0 + ((tid + q * kTC) >> 3);
        rv[q] = p < a.P;
        const long long hw = (long long)a.H * a.W;
        const int rem = (int)(p % hw);
        rb[q] = (int)(p / hw);
        ry[q] = rem / a.W;
        rx[q] = rem % a.W;
      }
    }

    if constexpr (p2_mode(MODE)) {
      // p2 = relu(g2*chat + be2), to device memory (fwd: relu(s2*c1 + b2)).
      gemm_c1();
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int col = wn * PL::WN + ni * 8 + 2 * t;
          float4 b0 = make_float4(__ldg(a.g2 + col), __ldg(a.be2 + col), 0.f,
                                  1.f);
          float4 b1 = make_float4(__ldg(a.g2 + col + 1),
                                  __ldg(a.be2 + col + 1), 0.f, 1.f);
          if constexpr (!kFolded) {
            b0.z = __ldg(a.mu2 + col);
            b0.w = __ldg(a.i2 + col);
            b1.z = __ldg(a.mu2 + col + 1);
            b1.w = __ldg(a.i2 + col + 1);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long p = p0 + row0 + mi * 16 + g + 8 * h;
            if (p < a.P)
              store2(a.p2 + p * F + col, bn_relu(acc[mi][ni][2 * h], b0),
                     bn_relu(acc[mi][ni][2 * h + 1], b1));
            if constexpr (MODE == kFoldP2)  // c1 too, for fold2
              if (p < a.P)
                store2(a.c1 + p * F + col, acc[mi][ni][2 * h],
                       acc[mi][ni][2 * h + 1]);
          }
        }
    } else if constexpr (MODE == kStatsA || MODE == kStatsB) {
      // stats_a: c1; stats_b: mid = conv3x3(p2, w2). Then the sums of the
      // product and its square over the tile's pixels.
      if constexpr (MODE == kStatsA) gemm_c1();
      else gemm_3x3(a.p2, a.w2);
      zero_sums();
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool ok = p0 + row0 + mi * 16 + g + 8 * h < a.P;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float v = ok ? acc[mi][ni][2 * h + j] : 0.f;
              sa[ni][j] += v;
              sb[ni][j] = fmaf(v, v, sb[ni][j]);
            }
          }
      add_tile_sums<F>(sa, sb, red, sums, sums + F);
    } else if constexpr (MODE == kFwd) {
      // mid = conv3x3(p2, w2), then p3 = relu(s3*mid + b3) into the tile
      // buffer.
      gemm_3x3(a.p2, a.w2);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int col = wn * PL::WN + ni * 8 + 2 * t;
          const float2 sv = load2(a.g3 + col), bv = load2(a.be3 + col);
          const float4 b0 = make_float4(sv.x, bv.x, 0.f, 1.f);
          const float4 b1 = make_float4(sv.y, bv.y, 0.f, 1.f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* cp = cbuf + (row0 + mi * 16 + g + 8 * h) * PL::CS + col;
            cp[0] = bn_relu(acc[mi][ni][2 * h], b0);
            cp[1] = bn_relu(acc[mi][ni][2 * h + 1], b1);
          }
        }
      // y = x + p3 . W3 in four rounds of F output channels.
      for (int n0 = 0; n0 < C4; n0 += F) {
        gemm_expand(a.w3, n0);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long p = p0 + row0 + mi * 16 + g + 8 * h;
            if (p >= a.P) continue;
#pragma unroll
            for (int ni = 0; ni < NT; ++ni) {
              const int cc = n0 + wn * PL::WN + ni * 8 + 2 * t;
              const float2 xv = load2(xg + p * C4 + cc);
              store2(static_cast<T*>(a.y) + p * C4 + cc,
                     add(xv.x, acc[mi][ni][2 * h]),
                     add(xv.y, acc[mi][ni][2 * h + 1]));
            }
          }
      }
    } else if constexpr (MODE == kBwd1 || MODE == kFold1) {
      // mid = conv3x3(p2, w2): stored (folded: p3 = relu(s3*mid + b3), dW3's
      // rows), and mhat (folded: mid) into the tile buffer.
      gemm_3x3(a.p2, a.w2);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int col = wn * PL::WN + ni * 8 + 2 * t;
          const float2 mu = kFolded ? make_float2(0.f, 0.f)
                                    : load2(a.mu3 + col);
          const float2 iv = kFolded ? make_float2(1.f, 1.f)
                                    : load2(a.i3 + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + mi * 16 + g + 8 * h;
            const long long p = p0 + row;
            float* cp = cbuf + row * PL::CS + col;
            const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
            cp[0] = mul(sub(v0, mu.x), iv.x);
            cp[1] = mul(sub(v1, mu.y), iv.y);
            if constexpr (kFolded) {
              if (p < a.P) {
                const float2 sv = load2(a.g3 + col), bv = load2(a.be3 + col);
                store2(a.p3 + p * F + col,
                       bn_relu(v0, make_float4(sv.x, bv.x, 0.f, 1.f)),
                       bn_relu(v1, make_float4(sv.y, bv.y, 0.f, 1.f)));
              }
            } else if (p < a.P) {
              store2(a.mid + p * F + col, v0, v1);
            }
          }
        }
      // dp3 = gy . W3^T; the A chunks are the tile's gy rows.
      tc_gemm<F, MT>(
          acc, C4 / kBK, ring,
          [&](int c, unsigned char* st) {
            float* as = reinterpret_cast<float*>(st);
#pragma unroll
            for (int q = 0; q < MT; ++q) {
              const int idx = tid + q * kTC, r = idx >> 3, s = idx & 7;
              const long long p = p0 + r;
              const bool ok = p < a.P;
              cp_async16(as + r * (kBK + 4) + s * 4,
                         a.gy + (ok ? p : 0) * C4 + c * kBK + s * 4, ok);
            }
            issue_w(st, a.w3t + (long long)c * kBK * F, F);
          },
          frag_stage);
      // dm3, stored (folded: dmid = s3*dm3), and the sums.
      zero_sums();
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int col = wn * PL::WN + ni * 8 + 2 * t;
          const float2 gv = load2(a.g3 + col), bv = load2(a.be3 + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + mi * 16 + g + 8 * h;
            const long long p = p0 + row;
            const bool ok = p < a.P;
            const float* cp = cbuf + row * PL::CS + col;
            float d[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float mh = cp[j];
              const float m3 = add(mul(j ? gv.y : gv.x, mh), j ? bv.y : bv.x);
              d[j] = ok && m3 > 0.f ? acc[mi][ni][2 * h + j] : 0.f;
              sa[ni][j] += d[j];
              sb[ni][j] = fmaf(d[j], mh, sb[ni][j]);
            }
            if constexpr (kFolded) {
              if (ok)
                store2(a.dmid + p * F + col, mul(d[0], gv.x),
                       mul(d[1], gv.y));
            } else if (ok) {
              store2(a.dm3 + p * F + col, d[0], d[1]);
            }
          }
        }
      add_tile_sums<F>(sa, sb, red, sums, sums + F);
    } else if constexpr (MODE == kBwd2 || MODE == kBwd3 || MODE == kFold2) {
      if constexpr (MODE == kFold2) {
        load_tile(a.c1);  // chat = c1, fold1's
      } else {
        gemm_c1();
        store_chat();
      }
      // dp2 = convT(dmid).
      gemm_3x3(a.dmid, a.w2t);
      if constexpr (MODE == kBwd2) {
        // dm2 and the sums.
        zero_sums();
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            const int col = wn * PL::WN + ni * 8 + 2 * t;
            const float2 gv = load2(a.g2 + col), bv = load2(a.be2 + col);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + mi * 16 + g + 8 * h;
              const bool ok = p0 + row < a.P;
              const float* cp = cbuf + row * PL::CS + col;
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float ch = cp[j];
                const float m2 =
                    add(mul(j ? gv.y : gv.x, ch), j ? bv.y : bv.x);
                const float dm2 =
                    ok && m2 > 0.f ? acc[mi][ni][2 * h + j] : 0.f;
                sa[ni][j] += dm2;
                sb[ni][j] = fmaf(dm2, ch, sb[ni][j]);
              }
            }
          }
        add_tile_sums<F>(sa, sb, red, sums, sums + F);
      } else {
        // dm2, then dc1 in place of chat, and to device memory; folded: dc1
        // = s2*dm2, and the BN2 sums.
        if constexpr (kFolded) zero_sums();
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            const int col = wn * PL::WN + ni * 8 + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + mi * 16 + g + 8 * h;
              const long long p = p0 + row;
              float* cp = cbuf + row * PL::CS + col;
              float d[2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int cc = col + j;
                const float g2 = __ldg(a.g2 + cc), ch = cp[j];
                const float m2 = add(mul(g2, ch), __ldg(a.be2 + cc));
                const float dm2 = m2 > 0.f && (!kFolded || p < a.P)
                                      ? acc[mi][ni][2 * h + j]
                                      : 0.f;
                if constexpr (kFolded) {
                  sa[ni][j] += dm2;
                  sb[ni][j] = fmaf(dm2, ch, sb[ni][j]);
                  d[j] = mul(dm2, g2);
                } else {
                  d[j] = p < a.P
                             ? mul(mul(g2, __ldg(a.i2 + cc)),
                                   sub(sub(dm2,
                                           __fdiv_rn(__ldg(a.t2a + cc), n)),
                                       mul(ch,
                                           __fdiv_rn(__ldg(a.t2b + cc), n))))
                             : 0.f;
                }
                cp[j] = d[j];
              }
              if (p < a.P) store2(a.dc1 + p * F + col, d[0], d[1]);
            }
          }
        if constexpr (kFolded)
          add_tile_sums<F>(sa, sb, red, sums + 2 * C4, sums + 2 * C4 + F);
      }
    } else {
      load_tile(a.dc1);  // the tile's dc1, from pass 3
    }

    if constexpr (MODE == kBwd3 || MODE == kBwd4 || MODE == kFold2) {
      // dp1 = dc1 . W1^T in four rounds of F output channels: dm1, then the
      // sums (bwd3), dx (bwd4) or both (fold2: dx = gy + s1*dm1).
      for (int n0 = 0; n0 < C4; n0 += F) {
        gemm_expand(a.w1t, n0);
        zero_sums();
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long p = p0 + row0 + mi * 16 + g + 8 * h;
            const bool ok = p < a.P;
#pragma unroll
            for (int ni = 0; ni < NT; ++ni) {
              const int cc = n0 + wn * PL::WN + ni * 8 + 2 * t;
              const float2 xv =
                  ok ? load2(xg + p * C4 + cc) : make_float2(0.f, 0.f);
              float d[2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float4 pr = e0[cc + j];
                const float xh = mul(sub(j ? xv.y : xv.x, pr.z), pr.w);
                const float m1 = add(mul(pr.x, xh), pr.y);
                const float dm1 =
                    ok && m1 > 0.f ? acc[mi][ni][2 * h + j] : 0.f;
                if constexpr (MODE != kBwd4) {
                  sa[ni][j] += dm1;
                  sb[ni][j] = fmaf(dm1, xh, sb[ni][j]);
                }
                if constexpr (MODE == kFold2) {
                  d[j] = mul(dm1, pr.x);
                } else if constexpr (MODE == kBwd4) {
                  const float4 q1 = e1[cc + j];
                  d[j] = mul(q1.x, sub(sub(dm1, q1.y), mul(xh, q1.z)));
                }
              }
              if constexpr (MODE != kBwd3) {
                if (ok) {
                  const float2 gv = load2(a.gy + p * C4 + cc);
                  store2(static_cast<T*>(a.dx) + p * C4 + cc, add(gv.x, d[0]),
                         add(gv.y, d[1]));
                }
              }
            }
          }
        if constexpr (MODE != kBwd4)
          add_tile_sums<F>(sa, sb, red, sums + n0, sums + C4 + n0);
      }
    }
  }
  for (int k = tid; k < NSUM; k += kTC)
    a.part[(long long)blockIdx.x * NSUM + k] = sums[k];
}

// One entry point per launch, so that a profile names it. fwd's tile pass
// asks for one block per SM at F >= 128 (left free, ptxas held the 32-pixel
// one at F=256 to 128 registers and spilled 116 bytes) and two at F=64
// (with one, more registers cost it blocks per SM: 56^2 at B=128 took 2.32
// ms a launch against 1.89).
template <typename T, int F, int MT>
__global__ void __launch_bounds__(kTC) bottleneck_fwd_p2_kernel(const TcArgs a) {
  tc_body<T, F, kFwdP2, MT>(a);
}
template <typename T, int F, int MT>
__global__ void __launch_bounds__(kTC, F == 64 ? 2 : 1)
    bottleneck_fwd_kernel(const TcArgs a) {
  tc_body<T, F, kFwd, MT>(a);
}
template <typename T, int F, int MT>
__global__ void __launch_bounds__(kTC)
    bottleneck_stats_a_kernel(const TcArgs a) {
  tc_body<T, F, kStatsA, MT>(a);
}
template <typename T, int F>
__global__ void __launch_bounds__(kTC)
    bottleneck_stats_b_p2_kernel(const TcArgs a) {
  tc_body<T, F, kStatsBP2>(a);
}
template <typename T, int F>
__global__ void __launch_bounds__(kTC)
    bottleneck_stats_b_kernel(const TcArgs a) {
  tc_body<T, F, kStatsB>(a);
}
template <typename T, int F>
__global__ void __launch_bounds__(kTC)
    bottleneck_bwd1_p2_kernel(const TcArgs a) {
  tc_body<T, F, kP2>(a);
}
template <typename T, int F>
__global__ void __launch_bounds__(kTC) bottleneck_bwd1_kernel(const TcArgs a) {
  tc_body<T, F, kBwd1>(a);
}
template <typename T, int F>
__global__ void __launch_bounds__(kTC) bottleneck_bwd2_kernel(const TcArgs a) {
  tc_body<T, F, kBwd2>(a);
}
template <typename T, int F>
__global__ void __launch_bounds__(kTC) bottleneck_bwd3_kernel(const TcArgs a) {
  tc_body<T, F, kBwd3>(a);
}
template <typename T, int F>
__global__ void __launch_bounds__(kTC) bottleneck_bwd4_kernel(const TcArgs a) {
  tc_body<T, F, kBwd4>(a);
}
template <typename T, int F, int MT>
__global__ void __launch_bounds__(kTC)
    bottleneck_fold1_p2_kernel(const TcArgs a) {
  tc_body<T, F, kFoldP2, MT>(a);
}
template <typename T, int F, int MT>
__global__ void __launch_bounds__(kTC)
    bottleneck_fold1_kernel(const TcArgs a) {
  tc_body<T, F, kFold1, MT>(a);
}
template <typename T, int F, int MT>
__global__ void __launch_bounds__(kTC)
    bottleneck_fold2_kernel(const TcArgs a) {
  tc_body<T, F, kFold2, MT>(a);
}

// bwd2's first launch, elementwise over [P][F], four channels a thread:
// dmid = g3*i3*(dm3 - T3a/n - mhat*(T3b/n)), mhat = (mid-mu3)*i3.
template <int F>
__global__ void __launch_bounds__(kTC)
    bottleneck_bwd2_dmid_kernel(const TcArgs a) {
  const long long total = (long long)a.P * (F / 4);
  const float n = a.n;
  for (long long i = (long long)blockIdx.x * kTC + threadIdx.x; i < total;
       i += (long long)gridDim.x * kTC) {
    const int c = (int)(i % (F / 4)) * 4;
    const float4 d = load4(a.dm3 + i * 4), m = load4(a.mid + i * 4);
    const float dv[4] = {d.x, d.y, d.z, d.w}, mv[4] = {m.x, m.y, m.z, m.w};
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = c + q;
      const float i3 = __ldg(a.i3 + cc);
      const float mh = mul(sub(mv[q], __ldg(a.mu3 + cc)), i3);
      o[q] = mul(mul(__ldg(a.g3 + cc), i3),
                 sub(sub(dv[q], __fdiv_rn(__ldg(a.t3a + cc), n)),
                     mul(mh, __fdiv_rn(__ldg(a.t3b + cc), n))));
    }
    store4(a.dmid + i * 4, make_float4(o[0], o[1], o[2], o[3]));
  }
}

template <typename T, int F, int MODE, int MT>
auto tc_kernel() {
  if constexpr (MODE == kFwdP2) return bottleneck_fwd_p2_kernel<T, F, MT>;
  else if constexpr (MODE == kFwd) return bottleneck_fwd_kernel<T, F, MT>;
  else if constexpr (MODE == kStatsA)
    return bottleneck_stats_a_kernel<T, F, MT>;
  else if constexpr (MODE == kStatsBP2)
    return bottleneck_stats_b_p2_kernel<T, F>;
  else if constexpr (MODE == kStatsB) return bottleneck_stats_b_kernel<T, F>;
  else if constexpr (MODE == kP2) return bottleneck_bwd1_p2_kernel<T, F>;
  else if constexpr (MODE == kBwd1) return bottleneck_bwd1_kernel<T, F>;
  else if constexpr (MODE == kBwd2) return bottleneck_bwd2_kernel<T, F>;
  else if constexpr (MODE == kBwd3) return bottleneck_bwd3_kernel<T, F>;
  else if constexpr (MODE == kFoldP2)
    return bottleneck_fold1_p2_kernel<T, F, MT>;
  else if constexpr (MODE == kFold1) return bottleneck_fold1_kernel<T, F, MT>;
  else if constexpr (MODE == kFold2) return bottleneck_fold2_kernel<T, F, MT>;
  else return bottleneck_bwd4_kernel<T, F>;
}

// One tile pass: as many blocks as run at once, at most `limit` (the rows
// of partial sums there is room for), each walking the tiles; the sums'
// order depends only on the shapes and the card. Sets *blocks.
template <typename T, int F, int MODE, int MT = kMT>
cudaError_t run_tiles(const TcArgs& a, long long limit, int device,
                      cudaStream_t st, int* blocks) {
  auto kernel = tc_kernel<T, F, MODE, MT>();
  constexpr int smem = Plan<F, MT>::smem(MODE);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTC,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (a.P + Plan<F, MT>::BM - 1) / Plan<F, MT>::BM;
  *blocks = (int)std::min<long long>({tiles, (long long)per_sm * sms, limit});
  kernel<<<*blocks, kTC, smem, st>>>(a);
  return cudaGetLastError();
}

template <int F>
cudaError_t run_dmid(const TcArgs& a, int device, cudaStream_t st) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long items = (long long)a.P * (F / 4);
  const int blocks =
      (int)std::min<long long>((items + kTC - 1) / kTC, 16LL * sms);
  bottleneck_bwd2_dmid_kernel<F><<<blocks, kTC, 0, st>>>(a);
  return cudaGetLastError();
}

// stats_a's tile: 32 * MT pixels.
constexpr int stats_a_mt(int F) { return F <= 128 ? 4 : 2; }

// fwd's two launches: the p2 pass, then its tile pass.
template <typename T, int F, int MT>
cudaError_t run_fwd(const TcArgs& a, int device, cudaStream_t st) {
  int blocks = 0;
  const cudaError_t err = run_tiles<T, F, kFwdP2, MT>(a, a.P, device, st,
                                                      &blocks);
  if (err != cudaSuccess) return err;
  return run_tiles<T, F, kFwd, MT>(a, a.P, device, st, &blocks);
}

// The folded gradient's steps: fold1 the p2 pass, its tile pass and the sum
// of its rows; fold2 its tile pass and the sum.
template <typename T, int F, int MT>
cudaError_t run_fold(int mode, const TcArgs& a, float* out, int part_rows,
                     int device, cudaStream_t st) {
  int blocks = 0;
  cudaError_t err;
  if (mode == kFold1) {
    err = run_tiles<T, F, kFoldP2, MT>(a, a.P, device, st, &blocks);
    if (err != cudaSuccess) return err;
    // The tile pass reads no x: one instantiation serves both types.
    err = run_tiles<float, F, kFold1, MT>(a, part_rows, device, st, &blocks);
    if (err != cudaSuccess) return err;
    return sum_rows(a.part, out, blocks, 2 * F, st);
  }
  err = run_tiles<T, F, kFold2, MT>(a, part_rows, device, st, &blocks);
  if (err != cudaSuccess) return err;
  return sum_rows(a.part, out, blocks, 10 * F, st);
}

// fwd and the folded steps take 64-pixel tiles or, where those would leave
// SMs idle, 32-pixel ones: run(MT) with MT the 16-pixel mma tiles a warp.
template <int F, class Run>
cudaError_t on_tiles(const TcArgs& a, int device, Run run) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if ((a.P + Plan<F>::BM - 1) / Plan<F>::BM < sms)
    return run(std::integral_constant<int, 1>());
  return run(std::integral_constant<int, kMT>());
}

// The launches of one mode: fwd the p2 pass and its tile pass; stats_a its
// pass and the sum of its rows; stats_b, bwd1 and fold1 the p2 pass, the
// tile pass and the sum of its rows; bwd2 dmid, its tile pass and the sum;
// bwd3 and fold2 their pass and the sum; bwd4 its pass.
template <typename T, int F>
cudaError_t launch(int mode, const TcArgs& a, float* out, int part_rows,
                   int device, cudaStream_t st) {
  int blocks = 0;
  cudaError_t err = cudaSuccess;
  switch (mode) {
    case kFwd:
      return on_tiles<F>(a, device, [&](auto mt) {
        return run_fwd<T, F, decltype(mt)::value>(a, device, st);
      });
    case kFold1:
    case kFold2:
      return on_tiles<F>(a, device, [&](auto mt) {
        return run_fold<T, F, decltype(mt)::value>(mode, a, out, part_rows,
                                                   device, st);
      });
    case kStatsA:
      err = run_tiles<T, F, kStatsA, stats_a_mt(F)>(a, part_rows, device, st,
                                                     &blocks);
      if (err != cudaSuccess) return err;
      return sum_rows(a.part, out, blocks, 2 * F, st);
    case kStatsB:
      err = run_tiles<T, F, kStatsBP2>(a, a.P, device, st, &blocks);
      if (err != cudaSuccess) return err;
      // The tile pass reads no x: one instantiation serves both types.
      err = run_tiles<float, F, kStatsB>(a, part_rows, device, st, &blocks);
      if (err != cudaSuccess) return err;
      return sum_rows(a.part, out, blocks, 2 * F, st);
    case kBwd1:
      err = run_tiles<T, F, kP2>(a, a.P, device, st, &blocks);
      if (err != cudaSuccess) return err;
      // The tile pass reads no x: one instantiation serves both types.
      err = run_tiles<float, F, kBwd1>(a, part_rows, device, st, &blocks);
      if (err != cudaSuccess) return err;
      return sum_rows(a.part, out, blocks, 2 * F, st);
    case kBwd2:
      err = run_dmid<F>(a, device, st);
      if (err != cudaSuccess) return err;
      err = run_tiles<T, F, kBwd2>(a, part_rows, device, st, &blocks);
      if (err != cudaSuccess) return err;
      return sum_rows(a.part, out, blocks, 2 * F, st);
    case kBwd3:
      err = run_tiles<T, F, kBwd3>(a, part_rows, device, st, &blocks);
      if (err != cudaSuccess) return err;
      return sum_rows(a.part, out, blocks, 8 * F, st);
    default:
      return run_tiles<T, F, kBwd4>(a, a.P, device, st, &blocks);
  }
}

template <typename T>
cudaError_t dispatch_f(int mode, const TcArgs& a, float* out, int part_rows,
                       int F, int device, cudaStream_t st) {
  switch (F) {
    case 64:
      return launch<T, 64>(mode, a, out, part_rows, device, st);
    case 128:
      return launch<T, 128>(mode, a, out, part_rows, device, st);
    case 256:
      return launch<T, 256>(mode, a, out, part_rows, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// p[37], null where a mode does not read it: x, gy, w1, w2, w2t, w3t, w1t,
// g1, be1, mu1, i1, g2, be2, mu2, i2, g3, be3, mu3, i3, T3a, T3b, T2a, T2b,
// T1a, T1b, p2, mid, dm3, dmid, dc1, dx, part, out, w3, y, p3, c1 (see
// TcArgs). x, gy, dx, y [B,H,W,4F], p2, mid, dm3, dmid, dc1, p3, c1
// [B,H,W,F]; x, dx and y of
// `dtype` (tr::DType), the rest f32; all contiguous and 16-byte aligned.
// Mode 5 (fwd) takes the folds s1, b1, s2, b2, s3, b3 in the places of g1,
// be1, g2, be2, g3, be3, writes p2 (scratch) and y. Mode 6 (stats_a) writes
// out = [sum c1, sum c1^2] (2F floats). Mode 4 (stats_b) writes
// p2 (scratch) and out = [sum mid, sum mid^2] (2F floats); mode 2 (bwd1)
// writes p2, mid, dm3 and out = [T3a, T3b] (2F); mode 3 (bwd2) reads mid,
// dm3 and writes dmid and out = [T2a, T2b] (2F); mode 0 (bwd3) reads dmid
// and writes dc1 and out = [T1a, T1b] (8F); modes 7 and 8 (the folded
// gradient's steps) take the folds as mode 5 does: mode 7 (fold1) reads x,
// gy, w1, w2, w3t and writes p2, c1, p3, dmid and out = [db3, ds3] (2F),
// mode 8 (fold2) reads x, gy, w1t, w2t, c1, dmid and writes dc1, dx and out =
// [db1, ds1 (4F each), db2, ds2 (F each)]; each through part (part_rows
// rows of out's length; the tile pass runs at most part_rows blocks). Mode
// 1 (bwd4) reads dc1 and writes dx (part_rows unread by modes 1 and 5). F
// is 64, 128 or 256. Returns the cudaError_t of the launches on `stream`:
// three for stats_b, bwd1, bwd2 and fold1, two for fwd, stats_a, bwd3 and
// fold2, one for bwd4 (see launch()).
extern "C" int tr_bottleneck_tc(int mode, const void* const* p, int B, int H,
                                int W, int F, int part_rows, int dtype,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || H < 1 || W < 1 || mode < kBwd3 || mode > kFold2 ||
      (mode != kBwd4 && mode != kFwd && part_rows < 1))
    return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto w = [](const void* q) {
    return static_cast<float*>(const_cast<void*>(q));
  };
  TcArgs a = {};
  a.x = p[0];
  a.gy = f(p[1]);
  a.w1 = f(p[2]);
  a.w2 = f(p[3]);
  a.w2t = f(p[4]);
  a.w3t = f(p[5]);
  a.w1t = f(p[6]);
  a.g1 = f(p[7]);
  a.be1 = f(p[8]);
  a.mu1 = f(p[9]);
  a.i1 = f(p[10]);
  a.g2 = f(p[11]);
  a.be2 = f(p[12]);
  a.mu2 = f(p[13]);
  a.i2 = f(p[14]);
  a.g3 = f(p[15]);
  a.be3 = f(p[16]);
  a.mu3 = f(p[17]);
  a.i3 = f(p[18]);
  a.t3a = f(p[19]);
  a.t3b = f(p[20]);
  a.t2a = f(p[21]);
  a.t2b = f(p[22]);
  a.t1a = f(p[23]);
  a.t1b = f(p[24]);
  a.p2 = w(p[25]);
  a.mid = w(p[26]);
  a.dm3 = w(p[27]);
  a.dmid = w(p[28]);
  a.dc1 = w(p[29]);
  a.dx = const_cast<void*>(p[30]);
  a.part = w(p[31]);
  float* out = w(p[32]);
  a.w3 = f(p[33]);
  a.y = const_cast<void*>(p[34]);
  a.p3 = w(p[35]);
  a.c1 = w(p[36]);
  a.P = B * H * W;
  a.H = H;
  a.W = W;
  a.n = (float)((long long)B * H * W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return dispatch_f<float>(mode, a, out, part_rows, F, device, st);
    case tr::kBFloat16:
      return dispatch_f<__nv_bfloat16>(mode, a, out, part_rows, F, device,
                                       st);
    default:
      return cudaErrorInvalidValue;
  }
}
