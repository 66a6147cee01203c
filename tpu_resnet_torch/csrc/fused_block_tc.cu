// The fused ResNet-v2 basic block on tiles of pixels and the tensor cores:
// its forward with folded batch norm and that forward's gradient, the
// moments of conv1's output in the training forward, and its three backward
// passes with live batch norm.
// Stride 1, equal in/out channels C (16, 32, 64, 128 or 256), 3x3 SAME
// convs; x is NHWC [B,H,W,C] (f32 or bf16), y (the forward's output) of
// x's shape and type, gy f32 of x's shape, w1 and w2 HWIO f32 [3,3,C,C],
// every BN vector f32 [C]; the tensors one launch or pass hands the next
// (c1, r2, dz2, z2hat, dc1, dz1) f32 [B,H,W,C].
//
// Replaces, in tpu_resnet/ops/fused_block.py (every stride-1 identity block
// of the CIFAR ResNet runs them when model.fused_blocks=true: 21 blocks of
// ResNet-50; and the ImageNet ResNet-18/34 blocks of the 56^2x64, 28^2x128
// and 14^2x256 stages, 10 blocks of ResNet-34, where the reference's
// auto_batch_tile finds a plan):
//   mode 0 block_fwd   _block_kernel (:87): y = x + conv(r2, w2), r2 =
//               relu(s2*c1 + b2), c1 = conv(r1, w1), r1 = relu(s1*x + b1)
//               (serving, the eval-mode gradient's forward, and in training
//               with the live moments folded, from the stats' c1);
//   mode 4 block_stats _stats_kernel (:509, through _c1_moments): sum c1,
//               sum c1^2 over (B, H, W), and c1 itself, handed to block_fwd;
// and in _train_bwd_calls:
//   mode 1 block_bwd1  pass1 (:381): T1 = sum dz2, T2 = sum dz2*z2hat with
//               dz2 = convT(gy, w2)*[z2>0]; dw2 = sum r2-patch^T gy; and dz2
//               and z2hat themselves, handed to pass 2;
//   mode 2 block_bwd2  pass2 (:409): dc1 = g2*i2*(dz2 - T1/n - z2hat*(T2/n))
//               from pass 1's dz2 and z2hat; U1 = sum dz1, U2 = sum
//               dz1*z1hat with dz1 = convT(dc1, w1)*[z1>0]; dw1 = sum
//               r1-patch^T dc1; and dz1 itself, handed to pass 3;
//   mode 3 block_bwd3  pass3 (:433): dx = gy + g1*i1*(dz1 - U1/n -
//               z1hat*(U2/n)), from pass 2's dz1, in x's dtype;
// and the folded forward's gradient, _block_bwd_kernel (:252, block_bwd):
//   mode 5 step 1: mode 1's tile pass on the folds: db2 = sum da2, ds2 =
//               sum da2*c1 with da2 = convT(gy, w2)*[a2>0], a2 = s2*c1 + b2;
//               dw2; and dc1 = s2*da2, handed to step 2;
//   mode 6 step 2: mode 2's tile pass on the folds, from step 1's dc1: db1 =
//               sum da1, ds1 = sum da1*x with da1 = convT(dc1, w1)*[a1>0],
//               a1 = s1*x + b1; dw1; and dx = gy + s1*da1 in x's dtype.
// The reference recomputes the chain from x in each call (z1hat = (x-m1)*i1,
// z1 = g1*z1hat + b1, r1 = relu(z1), c1 = conv(r1, w1), z2hat = (c1-m2)*i2,
// z2 = g2*z2hat + b2, r2 = relu(z2); i = 1/sigma): its VMEM keeps nothing
// between calls, and its training forward computes c1 twice, once for the
// moments and once in the folded forward. Here the stats write c1 and the
// training forward reads it, pass 1 writes dz2 and z2hat and pass 2 reads
// them, pass 2 writes dz1 and pass 3 reads it: c1 and each mask [z > 0] are
// computed once, in one pass. The folded forward and the stats run their
// folds as (g, b, m, i) = (s, b, 0, 1): v - 0 and v * 1 are exact, so r1 =
// relu(s1*x + b1) and r2 = relu(s2*c1 + b2) bit for bit, the reference's
// folded chain. The folded gradient is the live passes with the folds as
// (s, b, 0, 1) and no batch-wide correction: T1, T2, U1, U2 are db2, ds2,
// db1, ds1, and dc1 = s2*dz2, dx = gy + s1*dz1 are elementwise on what each
// tile pass holds in registers, so step 1 writes dc1 where pass 1 writes dz2
// and z2hat, step 2 writes dx where pass 2 writes dz1, and neither pass 2's
// dc1 launch nor pass 3 runs. Every elementwise formula rounds as written (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, no FMA contraction), as the plain PyTorch
// version does, so a mask [z > 0] agrees with the plain version's wherever
// the products do.
//
// Bound: each 3x3 product (conv, convT or a weight gradient) is 2*B*H*W*9*C*C
// flops, 0.604 GFLOP at every CIFAR stage at B=128 (29.6 at every ImageNet
// ResNet-34 stage): 9 us at the f32 rate, 3.7 at TF32 over the split's
// three terms, against ~4-8 bytes a pixel-channel
// moved for each: operations. fwd runs two products from x, one from c1; the
// stats one (c1); pass 1 three (c1, the convT of gy, dw2), pass 2 two (the
// convT of dc1, dw1); pass 3 runs none and moves 12 bytes a pixel-channel
// with bf16 x: bytes. The folded gradient runs five: steps 1 and 2 as
// passes 1 and 2.
//
// Design. Tiles of BM consecutive pixels of the [B*H*W] pixel matrix (a tile
// may span images), each row carrying a 9-bit mask of its taps inside the
// image; as many blocks as run at once, each walking the tiles with a fixed
// stride. 256 threads, 8 warps; a warp owns 16*MT pixels x 8*NI channels
// (Plan<C, MT, NI>). The tile plan (4096/C pixels: 256, 128, 64) keeps two by
// two mma tiles a warp (8x1, 4x2, 2x4 warps at C = 16, 32, 64), one code path
// for all widths; at C = 128 and 256 the 8 warps lie across the channels,
// C/64 pairs of mma tiles a warp by two pixel tiles: 32-pixel tiles. The
// forward and the stats take the small plan (one 16-pixel by 8-channel mma
// tile a warp, 1024/C pixels: 64, 32, 16; at C >= 128 16 pixels by C/8
// channels a warp, C/64 mma tiles) where the
// tile plan would fill fewer than 3/4 of the SMs: at B=128 the tile plan
// (512, 256, 128 tiles at 32^2x16, 16^2x32, 8^2x64), at B=16 and B=1 the
// small one (256, 128, 64; 16, 8, 4 blocks): B*H*W*C/1024 blocks, the most
// that one mma tile a warp gives. Both pick the plan by one rule, so the
// stats' c1 is bit for bit the c1 of the forward's own first launch; the
// folded gradient's two steps pick theirs by the same rule (the grad phase's
// B=16 the small plan, the A/B tools' B=128 the tile plan). The live passes
// keep the tile plan.
// Products run on mma.sync m16n8k8 in TF32 with the three-term split
// (mma_tf32x3.cuh): each k-step's three products start from zero and join
// the running f32 sum rounding to nearest. A 3x3 product is an implicit GEMM
// with K = 9C: K streams through a ring of three shared stages by cp.async,
// 16 bytes a thread, A and the weight chunk alike (chunks of min(C, 32)
// channels of one tap; the weights come from L2). A is the tap's shifted rows
// of its source straight from device memory, zero filled outside the image:
// for c1, x with BN1 and its ReLU applied as the fragments are read; for
// conv2 from the stats' c1, c1 with BN2 and its ReLU applied the same way
// (gemm_bn: zero for a tap outside the image, since SAME pads r1 and r2, not
// relu(b)); for conv2 from x, r2; for the convTs gy and dc1. A conv's chunk
// is stored [K][C] as w is, a convT's [C][K], w's rows of the flipped tap,
// so both copy whole rows.
//   fwd    from x (serving, block_apply): launch 1: c1, r2 to a scratch;
//          launch 2: conv2 over r2, y = x + it. r2 goes through device
//          memory (at B=128, 8.4 MB at 32^2x16, in L2): no halo is
//          recomputed. From c1 (training): one launch, conv2 over relu(s2*c1
//          + b2), y = x + it.
//   stats  launch 1: c1 (stored) and the tile's sums of c1 and c1^2 into the
//          block's row; launch 2: the rows' sum.
//   bwd1   launch 1: c1, z2hat (stored), r2 into the tile's own rows in
//          shared memory; dr2 = convT(gy, w2), dz2 (stored) and the tile's
//          sums; then dw2 in the mirrored form, dw2[tap] = sum over the
//          tile's pixels q of r2(q)^T gy(q - d), d the tap's offset: gy's
//          shifted rows through the ring (zero outside the image: the mask
//          applies to gy), the tile's own r2 rows in shared memory, so no r2
//          halo and nothing recomputed. Launch 2: the rows' sum.
//   bwd2   launch 1: dc1, elementwise from dz2 and z2hat; launch 2: dr1 =
//          convT(dc1, w1), dz1 (stored) and the tile's sums; then dw1[tap] =
//          sum over the tile's pixels p of r1(p + d)^T dc1(p), x's shifted
//          rows through the ring (BN1 and ReLU applied as they are read,
//          zero outside the image), dc1's own rows in shared memory. Launch
//          3: the rows' sum.
//   bwd3   one elementwise launch, eight channels a thread, every access 16
//          bytes wide.
//   folded step 1: bwd1's launches, writing dc1 = s2*da2 in place of dz2 and
//          z2hat; step 2: bwd2's second and third launches on step 1's dc1,
//          writing dx = gy + s1*da1 in place of dz1. Four launches a call.
// At C = 128 and 256 the tile passes take no weight gradient (a tap's [C][C]
// in registers would be 64 or 256 floats a thread, and a block's row of
// partial products 0.59 or 2.36 MB): passes 1 and 2 and the folded steps
// write their sums alone, and dw2 and dw1 come from csrc/bottleneck_wgrad.cu
// on wgmma (mode 3, the shifted operand with BN and its ReLU applied as it
// is staged, zero outside the image), from the z2hat (folded: c1) that pass 1
// writes with BN2 as (g2, b2, 0, 1), and from x with BN1, against gy and dc1.
// The weight gradients at C <= 64 keep a tap's [C][C] a warp group, from
// zero over the tile's pixels (K running over the pixels), and add it to the
// block's row;
// at C = 16 a tap's [C][C] is two mma tiles, so four warp groups split the
// pixels and add through a double-buffered exchange in group order, and no
// register array is indexed by the tap. Rings of four or five stages, and
// tiles of 32 pixels at C = 64 or 64 at C = 32, were no faster for pass 2 on
// an H100 (PERF.md).
//
// Sums without atomics: each block walks the tiles with a fixed stride; a
// channel sum adds a warp's rows by shuffles in a fixed pattern and then the
// warps of a column in order, each weight-gradient element belongs to one
// thread, the block writes one row [S1, S2], [T1, T2, dw2] or [U1, U2, dw1]
// (the folded steps [db2, ds2, dw2] and [db1, ds1, dw1]), and the sum kernel
// adds the rows in block order. Two calls agree bit for
// bit.

#include <algorithm>

#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {

using tr::cp_async16;
using tr::cp_async_commit;
using tr::cp_async_wait;
using tr::mma_x3;
using tr::Split;
using tr::split;
using tr::split4;
using tr::to_f32;

constexpr int kTC = 256;     // threads per block
constexpr int kStages = 3;   // the cp.async rings
constexpr int kMaxSmem = 232448;    // a block's shared memory at most
constexpr int kSmemPerSm = 233472;  // an SM's, 1 KB a block the system's
constexpr int kMaxC = 256;   // the widest plan
enum Mode : int {
  kFwd = 0,
  kBwd1 = 1,
  kBwd2 = 2,
  kBwd3 = 3,
  kStats = 4,
  kFold1 = 5,
  kFold2 = 6
};

// Blocks of `smem` bytes of shared memory an SM holds, up to two: the
// min-blocks of a kernel's __launch_bounds__.
constexpr int blocks_per_sm(int smem) {
  return 2 * (smem + 1024) <= kSmemPerSm ? 2 : 1;
}

// Whether the tile passes at width C take the weight gradients themselves
// (tap_wgrad: a tap's [C][C] in registers), at C <= 64; wider, each takes
// one call of csrc/bottleneck_wgrad.cu.
constexpr bool takes_taps(int C) { return C <= 64; }

// The tile plan at width C: MT 16-pixel and NI 8-channel mma tiles a warp
// (two by two to C = 64, two by C/64 wider, so that 8 warps cover C);
// shared memory in bytes.
template <int C_, int MT_ = 2, int NI_ = (C_ <= 64 ? 2 : C_ / 64)>
struct Plan {
  static constexpr int C = C_, MT = MT_, NI = NI_;
  static constexpr bool TAPS = takes_taps(C);
  static constexpr int WN = C / (8 * NI);      // warps across channels
  static constexpr int WM = 8 / WN;            // warps across pixels
  static constexpr int BM = WM * 16 * MT;      // pixels per tile
  static constexpr int BK = C < 32 ? C : 32;   // K per chunk of a 3x3
  static constexpr int CHUNKS = 9 * C / BK;
  static constexpr int AS = BK + 4;    // f32 A chunk row stride, floats
  static constexpr int BS = C + 8;     // conv weight chunk [BK][C + 8]
  static constexpr int BTS = BK + 4;   // convT weight chunk [C][BK + 4]
  static constexpr int DS = C + 8;     // weight gradients' operands, items
  static constexpr int A_BYTES = BM * AS * 4;
  static constexpr int W_BYTES = (BK * BS > C * BTS ? BK * BS : C * BTS) * 4;
  static constexpr int D_BYTES = BM * DS * 4;
  // The rings' stages: a 3x3's chunks, and in the launches with a weight
  // gradient also its shifted rows.
  static constexpr int STAGE1 = A_BYTES + W_BYTES;
  static constexpr int STAGE2 = !TAPS || STAGE1 > D_BYTES ? STAGE1 : D_BYTES;
  static constexpr int RING1 = kStages * STAGE1, RING2 = kStages * STAGE2;
  // A weight gradient: a tap's [C][C] is TILES mma tiles (16 in x 8 out
  // channels); KS groups of warps split the pixels where there are fewer
  // tiles than warps; TPW tiles a warp.
  static constexpr int TILES = (C / 16) * (C / 8);
  static constexpr int KS = TILES >= 8 ? 1 : 8 / TILES;
  static constexpr int TPW = TILES * KS / 8;
  // After the ring: the tile's rows (int2 [BM]: pixel, valid taps), BN1's
  // vectors (float4 [C]: g1, b1, m1, i1), then for the launches with a
  // weight gradient the block's sums [2C], the tile sums' exchange
  // [WM][2][C], the tile's own rows of the other operand and, at C = 16, the
  // weight gradient's exchange [2][KS][C][C].
  template <int RING>
  struct After {
    static constexpr int ROWS = RING, E0 = ROWS + BM * 8, END = E0 + C * 16;
  };
  using L1 = After<RING1>;
  using L2 = After<RING2>;
  static constexpr int SMEM_PROD = L1::END;  // one product a launch: fwd
  // The stats' tile launch: the forward's layout, then the block's sums [2C]
  // and the tile sums' exchange [WM][2][C].
  static constexpr int STATS_SUMS_OFF = L1::END;
  static constexpr int STATS_RED_OFF = STATS_SUMS_OFF + 2 * C * 4;
  static constexpr int SMEM_STATS = STATS_RED_OFF + WM * 2 * C * 4;
  static constexpr int SUMS_OFF = L2::END;
  static constexpr int RED_OFF = SUMS_OFF + 2 * C * 4;
  static constexpr int DBUF_OFF = RED_OFF + WM * 2 * C * 4;
  static constexpr int XCH_OFF = DBUF_OFF + (TAPS ? D_BYTES : 0);
  static constexpr int SMEM_TAPS =  // bwd1's and bwd2's tile launches
      XCH_OFF + (TAPS && KS > 1 ? 2 * KS * C * C * 4 : 0);
  // [T1, T2, dw2] etc.; [T1, T2] without TAPS.
  static constexpr int ROW_LEN = 2 * C + (TAPS ? 9 * C * C : 0);
  static_assert(WN * 8 * NI == C && WM * WN == 8, "warps");
  static_assert(TPW * 8 == TILES * KS && BM % (8 * KS) == 0, "tile");
  static_assert(STAGE1 % 16 == 0 && DBUF_OFF % 16 == 0 &&
                    SMEM_STATS <= kMaxSmem && SMEM_TAPS <= kMaxSmem,
                "smem");
};
static_assert(Plan<16>::SMEM_TAPS == 109952 && Plan<32>::SMEM_TAPS == 93952 &&
                  Plan<64>::SMEM_TAPS == 76800,
              "the plan");
// The wide plans: 32-pixel tiles, 8 warps across the channels; shared
// memory of the forward (SMEM_PROD) and of the stats' and the passes'
// tile launches, under kMaxSmem.
static_assert(Plan<128>::BM == 32 && Plan<128>::WM == 1 &&
                  Plan<128>::SMEM_PROD == 71424 &&
                  Plan<128>::SMEM_STATS == 73472 &&
                  Plan<128>::SMEM_TAPS == 73472 && Plan<128>::ROW_LEN == 256,
              "the plan at 128");
static_assert(Plan<256>::BM == 32 && Plan<256>::WM == 1 &&
                  Plan<256>::SMEM_PROD == 128768 &&
                  Plan<256>::SMEM_STATS == 132864 &&
                  Plan<256>::SMEM_TAPS == 132864 && Plan<256>::ROW_LEN == 512,
              "the plan at 256");
// The forward's small plan: one mma tile a warp; at C >= 128 one 16-pixel
// row of C/64 mma tiles a warp.
template <int C>
using Small = Plan<C, 1, (C <= 64 ? 1 : C / 64)>;
static_assert(Small<128>::BM == 16 && Small<256>::BM == 16 &&
                  Small<128>::SMEM_TAPS == 66432 &&
                  Small<256>::SMEM_TAPS == 125824,
              "the small plans");
// Two blocks an SM for every launch with a tile plan but at C = 256.
static_assert(blocks_per_sm(Plan<16>::SMEM_TAPS) == 2 &&
                  blocks_per_sm(Plan<128>::SMEM_STATS) == 2 &&
                  blocks_per_sm(Small<128>::SMEM_STATS) == 2 &&
                  blocks_per_sm(Plan<256>::SMEM_PROD) == 1 &&
                  blocks_per_sm(Small<256>::SMEM_PROD) == 1,
              "blocks an SM");

struct Args {
  const void* x;     // [P][C] of the dtype
  const float* gy;   // [P][C]
  const float* w1;   // [9][C][C]
  const float* w2;
  // BN gammas, betas, means, 1/sigma [C]; fwd, stats and the folded steps:
  // the folds s1, b1, s2, b2 as g1, b1, g2, b2, and no m, i.
  const float *g1, *b1, *g2, *b2, *m1, *i1, *m2, *i2;
  const float *t1, *t2, *u1, *u2;  // pass 1's and pass 2's sums, [C]
  float* dz2;    // [P][C]: pass 1 writes them, pass 2 reads them
  float* z2hat;
  float* dc1;    // [P][C]: pass 2's first launch writes it, its second reads
                 // (folded: step 1 writes it, step 2 reads it)
  float* dz1;    // [P][C]: pass 2 writes it, pass 3 reads it
  void* dx;      // [P][C] of the dtype (pass 3, folded step 2)
  float* r2;     // [P][C]: fwd's first launch writes it, its second reads it
  void* y;       // [P][C] of the dtype (fwd)
  float* c1;     // [P][C]: the stats write it, fwd reads it where given
  float* part;   // [blocks][row] (stats, passes 1 and 2)
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
// relu(g*((v-m)*i) + b), p = (g, b, m, i): BN1 and its ReLU (a NaN kept).
__device__ __forceinline__ float bn_relu(float v, float4 p) {
  return tr::relu(add(mul(p.x, mul(sub(v, p.z), p.w)), p.y));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __floats2bfloat162_rn(a, b);  // nearest even, as torch's .to()
}
// Eight consecutive values, in 16-byte accesses.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);  // nearest even
  *reinterpret_cast<uint4*>(p) = r;
}

// One k-step's three products from zero, added to acc rounding to nearest
// (the tensor cores' own accumulation truncates).
__device__ __forceinline__ void mma_step(float (&acc)[4],
                                         const uint32_t (&a_big)[4],
                                         const uint32_t (&a_small)[4],
                                         const uint32_t (&b_big)[2],
                                         const uint32_t (&b_small)[2]) {
  float step[4] = {0.f, 0.f, 0.f, 0.f};
  mma_x3(step, a_big, a_small, b_big, b_small);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = __fadd_rn(acc[q], step[q]);
}

// The cp.async ring over `chunks` chunks: issue(c, stage) starts the
// thread's copies of chunk c, body(c, stage) runs once chunk c has landed
// for every thread. Leaves the ring idle (every copy landed, every thread
// past its last read).
template <int STAGE, class Issue, class Body>
__device__ __forceinline__ void ring_loop(int chunks, unsigned char* ring,
                                          Issue issue, Body body) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) issue(s, ring + s * STAGE);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c's copies (this thread's)
    __syncthreads();               // everyone's; stage c-1 is free again
    const int next = c + kStages - 1;
    if (next < chunks) issue(next, ring + (next % kStages) * STAGE);
    cp_async_commit();
    body(c, ring + (c % kStages) * STAGE);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The tile's rows: {pixel, the taps (bit ky*3 + kx) whose shifted pixel
// lies in the image}, {-1, 0} past P.
template <class PL>
__device__ __forceinline__ void tile_rows(const Args& a, long long p0,
                                          int2* rows) {
  for (int r = threadIdx.x; r < PL::BM; r += kTC) {
    const long long p = p0 + r;
    int2 v = make_int2(-1, 0);
    if (p < a.P) {
      const int rem = (int)(p % ((long long)a.H * a.W));
      const int y = rem / a.W, xx = rem - y * a.W;
      int m = 0;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          if (y + ky >= 1 && y + ky <= a.H && xx + kx >= 1 && xx + kx <= a.W)
            m |= 1 << (ky * 3 + kx);
      v = make_int2((int)p, m);
    }
    rows[r] = v;
  }
}

// The thread's copies of the tile's rows of src [P][C] shifted by `tap`,
// channels ci0 .. ci0+K, into rows of DSTR items: zero where the tap leaves
// the image or the row lies past P.
template <class PL, int K, int DSTR, typename U>
__device__ __forceinline__ void issue_shifted(U* dst, const U* src,
                                              const int2* rows, int tap,
                                              int ci0, int W) {
  constexpr int EPS = 16 / (int)sizeof(U);  // items per copy
  constexpr int SEGS = K / EPS;
  constexpr int N = PL::BM * SEGS;
  const int shift = (tap / 3 - 1) * W + tap % 3 - 1;
#pragma unroll
  for (int q = 0; q < (N + kTC - 1) / kTC; ++q) {
    const int idx = threadIdx.x + q * kTC, r = idx / SEGS, s = idx % SEGS;
    if (N % kTC != 0 && idx >= N) break;
    const int2 ri = rows[r];
    const bool ok = (ri.y >> tap) & 1;
    const long long pix = ok ? (long long)ri.x + shift : 0;
    cp_async16(dst + r * DSTR + s * EPS, src + pix * PL::C + ci0 + s * EPS,
               ok);
  }
}

// The thread's copies of chunk c's weights: for a conv the K rows (tap,
// ci) of w [9C][C], stored [K][C + 8]; for a convT (TRANS) B[(tap, i)][o]
// = w[8 - tap][o][i], stored [C][K + 4] from w's rows o of the flipped tap.
template <class PL, bool TRANS>
__device__ __forceinline__ void issue_w(float* bs, const float* w, int c) {
  constexpr int C = PL::C;
  const int k0 = c * PL::BK;
  if constexpr (!TRANS) {
    constexpr int SEGS = C / 4;
    for (int idx = threadIdx.x; idx < PL::BK * SEGS; idx += kTC) {
      const int k = idx / SEGS, s = idx % SEGS;
      cp_async16(bs + k * PL::BS + s * 4, w + (k0 + k) * C + s * 4, true);
    }
  } else {
    constexpr int SEGS = PL::BK / 4;
    const float* src = w + (8 - k0 / C) * C * C + k0 % C;
    for (int idx = threadIdx.x; idx < C * SEGS; idx += kTC) {
      const int o = idx / SEGS, s = idx % SEGS;
      cp_async16(bs + o * PL::BTS + s * 4, src + o * C + s * 4, true);
    }
  }
}

// The thread's place in a tile: its warp's first row, its first column, and
// its lane's (g, t).
template <class PL>
struct Frag {
  int row0, col0, g, t;
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    row0 = (warp / PL::WN) * 16 * PL::MT;
    col0 = (warp % PL::WN) * 8 * PL::NI;
    g = lane >> 2;
    t = lane & 3;
  }
  // Accumulator element q of mma tile (mi, ni): its row in the tile, its
  // column.
  __device__ __forceinline__ int row(int mi, int q) const {
    return row0 + mi * 16 + g + 8 * (q >> 1);
  }
  __device__ __forceinline__ int col(int ni, int q) const {
    return col0 + ni * 8 + 2 * t + (q & 1);
  }
};

template <class PL>
using Acc = float[PL::MT][PL::NI][4];

// acc = the tile's 3x3 product [BM][9C] . [9C][C], the warp's 16*MT pixels
// x 8*NI channels, through a ring of stages of STAGE bytes: issue_a(c,
// stage) copies chunk c of A, frag_a(stage, c, kk, mi, big, small) gives
// the split A fragment of mma tile mi at k-step kk.
template <class PL, bool TRANS, int STAGE, class IssueA, class FragA>
__device__ __forceinline__ void gemm3x3(Acc<PL>& acc, unsigned char* ring,
                                        const float* w, IssueA issue_a,
                                        FragA frag_a) {
  const Frag<PL> f;
#pragma unroll
  for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < PL::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  ring_loop<STAGE>(
      PL::CHUNKS, ring,
      [&](int c, unsigned char* st) {
        issue_a(c, st);
        issue_w<PL, TRANS>(reinterpret_cast<float*>(st + PL::A_BYTES), w, c);
      },
      [&](int c, const unsigned char* st) {
        const float* bs = reinterpret_cast<const float*>(st + PL::A_BYTES);
#pragma unroll
        for (int kk = 0; kk < PL::BK; kk += 8) {
          uint32_t a_big[PL::MT][4], a_small[PL::MT][4];
#pragma unroll
          for (int mi = 0; mi < PL::MT; ++mi)
            frag_a(st, c, kk, mi, a_big[mi], a_small[mi]);
#pragma unroll
          for (int ni = 0; ni < PL::NI; ++ni) {
            const int col = f.col0 + ni * 8 + f.g;
            const int k = kk + f.t;
            const Split b0 = split(TRANS ? bs[col * PL::BTS + k]
                                         : bs[k * PL::BS + col]);
            const Split b1 = split(TRANS ? bs[col * PL::BTS + k + 4]
                                         : bs[(k + 4) * PL::BS + col]);
            const uint32_t b_big[2] = {b0.big, b1.big};
            const uint32_t b_small[2] = {b0.small, b1.small};
#pragma unroll
            for (int mi = 0; mi < PL::MT; ++mi)
              mma_step(acc[mi][ni], a_big[mi], a_small[mi], b_big, b_small);
          }
        }
      });
}

// A 3x3 product over src [P][C] f32: acc = the sum over taps of src shifted
// by the tap (zero outside the image) times w's tap (a conv) or w flipped in
// space, in/out swapped (a convT, TRANS).
template <class PL, bool TRANS, int STAGE>
__device__ __forceinline__ void gemm_f32(Acc<PL>& acc, unsigned char* ring,
                                         const float* src, const float* w,
                                         const int2* rows, int W) {
  const Frag<PL> f;
  gemm3x3<PL, TRANS, STAGE>(
      acc, ring, w,
      [&](int c, unsigned char* st) {
        issue_shifted<PL, PL::BK, PL::AS>(reinterpret_cast<float*>(st), src,
                                          rows, c * PL::BK / PL::C,
                                          c * PL::BK % PL::C, W);
      },
      [&](const unsigned char* st, int, int kk, int mi, uint32_t(&big)[4],
          uint32_t(&small)[4]) {
        // A rows r, r+8 at columns k, k+4.
        constexpr int AS = PL::AS;
        const int r = f.row0 + mi * 16 + f.g, k = kk + f.t;
        const float* as = reinterpret_cast<const float*>(st);
        const float v[4] = {as[r * AS + k], as[(r + 8) * AS + k],
                            as[r * AS + k + 4], as[(r + 8) * AS + k + 4]};
        split4(v, big, small);
      });
}

// acc = conv3x3(relu(g*((v-m)*i) + b), w) over the tile, v the rows of src
// [P][C] with e[c] = (g, b, m, i): BN and its ReLU applied as the fragments
// are read, zero for a tap outside the image. c1 from x (w1, BN1 or the
// folds s1, b1), and conv2 from c1 (w2, the folds s2, b2).
template <typename S, class PL, int STAGE>
__device__ __forceinline__ void gemm_bn(Acc<PL>& acc, unsigned char* ring,
                                        const S* src, const float* w,
                                        const int2* rows, const float4* e,
                                        int W) {
  constexpr int XS = PL::BK + 16 / (int)sizeof(S);  // src chunk row, items
  constexpr int C = PL::C;
  const Frag<PL> f;
  int vm[PL::MT][2];  // the valid taps of the thread's fragment rows
#pragma unroll
  for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) vm[mi][h] = rows[f.row(mi, 2 * h)].y;
  gemm3x3<PL, false, STAGE>(
      acc, ring, w,
      [&](int c, unsigned char* st) {
        issue_shifted<PL, PL::BK, XS>(reinterpret_cast<S*>(st), src, rows,
                                      c * PL::BK / C, c * PL::BK % C, W);
      },
      [&](const unsigned char* st, int c, int kk, int mi, uint32_t(&big)[4],
          uint32_t(&small)[4]) {
        const S* as = reinterpret_cast<const S*>(st);
        const int tap = c * PL::BK / C, k = kk + f.t;
        const int r = f.row0 + mi * 16 + f.g;
        const float4 pa = e[c * PL::BK % C + k];
        const float4 pb = e[c * PL::BK % C + k + 4];
        const bool v0 = (vm[mi][0] >> tap) & 1, v1 = (vm[mi][1] >> tap) & 1;
        const float v[4] = {
            v0 ? bn_relu(to_f32(as[r * XS + k]), pa) : 0.f,
            v1 ? bn_relu(to_f32(as[(r + 8) * XS + k]), pa) : 0.f,
            v0 ? bn_relu(to_f32(as[r * XS + k + 4]), pb) : 0.f,
            v1 ? bn_relu(to_f32(as[(r + 8) * XS + k + 4]), pb) : 0.f};
        split4(v, big, small);
      });
}

// A BN's vectors into e: (g, b, m, i), or with m and i null a fold (s, b,
// 0, 1).
__device__ __forceinline__ void load_bn(float4* e, const float* g,
                                        const float* b, const float* m,
                                        const float* i, int C) {
  for (int c = threadIdx.x; c < C; c += kTC)
    e[c] = m ? make_float4(g[c], b[c], m[c], i[c])
             : make_float4(g[c], b[c], 0.f, 1.f);
}

// Adds a tile's channel sums, sa and sb over the thread's column pairs, to
// sums[col] and sums[C + col]: a warp's 32 rows by shuffles (lanes of one t
// hold one column pair) in a fixed pattern, then the WM warps of a column
// in order.
template <class PL>
__device__ __forceinline__ void add_tile_sums(float (&sa)[PL::NI][2],
                                              float (&sb)[PL::NI][2],
                                              float* red, float* sums) {
  constexpr int C = PL::C;
  const Frag<PL> f;
  const int wm = (threadIdx.x >> 5) / PL::WN;
#pragma unroll
  for (int ni = 0; ni < PL::NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float u = sa[ni][j], v = sb[ni][j];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        u += __shfl_xor_sync(0xffffffffu, u, o);
        v += __shfl_xor_sync(0xffffffffu, v, o);
      }
      if (f.g == 0) {
        const int col = f.col(ni, j);
        red[(wm * 2) * C + col] = u;
        red[(wm * 2 + 1) * C + col] = v;
      }
    }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * C; k += kTC) {
    const int which = k / C, col = k % C;
    float s = 0.f;
    for (int m = 0; m < PL::WM; ++m) s += red[(m * 2 + which) * C + col];
    sums[k] += s;
  }
  __syncthreads();
}

// A weight gradient's share of one tile: dw[tap] (+)= sum over the tile's
// pixels p of A(p)^T B(p), tap by tap, K running over the pixels. The
// ring's stage holds one operand's rows for the tap (issue(tap, stage));
// a_frag(stage, tap, ra, rb, m0, v) gives A at pixels ra, rb and input
// channels m0, m0+8 ({(ra, m0), (ra, m0+8), (rb, m0), (rb, m0+8)}), and
// b_val(stage, r, co) B at pixel r, output channel co. dw is the block's
// [9][C][C]: stored where `first` (the block's first tile), else added to.
// Leaves the ring idle.
template <class PL, class Issue, class AFrag, class BVal>
__device__ __forceinline__ void tap_wgrad(unsigned char* ring, float* xch,
                                          float* dw, bool first, Issue issue,
                                          AFrag a_frag, BVal b_val) {
  constexpr int C = PL::C;
  constexpr int KP = PL::BM / PL::KS;  // pixels of a warp group
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  // The warp's pixel group and its first mma tile (16 in x 8 out).
  const int kg = warp / (8 / PL::KS);
  const int tw = (warp % (8 / PL::KS)) * PL::TPW;
  const int m0 = tw / (C / 8) * 16 + g, n0 = tw % (C / 8);
  auto dw_add = [&](int k, float v) { dw[k] = first ? v : add(dw[k], v); };
  // At C = 16: a tap's four pixel groups from the exchange, in group order
  // (the tap's buffer is rewritten two taps later, past a barrier).
  auto dw_sum = [&](int tap) {
    const float* b = xch + (tap & 1) * PL::KS * C * C;
    for (int k = tid; k < C * C; k += kTC) {
      float s = b[k];
#pragma unroll
      for (int m = 1; m < PL::KS; ++m) s = add(s, b[m * C * C + k]);
      dw_add(tap * C * C + k, s);
    }
  };
  ring_loop<PL::STAGE2>(9, ring, issue, [&](int tap, const unsigned char* st) {
    if (PL::KS > 1 && tap > 0) dw_sum(tap - 1);
    float w[PL::TPW][4];
#pragma unroll
    for (int j = 0; j < PL::TPW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[j][q] = 0.f;
#pragma unroll 4
    for (int kk = kg * KP; kk < (kg + 1) * KP; kk += 8) {
      // A^T: rows m0, m0+8 (input channels) at pixels kk+t, kk+t+4.
      const int ra = kk + t, rb = ra + 4;
      float v[4];
      a_frag(st, tap, ra, rb, m0, v);
      uint32_t a_big[4], a_small[4];
      split4(v, a_big, a_small);
#pragma unroll
      for (int j = 0; j < PL::TPW; ++j) {
        const int col = (n0 + j) * 8 + g;
        const Split b0 = split(b_val(st, ra, col));
        const Split b1 = split(b_val(st, rb, col));
        const uint32_t b_big[2] = {b0.big, b1.big};
        const uint32_t b_small[2] = {b0.small, b1.small};
        mma_step(w[j], a_big, a_small, b_big, b_small);
      }
    }
#pragma unroll
    for (int j = 0; j < PL::TPW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = m0 + 8 * (q >> 1);
        const int co = (n0 + j) * 8 + 2 * t + (q & 1);
        if constexpr (PL::KS > 1)  // to the exchange, summed next tap
          xch[((tap & 1) * PL::KS + kg) * C * C + ci * C + co] = w[j][q];
        else
          dw_add(tap * C * C + ci * C + co, w[j][q]);
      }
  });
  if constexpr (PL::KS > 1) dw_sum(8);
}

// The forward's launch 1: r2 = relu(s2*c1 + b2) to device memory, c1 =
// conv3x3(relu(s1*x + b1), w1). Two blocks an SM where the shared memory
// holds them (all but C = 256).
template <typename T, class PL>
__global__ void __launch_bounds__(kTC, blocks_per_sm(PL::SMEM_PROD))
    block_fwd_r2_kernel(const Args a) {
  constexpr int C = PL::C;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* rows = reinterpret_cast<int2*>(smem + PL::L1::ROWS);
  float4* e0 = reinterpret_cast<float4*>(smem + PL::L1::E0);
  const Frag<PL> f;
  load_bn(e0, a.g1, a.b1, nullptr, nullptr, C);
  const int tiles = (a.P + PL::BM - 1) / PL::BM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * PL::BM;
    tile_rows<PL>(a, p0, rows);
    __syncthreads();
    Acc<PL> acc;
    gemm_bn<T, PL, PL::STAGE1>(acc, smem, static_cast<const T*>(a.x), a.w1,
                               rows, e0, a.W);
#pragma unroll
    for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = p0 + f.row(mi, 2 * h);
        if (p >= a.P) continue;
#pragma unroll
        for (int ni = 0; ni < PL::NI; ++ni) {
          const int col = f.col(ni, 0);
          float r[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            r[j] = tr::relu(add(mul(__ldg(a.g2 + col + j),
                                    acc[mi][ni][2 * h + j]),
                                __ldg(a.b2 + col + j)));
          store2(a.r2 + p * C + col, r[0], r[1]);
        }
      }
  }
}

// The forward's last launch: y = x + conv3x3(r2, w2) in x's dtype, r2 from
// the first launch's scratch or, FROM_C1, relu(s2*c1 + b2) from the stats'
// c1 as the fragments are read. Two blocks an SM where the shared memory
// holds them (all but C = 256).
template <typename T, class PL, bool FROM_C1>
__global__ void __launch_bounds__(kTC, blocks_per_sm(PL::SMEM_PROD))
    block_fwd_kernel(const Args a) {
  constexpr int C = PL::C;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* rows = reinterpret_cast<int2*>(smem + PL::L1::ROWS);
  float4* e2 = reinterpret_cast<float4*>(smem + PL::L1::E0);
  const Frag<PL> f;
  const T* xg = static_cast<const T*>(a.x);
  T* yg = static_cast<T*>(a.y);
  if constexpr (FROM_C1) load_bn(e2, a.g2, a.b2, nullptr, nullptr, C);
  const int tiles = (a.P + PL::BM - 1) / PL::BM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * PL::BM;
    tile_rows<PL>(a, p0, rows);
    __syncthreads();
    Acc<PL> acc;
    if constexpr (FROM_C1)
      gemm_bn<float, PL, PL::STAGE1>(acc, smem, a.c1, a.w2, rows, e2, a.W);
    else
      gemm_f32<PL, false, PL::STAGE1>(acc, smem, a.r2, a.w2, rows, a.W);
#pragma unroll
    for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = p0 + f.row(mi, 2 * h);
        if (p >= a.P) continue;
#pragma unroll
        for (int ni = 0; ni < PL::NI; ++ni) {
          const int col = f.col(ni, 0);
          const float2 xv = load2(xg + p * C + col);
          store2(yg + p * C + col, add(xv.x, acc[mi][ni][2 * h]),
                 add(xv.y, acc[mi][ni][2 * h + 1]));
        }
      }
  }
}

// The stats' tile launch: c1 = conv3x3(relu(s1*x + b1), w1) to device
// memory, and each block's row [sum c1, sum c1^2]. Two blocks an SM where
// the shared memory holds them (all but C = 256).
template <typename T, class PL>
__global__ void __launch_bounds__(kTC, blocks_per_sm(PL::SMEM_STATS))
    block_stats_kernel(const Args a) {
  constexpr int C = PL::C;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* rows = reinterpret_cast<int2*>(smem + PL::L1::ROWS);
  float4* e0 = reinterpret_cast<float4*>(smem + PL::L1::E0);
  float* sums = reinterpret_cast<float*>(smem + PL::STATS_SUMS_OFF);
  float* red = reinterpret_cast<float*>(smem + PL::STATS_RED_OFF);
  const Frag<PL> f;
  load_bn(e0, a.g1, a.b1, nullptr, nullptr, C);
  for (int k = threadIdx.x; k < 2 * C; k += kTC) sums[k] = 0.f;
  const int tiles = (a.P + PL::BM - 1) / PL::BM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * PL::BM;
    tile_rows<PL>(a, p0, rows);
    __syncthreads();
    Acc<PL> acc;
    gemm_bn<T, PL, PL::STAGE1>(acc, smem, static_cast<const T*>(a.x), a.w1,
                               rows, e0, a.W);
    float sa[PL::NI][2] = {}, sb[PL::NI][2] = {};
#pragma unroll
    for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = p0 + f.row(mi, 2 * h);
        if (p >= a.P) continue;
#pragma unroll
        for (int ni = 0; ni < PL::NI; ++ni) {
          const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          sa[ni][0] += v0;
          sa[ni][1] += v1;
          sb[ni][0] = fmaf(v0, v0, sb[ni][0]);
          sb[ni][1] = fmaf(v1, v1, sb[ni][1]);
          store2(a.c1 + p * C + f.col(ni, 0), v0, v1);
        }
      }
    add_tile_sums<PL>(sa, sb, red, sums);
  }
  float* row = a.part + (long long)blockIdx.x * 2 * C;
  for (int k = threadIdx.x; k < 2 * C; k += kTC) row[k] = sums[k];
}

// Pass 1's tile launch: z2hat and dz2 to device memory, and each block's
// row [T1, T2, dw2] of partial sums; FOLDED (the folded gradient's step 1,
// BN2 the folds (s2, b2, 0, 1), no m2, i2): z2hat = c1, and dc1 = s2*dz2 to
// device memory in their place. Without TAPS (C >= 128) the row is [T1,
// T2] and z2hat is stored in both modes (folded: c1), dw2's operand. Two
// blocks an SM at C <= 32 (128 registers, a few bytes of spills) ran 1%
// faster on an H100 than one block without spills (PERF.md); at C = 64 the
// tile plan's 128 tiles fill the SMs once; at C = 256 the shared memory
// holds one block an SM.
template <typename T, class PL, bool FOLDED>
__global__ void __launch_bounds__(
    kTC, PL::C == 64 && PL::MT == 2 ? 1 : blocks_per_sm(PL::SMEM_TAPS))
    block_bwd1_kernel(const Args a) {
  constexpr int C = PL::C;
  constexpr int DS = PL::DS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  int2* rows = reinterpret_cast<int2*>(smem + PL::L2::ROWS);
  float4* e0 = reinterpret_cast<float4*>(smem + PL::L2::E0);
  float* sums = reinterpret_cast<float*>(smem + PL::SUMS_OFF);
  float* red = reinterpret_cast<float*>(smem + PL::RED_OFF);
  float* rbuf = reinterpret_cast<float*>(smem + PL::DBUF_OFF);  // r2 rows
  float* xch = reinterpret_cast<float*>(smem + PL::XCH_OFF);
  const Frag<PL> f;
  float* row = a.part + (long long)blockIdx.x * PL::ROW_LEN;
  load_bn(e0, a.g1, a.b1, a.m1, a.i1, C);
  for (int k = threadIdx.x; k < 2 * C; k += kTC) sums[k] = 0.f;

  bool first = true;
  const int tiles = (a.P + PL::BM - 1) / PL::BM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * PL::BM;
    tile_rows<PL>(a, p0, rows);
    __syncthreads();
    // c1; z2hat = (c1-m2)*i2 (folded: c1), kept in registers and stored; r2
    // = relu(g2*z2hat + b2) into the tile's own rows (zero past P).
    Acc<PL> acc, zh;
    gemm_bn<T, PL, PL::STAGE2>(acc, ring, static_cast<const T*>(a.x), a.w1,
                               rows, e0, a.W);
#pragma unroll
    for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < PL::NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = f.row(mi, q), col = f.col(ni, q);
          const float z = FOLDED ? acc[mi][ni][q]
                                 : mul(sub(acc[mi][ni][q], __ldg(a.m2 + col)),
                                       __ldg(a.i2 + col));
          zh[mi][ni][q] = z;
          if constexpr (PL::TAPS)
            rbuf[r * DS + col] =
                p0 + r < a.P
                    ? tr::relu(add(mul(__ldg(a.g2 + col), z), __ldg(a.b2 + col)))
                    : 0.f;
        }
    // dr2 = convT(gy, w2).
    gemm_f32<PL, true, PL::STAGE2>(acc, ring, a.gy, a.w2, rows, a.W);
    // dz2 = dr2*[z2 > 0]; z2hat and dz2 stored (folded: dc1 = s2*dz2);
    // their sums.
    float sa[PL::NI][2] = {}, sb[PL::NI][2] = {};
#pragma unroll
    for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = p0 + f.row(mi, 2 * h);
        const bool ok = p < a.P;
#pragma unroll
        for (int ni = 0; ni < PL::NI; ++ni) {
          const int col = f.col(ni, 0);
          float d[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float z = zh[mi][ni][2 * h + j];
            d[j] = ok && add(mul(__ldg(a.g2 + col + j), z),
                             __ldg(a.b2 + col + j)) > 0.f
                       ? acc[mi][ni][2 * h + j]
                       : 0.f;
            sa[ni][j] += d[j];
            sb[ni][j] = fmaf(d[j], z, sb[ni][j]);
          }
          if (!ok) continue;
          if constexpr (FOLDED)
            store2(a.dc1 + p * C + col, mul(d[0], __ldg(a.g2 + col)),
                   mul(d[1], __ldg(a.g2 + col + 1)));
          else
            store2(a.dz2 + p * C + col, d[0], d[1]);
          if constexpr (!FOLDED || !PL::TAPS)
            store2(a.z2hat + p * C + col, zh[mi][ni][2 * h],
                   zh[mi][ni][2 * h + 1]);
        }
      }
    add_tile_sums<PL>(sa, sb, red, sums);

    // dw2[tap] += sum over the tile's pixels q of r2(q)^T gy(q - d): gy's
    // rows shifted by the mirrored tap 8 - tap through the ring.
    if constexpr (PL::TAPS) tap_wgrad<PL>(
        ring, xch, row + 2 * C, first,
        [&](int tap, unsigned char* st) {
          issue_shifted<PL, C, DS>(reinterpret_cast<float*>(st), a.gy, rows,
                                   8 - tap, 0, a.W);
        },
        [&](const unsigned char*, int, int ra, int rb, int m0,
            float(&v)[4]) {
          v[0] = rbuf[ra * DS + m0];
          v[1] = rbuf[ra * DS + m0 + 8];
          v[2] = rbuf[rb * DS + m0];
          v[3] = rbuf[rb * DS + m0 + 8];
        },
        [&](const unsigned char* st, int r, int co) {
          return reinterpret_cast<const float*>(st)[r * DS + co];
        });
    first = false;
  }
  for (int k = threadIdx.x; k < 2 * C; k += kTC) row[k] = sums[k];
}

// Pass 2's launch 1: dc1 = (g2*i2)*((dz2 - T1/n) - z2hat*(T2/n)), from pass
// 1's dz2 and z2hat, eight channels a thread.
__global__ void __launch_bounds__(kTC)
    block_bwd2_dc1_kernel(const Args a, int C) {
  __shared__ float4 coef[kMaxC];  // g2*i2, T1/n, T2/n
  for (int c = threadIdx.x; c < C; c += kTC)
    coef[c] = make_float4(mul(a.g2[c], a.i2[c]), __fdiv_rn(a.t1[c], a.n),
                          __fdiv_rn(a.t2[c], a.n), 0.f);
  __syncthreads();
  const long long groups = (long long)a.P * C / 8;
  for (long long i = (long long)blockIdx.x * kTC + threadIdx.x; i < groups;
       i += (long long)gridDim.x * kTC) {
    const long long e = i * 8;
    const int c0 = (int)(e % C);
    float dv[8], zv[8], o[8];
    load8(a.dz2 + e, dv);
    load8(a.z2hat + e, zv);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 k = coef[c0 + q];
      o[q] = mul(k.x, sub(sub(dv[q], k.y), mul(zv[q], k.z)));
    }
    store8(a.dc1 + e, o);
  }
}

// Pass 2's launch 2: dz1 to device memory, and each block's row [U1, U2,
// dw1] of partial sums; FOLDED (the folded gradient's step 2, BN1 the folds
// (s1, b1, 0, 1)): dx = gy + s1*dz1 in x's dtype in dz1's place.
template <typename T, class PL, bool FOLDED>
__global__ void __launch_bounds__(kTC) block_bwd2_kernel(const Args a) {
  constexpr int C = PL::C;
  constexpr int DS = PL::DS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  int2* rows = reinterpret_cast<int2*>(smem + PL::L2::ROWS);
  float4* e0 = reinterpret_cast<float4*>(smem + PL::L2::E0);
  float* sums = reinterpret_cast<float*>(smem + PL::SUMS_OFF);
  float* red = reinterpret_cast<float*>(smem + PL::RED_OFF);
  float* dbuf = reinterpret_cast<float*>(smem + PL::DBUF_OFF);  // dc1 rows
  float* xch = reinterpret_cast<float*>(smem + PL::XCH_OFF);
  const Frag<PL> f;
  const T* xg = static_cast<const T*>(a.x);
  float* row = a.part + (long long)blockIdx.x * PL::ROW_LEN;
  load_bn(e0, a.g1, a.b1, a.m1, a.i1, C);
  for (int k = threadIdx.x; k < 2 * C; k += kTC) sums[k] = 0.f;

  bool first = true;
  const int tiles = (a.P + PL::BM - 1) / PL::BM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * PL::BM;
    tile_rows<PL>(a, p0, rows);
    __syncthreads();
    // The tile's own dc1 rows (the centre tap), dw1's second operand.
    if constexpr (PL::TAPS) {
      issue_shifted<PL, C, DS>(dbuf, a.dc1, rows, 4, 0, a.W);
      cp_async_commit();
    }

    // dr1 = convT(dc1, w1).
    Acc<PL> acc;
    gemm_f32<PL, true, PL::STAGE2>(acc, ring, a.dc1, a.w1, rows, a.W);
    // dz1 = dr1*[z1 > 0], stored (folded: dx = gy + s1*dz1); the sums of
    // dz1 and dz1*z1hat.
    float sa[PL::NI][2] = {}, sb[PL::NI][2] = {};
#pragma unroll
    for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = p0 + f.row(mi, 2 * h);
        const bool ok = p < a.P;
#pragma unroll
        for (int ni = 0; ni < PL::NI; ++ni) {
          const int col = f.col(ni, 0);
          const float2 xv =
              ok ? load2(xg + p * C + col) : make_float2(0.f, 0.f);
          float d[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float4 bn = e0[col + j];
            const float zh = mul(sub(j ? xv.y : xv.x, bn.z), bn.w);
            d[j] = ok && add(mul(bn.x, zh), bn.y) > 0.f
                       ? acc[mi][ni][2 * h + j]
                       : 0.f;
            sa[ni][j] += d[j];
            sb[ni][j] = fmaf(d[j], zh, sb[ni][j]);
          }
          if (!ok) continue;
          if constexpr (FOLDED) {
            const float2 gv = load2(a.gy + p * C + col);
            store2(static_cast<T*>(a.dx) + p * C + col,
                   add(gv.x, mul(d[0], e0[col].x)),
                   add(gv.y, mul(d[1], e0[col + 1].x)));
          } else {
            store2(a.dz1 + p * C + col, d[0], d[1]);
          }
        }
      }
    add_tile_sums<PL>(sa, sb, red, sums);

    // dw1[tap] += sum over the tile's pixels p of r1(p + d)^T dc1(p): x's
    // rows shifted by the tap through the ring, BN1 and ReLU applied as
    // they are read, zero where the tap leaves the image.
    if constexpr (PL::TAPS) tap_wgrad<PL>(
        ring, xch, row + 2 * C, first,
        [&](int tap, unsigned char* st) {
          issue_shifted<PL, C, DS>(reinterpret_cast<T*>(st), xg, rows, tap, 0,
                                   a.W);
        },
        [&](const unsigned char* st, int tap, int ra, int rb, int m0,
            float(&v)[4]) {
          const T* xs = reinterpret_cast<const T*>(st);
          const float4 pa = e0[m0], pb = e0[m0 + 8];
          const bool va = (rows[ra].y >> tap) & 1;
          const bool vb = (rows[rb].y >> tap) & 1;
          v[0] = va ? bn_relu(to_f32(xs[ra * DS + m0]), pa) : 0.f;
          v[1] = va ? bn_relu(to_f32(xs[ra * DS + m0 + 8]), pb) : 0.f;
          v[2] = vb ? bn_relu(to_f32(xs[rb * DS + m0]), pa) : 0.f;
          v[3] = vb ? bn_relu(to_f32(xs[rb * DS + m0 + 8]), pb) : 0.f;
        },
        [&](const unsigned char*, int r, int co) { return dbuf[r * DS + co]; });
    first = false;
  }
  for (int k = threadIdx.x; k < 2 * C; k += kTC) row[k] = sums[k];
}

// out[k] = sum over rows, in row order, of part[row][k]: the last launch of
// the stats and of passes 1 and 2, each under its own name.
__device__ __forceinline__ void sum_rows(const float* __restrict__ part,
                                         float* __restrict__ out, int rows,
                                         int L) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= L) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(long long)r * L + k];
  out[k] = s;
}
__global__ void block_stats_sum_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int rows,
                                       int L) {
  sum_rows(part, out, rows, L);
}
__global__ void block_bwd1_sum_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int rows,
                                      int L) {
  sum_rows(part, out, rows, L);
}
__global__ void block_bwd2_sum_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int rows,
                                      int L) {
  sum_rows(part, out, rows, L);
}
__global__ void block_bwd_sum_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int rows,
                                     int L) {
  sum_rows(part, out, rows, L);
}

// Pass 3: dx = gy + (g1*i1)*((dz1 - U1/n) - z1hat*(U2/n)), z1hat =
// (x-m1)*i1, eight channels a thread.
template <typename T>
__global__ void __launch_bounds__(kTC) block_bwd3_kernel(const Args a, int C) {
  __shared__ float4 coef[kMaxC];  // g1*i1, U1/n, U2/n, m1
  __shared__ float inv[kMaxC];    // i1
  for (int c = threadIdx.x; c < C; c += kTC) {
    coef[c] = make_float4(mul(a.g1[c], a.i1[c]), __fdiv_rn(a.u1[c], a.n),
                          __fdiv_rn(a.u2[c], a.n), a.m1[c]);
    inv[c] = a.i1[c];
  }
  __syncthreads();
  const long long groups = (long long)a.P * C / 8;
  for (long long i = (long long)blockIdx.x * kTC + threadIdx.x; i < groups;
       i += (long long)gridDim.x * kTC) {
    const long long e = i * 8;
    const int c0 = (int)(e % C);
    float xv[8], gv[8], dv[8], o[8];
    load8(static_cast<const T*>(a.x) + e, xv);
    load8(a.gy + e, gv);
    load8(a.dz1 + e, dv);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 k = coef[c0 + q];
      const float zh = mul(sub(xv[q], k.w), inv[c0 + q]);
      o[q] = add(gv[q], mul(k.x, sub(sub(dv[q], k.y), mul(zh, k.z))));
    }
    store8(static_cast<T*>(a.dx) + e, o);
  }
}

cudaError_t sm_count(int device, int* sms) {
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// One tile launch: as many blocks as run at once, at most `limit`. Sets
// *blocks.
template <class K>
cudaError_t run_tiles(K kernel, int smem, const Args& a, int bm,
                      long long limit, int device, cudaStream_t st,
                      int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTC,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (a.P + bm - 1) / bm;
  *blocks = (int)std::min<long long>({tiles, (long long)per_sm * sms, limit});
  kernel<<<*blocks, kTC, smem, st>>>(a);
  return cudaGetLastError();
}

// An elementwise launch over the [P][C] items, eight a thread.
template <class K>
cudaError_t run_elementwise(K kernel, const Args& a, int C, int device,
                            cudaStream_t st) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const long long groups = (long long)a.P * C / 8;
  const int blocks =
      (int)std::min<long long>((groups + kTC - 1) / kTC, 16LL * sms);
  kernel<<<blocks, kTC, 0, st>>>(a, C);
  return cudaGetLastError();
}

// The forward on plan PL: from c1 one launch, else two.
template <typename T, class PL>
cudaError_t run_fwd_plan(const Args& a, int device, cudaStream_t st) {
  int blocks = 0;
  if (a.c1)
    return run_tiles(block_fwd_kernel<T, PL, true>, PL::SMEM_PROD, a, PL::BM,
                     a.P, device, st, &blocks);
  const cudaError_t err =
      run_tiles(block_fwd_r2_kernel<T, PL>, PL::SMEM_PROD, a, PL::BM, a.P,
                device, st, &blocks);
  if (err != cudaSuccess) return err;
  return run_tiles(block_fwd_kernel<T, PL, false>, PL::SMEM_PROD, a, PL::BM,
                   a.P, device, st, &blocks);
}

// The stats on plan PL: the tile launch, at most part_rows blocks, then the
// sum of its rows into out.
template <typename T, class PL>
cudaError_t run_stats_plan(const Args& a, float* out, int part_rows,
                           int device, cudaStream_t st) {
  int blocks = 0;
  const cudaError_t err =
      run_tiles(block_stats_kernel<T, PL>, PL::SMEM_STATS, a, PL::BM,
                part_rows, device, st, &blocks);
  if (err != cudaSuccess) return err;
  block_stats_sum_kernel<<<1, 2 * PL::C, 0, st>>>(a.part, out, blocks,
                                                  2 * PL::C);
  return cudaGetLastError();
}

// The forward and the stats take the tile plan where its grid fills 3/4 of
// the SMs, else the small plan: one rule, so that the stats' c1 is the c1
// of the forward's own first launch.
template <int C, class Run>
cudaError_t on_plan(const Args& a, int device, Run run) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const long long tiles = (a.P + Plan<C>::BM - 1) / Plan<C>::BM;
  return 4 * tiles >= 3LL * sms ? run(Plan<C>()) : run(Small<C>());
}

// Pass 1's two launches, or pass 2's three; the rows of partial sums are at
// most part_rows.
template <typename T, int C>
cudaError_t run_pass(int mode, const Args& a, float* out, int part_rows,
                     int device, cudaStream_t st) {
  using PL = Plan<C>;
  int blocks = 0;
  cudaError_t err;
  if (mode == kBwd1) {
    err = run_tiles(block_bwd1_kernel<T, PL, false>, PL::SMEM_TAPS, a,
                    PL::BM, part_rows, device, st, &blocks);
    if (err != cudaSuccess) return err;
    block_bwd1_sum_kernel<<<(PL::ROW_LEN + 255) / 256, 256, 0, st>>>(
        a.part, out, blocks, PL::ROW_LEN);
    return cudaGetLastError();
  }
  err = run_elementwise(block_bwd2_dc1_kernel, a, C, device, st);
  if (err != cudaSuccess) return err;
  err = run_tiles(block_bwd2_kernel<T, PL, false>, PL::SMEM_TAPS, a, PL::BM,
                  part_rows, device, st, &blocks);
  if (err != cudaSuccess) return err;
  block_bwd2_sum_kernel<<<(PL::ROW_LEN + 255) / 256, 256, 0, st>>>(
      a.part, out, blocks, PL::ROW_LEN);
  return cudaGetLastError();
}

// A folded step on plan PL: its tile launch (pass 1's or pass 2's, at most
// part_rows blocks), then the sum of its rows into out.
template <typename T, class PL>
cudaError_t run_folded_plan(int mode, const Args& a, float* out,
                            int part_rows, int device, cudaStream_t st) {
  int blocks = 0;
  const cudaError_t err =
      mode == kFold1
          ? run_tiles(block_bwd1_kernel<T, PL, true>, PL::SMEM_TAPS, a,
                      PL::BM, part_rows, device, st, &blocks)
          : run_tiles(block_bwd2_kernel<T, PL, true>, PL::SMEM_TAPS, a,
                      PL::BM, part_rows, device, st, &blocks);
  if (err != cudaSuccess) return err;
  block_bwd_sum_kernel<<<(PL::ROW_LEN + 255) / 256, 256, 0, st>>>(
      a.part, out, blocks, PL::ROW_LEN);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t dispatch_c(int mode, const Args& a, float* out, int part_rows,
                       int device, cudaStream_t st) {
  switch (mode) {
    case kFwd:
      return on_plan<C>(a, device, [&](auto plan) {
        return run_fwd_plan<T, decltype(plan)>(a, device, st);
      });
    case kStats:
      return on_plan<C>(a, device, [&](auto plan) {
        return run_stats_plan<T, decltype(plan)>(a, out, part_rows, device,
                                                 st);
      });
    case kBwd3:
      return run_elementwise(block_bwd3_kernel<T>, a, C, device, st);
    case kFold1:
    case kFold2:
      return on_plan<C>(a, device, [&](auto plan) {
        return run_folded_plan<T, decltype(plan)>(mode, a, out, part_rows,
                                                  device, st);
      });
    default:
      return run_pass<T, C>(mode, a, out, part_rows, device, st);
  }
}

template <typename T>
cudaError_t dispatch(int mode, const Args& a, float* out, int part_rows,
                     int C, int device, cudaStream_t st) {
  switch (C) {
    case 16:
      return dispatch_c<T, 16>(mode, a, out, part_rows, device, st);
    case 32:
      return dispatch_c<T, 32>(mode, a, out, part_rows, device, st);
    case 64:
      return dispatch_c<T, 64>(mode, a, out, part_rows, device, st);
    case 128:
      return dispatch_c<T, 128>(mode, a, out, part_rows, device, st);
    case 256:
      return dispatch_c<T, 256>(mode, a, out, part_rows, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// p[26], null where a mode does not read it: x, gy, w1, w2, g1, b1, g2, b2,
// m1, i1, m2, i2, T1, T2, U1, U2, dz2, z2hat, dc1, dz1, dx, r2, y, c1, part,
// then out at p[25] (see Args). x, gy and the [B,H,W,C] tensors handed on,
// dx and y; x, dx and y of `dtype` (tr::DType), the rest f32; all
// contiguous and 16-byte aligned; C is 16, 32, 64, 128 or 256. At C >= 128
// passes 1 and 2 and the folded steps write no weight gradient: out is [S1,
// S2] (2C) and the rows of part are 2C long; mode 1 and mode 5 write z2hat
// (mode 5: c1), dw2's operand for csrc/bottleneck_wgrad.cu.
//   Mode 0 (fwd) reads x, the weights and the folds s1, b1, s2, b2 in the
//   g1, b1, g2, b2 places, writes y: with c1 given (the stats' c1 of the
//   same x, w1, s1, b1) it reads c1, w2, s2, b2: one launch; else it writes
//   r2 (scratch): two launches.
//   Mode 4 (stats) reads x, w1 and the folds s1, b1 in the g1, b1 places,
//   writes c1 and out = [sum c1, sum c1^2 (C each)]: two launches.
//   Mode 1 (pass 1) reads x, gy, the weights and the eight vectors, writes
//   dz2, z2hat and out = [T1, T2 (C each), dw2 (9C^2, HWIO)]: two launches.
//   Mode 2 (pass 2) reads x, w1, dz2, z2hat, g1, b1, m1, i1, g2, i2, T1,
//   T2, writes dc1 (scratch), dz1 and out = [U1, U2, dw1]: three launches.
//   The stats and passes 1 and 2 write out through part (part_rows rows of
//   out's length: the tile launch runs at most part_rows blocks).
//   Mode 3 (pass 3) reads x, gy, dz1, g1, m1, i1, U1, U2 and writes dx: one
//   launch.
//   Modes 5 and 6, the folded gradient's steps, read the folds s1, b1, s2,
//   b2 in the g1, b1, g2, b2 places and no m, i, T or U. Mode 5 reads x, gy,
//   w1, w2, writes dc1 and out = [db2, ds2 (C each), dw2 (9C^2)]; mode 6
//   reads x, gy, w1, dc1, writes dx and out = [db1, ds1, dw1]; two launches
//   each, through part as the stats'.
// Returns the cudaError_t of the launches on `stream`.
extern "C" int tr_block_tc(int mode, const void* const* p, int B, int H,
                           int W, int C, int part_rows, int dtype, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long P = (long long)B * H * W;
  const bool sums = mode != kFwd && mode != kBwd3;
  if (B < 0 || H < 1 || W < 1 ||
      (C != 16 && C != 32 && C != 64 && C != 128 && C != 256) ||
      mode < kFwd || mode > kFold2 || P * C >= (1LL << 31) ||
      (sums && P > 0 && part_rows < 1))
    return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto w = [](const void* q) {
    return static_cast<float*>(const_cast<void*>(q));
  };
  Args a = {};
  a.x = p[0];
  a.gy = f(p[1]);
  a.w1 = f(p[2]);
  a.w2 = f(p[3]);
  a.g1 = f(p[4]);
  a.b1 = f(p[5]);
  a.g2 = f(p[6]);
  a.b2 = f(p[7]);
  a.m1 = f(p[8]);
  a.i1 = f(p[9]);
  a.m2 = f(p[10]);
  a.i2 = f(p[11]);
  a.t1 = f(p[12]);
  a.t2 = f(p[13]);
  a.u1 = f(p[14]);
  a.u2 = f(p[15]);
  a.dz2 = w(p[16]);
  a.z2hat = w(p[17]);
  a.dc1 = w(p[18]);
  a.dz1 = w(p[19]);
  a.dx = const_cast<void*>(p[20]);
  a.r2 = w(p[21]);
  a.y = const_cast<void*>(p[22]);
  a.c1 = w(p[23]);
  a.part = w(p[24]);
  float* out = w(p[25]);
  a.P = (int)P;
  a.H = H;
  a.W = W;
  a.n = (float)P;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 0)
    return sums ? cudaMemsetAsync(out, 0,
                                  (2 * C + (mode != kStats && takes_taps(C)
                                                ? 9 * C * C
                                                : 0)) *
                                      sizeof(float),
                                  st)
                : cudaSuccess;
  switch (dtype) {
    case tr::kFloat32:
      return dispatch<float>(mode, a, out, part_rows, C, device, st);
    case tr::kBFloat16:
      return dispatch<__nv_bfloat16>(mode, a, out, part_rows, C, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}
