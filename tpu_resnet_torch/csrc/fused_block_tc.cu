// The fused ResNet-v2 basic block's backward passes 2 and 3 with live batch
// norm, on tiles of pixels and the tensor cores. Stride 1, equal in/out
// channels C (16, 32 or 64), 3x3 SAME convs; x is NHWC [B,H,W,C] (f32 or
// bf16), gy f32 of x's shape, w1 and w2 HWIO f32 [3,3,C,C], every BN vector
// f32 [C]; dc1 and dz1 f32 [B,H,W,C].
//
// Replaces, in tpu_resnet/ops/fused_block.py's _train_bwd_calls (every
// stride-1 identity block of the CIFAR ResNet runs them in training when
// model.fused_blocks=true: 21 blocks of ResNet-50):
//   block_bwd2  pass2 (:409): dc1 = g2*i2*(dz2 - T1/n - z2hat*(T2/n)) with
//               dz2 = convT(gy, w2)*[z2>0]; U1 = sum dz1, U2 = sum
//               dz1*z1hat with dz1 = convT(dc1, w1)*[z1>0]; dw1 = sum
//               r1-patch^T dc1; and dz1 itself, handed to pass 3;
//   block_bwd3  pass3 (:433): dx = gy + g1*i1*(dz1 - U1/n - z1hat*(U2/n)),
//               from pass 2's dz1, in x's dtype.
// The reference recomputes the chain from x in each pass (z1hat = (x-m1)*i1,
// z1 = g1*z1hat + b1, r1 = relu(z1), c1 = conv(r1, w1), z2hat = (c1-m2)*i2,
// z2 = g2*z2hat + b2; i = 1/sigma): its VMEM keeps nothing between calls.
// Here pass 2 writes dz1 and pass 3 reads it, so pass 3 runs no product.
// Every elementwise formula rounds as written (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, no FMA contraction), as the plain PyTorch version
// does, so a mask [z > 0] agrees with the plain version's wherever the
// products do.
//
// Bound: pass 2 runs four 3x3 products (c1, convT of gy, convT of dc1, dw1),
// 2*B*H*W*9*C*C flops each, 0.604 GFLOP at every CIFAR stage at B=128: 36 us
// a call at the f32 rate, 15 at TF32 over the split's three terms, against
// ~20 bytes a pixel-channel moved: operations. Pass 3 moves 12 bytes a
// pixel-channel with bf16 x and does a few flops: bytes.
//
// Design of pass 2: three launches.
//   1  dc1: over tiles of BM = 4096/C consecutive pixels of the [B*H*W]
//      pixel matrix (256, 128, 64: a tile may span images), c1 as an
//      implicit GEMM with K = 9C (A: the tap's shifted x rows, BN1 and ReLU
//      applied as the fragments are read, zero for a tap outside the image:
//      SAME pads r1 itself, not relu(b1)); z2hat; dr2 = convT(gy, w2) as an
//      implicit GEMM over w2 flipped in space, in/out swapped (gy's shifted
//      rows straight from device memory, zero fill); dz2, dc1 to device
//      memory.
//   2  dz1, U, dw1: dr1 = convT(dc1, w1) the same way (at 32x32x16 the
//      whole dc1 plane is 8.4 MB and sits in L2); dz1 to device memory; the
//      tile's sums of dz1 and dz1*z1hat; then dw1 = sum over the tile's
//      pixels of r1(p + tap)^T dc1(p), tap by tap, K running over the
//      pixels, with dc1's own rows kept in shared memory.
//   3  the partial rows added in block order.
// Products run on mma.sync m16n8k8 in TF32 with the three-term split
// (mma_tf32x3.cuh): each k-step's three products start from zero and join
// the running f32 sum rounding to nearest. 256 threads, 8 warps of 32
// pixels x 16 channels (WM x WN = 8x1, 4x2, 2x4 at C = 16, 32, 64), so
// every width keeps two 16-pixel and two 8-channel mma tiles a warp. K
// streams through a ring of three shared stages by cp.async, 16 bytes a
// thread, A and the weight chunk alike (chunks of min(C, 32) channels of one
// tap); the weights come from L2. A conv's chunk is stored [K][C] as w is,
// a convT's [C][K], w's rows of the flipped tap, so both copy whole rows.
// dw1's tap products keep a [C][C] tile a warp group from zero over the
// tile's pixels (at C = 16, four groups split the pixels, added in group
// order) and add it to the block's row. Rings of four or five stages, and
// tiles of 32 pixels at C = 64 or 64 at C = 32, were no faster on an H100
// (PERF.md, PR 12).
//
// Sums without atomics: each block walks the tiles with a fixed stride; a
// channel sum adds a warp's rows by shuffles in a fixed pattern and then
// the warps of a column in order, each dw1 element belongs to one thread,
// the block writes one row [U1, U2, dw1], and block_bwd2_sum_kernel adds
// the rows in block order. Two calls agree bit for bit.
//
// Pass 3 is one elementwise launch, eight channels a thread, every access
// of x, gy, dz1 and dx 16 bytes wide.

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
constexpr int kMaxSmem = 232448;
enum Mode : int { kBwd2 = 2, kBwd3 = 3 };

// The tile plan at width C, shared memory in bytes.
template <int C>
struct Plan {
  static constexpr int MT = 2;                 // 16-pixel mma tiles a warp
  static constexpr int WN = C / 16;            // warps across channels
  static constexpr int WM = 8 / WN;            // warps across pixels
  static constexpr int BM = WM * 16 * MT;      // pixels per tile
  static constexpr int BK = C < 32 ? C : 32;   // K per chunk of a 3x3
  static constexpr int CHUNKS = 9 * C / BK;
  static constexpr int AS = BK + 4;    // f32 A chunk row stride, floats
  static constexpr int BS = C + 8;     // conv weight chunk [BK][C + 8]
  static constexpr int BTS = BK + 4;   // convT weight chunk [C][BK + 4]
  static constexpr int DS = C + 8;     // dw1's operands [BM][C + 8], items
  static constexpr int A_BYTES = BM * AS * 4;
  static constexpr int W_BYTES = (BK * BS > C * BTS ? BK * BS : C * BTS) * 4;
  static constexpr int D_BYTES = BM * DS * 4;
  // The rings' stages: launch 1's hold a 3x3's chunks, launch 2's also
  // dw1's x rows.
  static constexpr int STAGE1 = A_BYTES + W_BYTES;
  static constexpr int STAGE2 = STAGE1 > D_BYTES ? STAGE1 : D_BYTES;
  static constexpr int RING1 = kStages * STAGE1, RING2 = kStages * STAGE2;
  // dw1: a tap's [C][C] is TILES mma tiles (16 in x 8 out channels); KS
  // groups of warps split the pixels where there are fewer tiles than
  // warps; TPW tiles a warp.
  static constexpr int TILES = (C / 16) * (C / 8);
  static constexpr int KS = TILES >= 8 ? 1 : 8 / TILES;
  static constexpr int TPW = TILES * KS / 8;
  // After the ring: the tile's rows (int2 [BM]: pixel, valid taps), BN1's
  // vectors (float4 [C]: g1, b1, m1, i1), then for launch 2 the block's
  // sums [2C], the tile sums' exchange [WM][2][C], dc1's own rows and, at
  // C = 16, dw1's exchange [2][KS][C][C].
  template <int RING>
  struct After {
    static constexpr int ROWS = RING, E0 = ROWS + BM * 8, END = E0 + C * 16;
  };
  using L1 = After<RING1>;
  using L2 = After<RING2>;
  static constexpr int SMEM_DC1 = L1::END;
  static constexpr int SUMS_OFF = L2::END;
  static constexpr int RED_OFF = SUMS_OFF + 2 * C * 4;
  static constexpr int DBUF_OFF = RED_OFF + WM * 2 * C * 4;
  static constexpr int XCH_OFF = DBUF_OFF + D_BYTES;
  static constexpr int SMEM_DZ1 = XCH_OFF + (KS > 1 ? 2 * KS * C * C * 4 : 0);
  static constexpr int ROW_LEN = 2 * C + 9 * C * C;  // [U1, U2, dw1]
  static_assert(TPW * 8 == TILES * KS && BM % (8 * KS) == 0, "tile");
  static_assert(STAGE1 % 16 == 0 && DBUF_OFF % 16 == 0 &&
                    SMEM_DC1 <= kMaxSmem && SMEM_DZ1 <= kMaxSmem,
                "smem");
};
static_assert(Plan<16>::SMEM_DZ1 == 109952 && Plan<32>::SMEM_DZ1 == 93952 &&
                  Plan<64>::SMEM_DZ1 == 76800,
              "the plan");

struct Args {
  const void* x;     // [P][C] of the dtype
  const float* gy;   // [P][C]
  const float* w1;   // [9][C][C]
  const float* w2;
  const float *g1, *b1, *g2, *b2, *m1, *i1, *m2, *i2;  // [C]
  const float *t1, *t2, *u1, *u2;  // pass 1's and pass 2's sums, [C]
  float* dc1;   // [P][C]: launch 1 writes it, launch 2 reads it
  float* dz1;   // [P][C]: pass 2 writes it, pass 3 reads it
  void* dx;     // [P][C] of the dtype (pass 3)
  float* part;  // [blocks][ROW_LEN] (pass 2)
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
// relu(g*((v-m)*i) + b), p = (g, b, m, i): BN1 and its ReLU.
__device__ __forceinline__ float bn_relu(float v, float4 p) {
  return fmaxf(add(mul(p.x, mul(sub(v, p.z), p.w)), p.y), 0.f);
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
template <int C>
__device__ __forceinline__ void tile_rows(const Args& a, long long p0,
                                          int2* rows) {
  for (int r = threadIdx.x; r < Plan<C>::BM; r += kTC) {
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
template <int C, int K, int DSTR, typename U>
__device__ __forceinline__ void issue_shifted(U* dst, const U* src,
                                              const int2* rows, int tap,
                                              int ci0, int W) {
  constexpr int EPS = 16 / (int)sizeof(U);  // items per copy
  constexpr int SEGS = K / EPS;
  constexpr int N = Plan<C>::BM * SEGS;
  const int shift = (tap / 3 - 1) * W + tap % 3 - 1;
#pragma unroll
  for (int q = 0; q < (N + kTC - 1) / kTC; ++q) {
    const int idx = threadIdx.x + q * kTC, r = idx / SEGS, s = idx % SEGS;
    if (N % kTC != 0 && idx >= N) break;
    const int2 ri = rows[r];
    const bool ok = (ri.y >> tap) & 1;
    const long long pix = ok ? (long long)ri.x + shift : 0;
    cp_async16(dst + r * DSTR + s * EPS, src + pix * C + ci0 + s * EPS, ok);
  }
}

// The thread's copies of chunk c's weights: for a conv the K rows (tap,
// ci) of w [9C][C], stored [K][C + 8]; for a convT (TRANS) B[(tap, i)][o]
// = w[8 - tap][o][i], stored [C][K + 4] from w's rows o of the flipped tap.
template <int C, bool TRANS>
__device__ __forceinline__ void issue_w(float* bs, const float* w, int c) {
  using PL = Plan<C>;
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

// acc = the tile's 3x3 product [BM][9C] . [9C][C], the warp's 16*MT pixels
// x 16 channels, through a ring of stages of STAGE bytes: issue_a(c,
// stage) copies chunk c of A, frag_a(stage, c, kk, mi, big, small) gives
// the split A fragment of mma tile mi at k-step kk.
template <int C, bool TRANS, int STAGE, class IssueA, class FragA>
__device__ __forceinline__ void gemm3x3(float (&acc)[Plan<C>::MT][2][4],
                                        unsigned char* ring, const float* w,
                                        IssueA issue_a, FragA frag_a) {
  using PL = Plan<C>;
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) % PL::WN;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  ring_loop<STAGE>(
      PL::CHUNKS, ring,
      [&](int c, unsigned char* st) {
        issue_a(c, st);
        issue_w<C, TRANS>(reinterpret_cast<float*>(st + PL::A_BYTES), w, c);
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
          for (int ni = 0; ni < 2; ++ni) {
            const int col = wn * 16 + ni * 8 + g;
            const Split b0 = split(TRANS ? bs[col * PL::BTS + kk + t]
                                         : bs[(kk + t) * PL::BS + col]);
            const Split b1 = split(TRANS ? bs[col * PL::BTS + kk + t + 4]
                                         : bs[(kk + t + 4) * PL::BS + col]);
            const uint32_t b_big[2] = {b0.big, b1.big};
            const uint32_t b_small[2] = {b0.small, b1.small};
#pragma unroll
            for (int mi = 0; mi < PL::MT; ++mi)
              mma_step(acc[mi][ni], a_big[mi], a_small[mi], b_big, b_small);
          }
        }
      });
}

// A fragments from an f32 chunk [BM][AS]: rows r, r+8 at columns k, k+4.
template <int C>
__device__ __forceinline__ void frag_f32(const unsigned char* st, int kk,
                                         int mi, uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  using PL = Plan<C>;
  constexpr int AS = PL::AS;
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) / PL::WN;
  const int r = (wm * PL::MT + mi) * 16 + (lane >> 2), k = kk + (lane & 3);
  const float* as = reinterpret_cast<const float*>(st);
  const float v[4] = {as[r * AS + k], as[(r + 8) * AS + k],
                      as[r * AS + k + 4], as[(r + 8) * AS + k + 4]};
  split4(v, big, small);
}

// Launch 1 of pass 2: dc1 to device memory, tile by tile. Two blocks an SM
// at C <= 32 (left free, ptxas takes 164-168 registers a thread and one
// block an SM: 6% slower at C = 16 and 32 on an H100; at C = 64, 128 tiles
// fill the SMs once and the cap made it 3% slower).
template <typename T, int C>
__global__ void __launch_bounds__(kTC, C == 64 ? 1 : 2)
    block_bwd2_dc1_kernel(const Args a) {
  using PL = Plan<C>;
  constexpr int XS = PL::BK + 16 / (int)sizeof(T);  // x chunk row, items
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  int2* rows = reinterpret_cast<int2*>(smem + PL::L1::ROWS);
  float4* e0 = reinterpret_cast<float4*>(smem + PL::L1::E0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / PL::WN, wn = warp % PL::WN;
  const int g = lane >> 2, t = lane & 3, row0 = wm * 16 * PL::MT;
  const T* xg = static_cast<const T*>(a.x);
  const float n = a.n;
  for (int c = tid; c < C; c += kTC)
    e0[c] = make_float4(a.g1[c], a.b1[c], a.m1[c], a.i1[c]);

  const int tiles = (a.P + PL::BM - 1) / PL::BM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * PL::BM;
    tile_rows<C>(a, p0, rows);
    __syncthreads();
    int vm[PL::MT][2];  // the valid taps of the thread's fragment rows
#pragma unroll
    for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        vm[mi][h] = rows[row0 + mi * 16 + g + 8 * h].y;

    // c1 = conv3x3(r1, w1), r1 = relu(g1*((x-m1)*i1) + b1) from x.
    float acc[PL::MT][2][4], zh[PL::MT][2][4];
    gemm3x3<C, false, PL::STAGE1>(
        acc, ring, a.w1,
        [&](int c, unsigned char* st) {
          issue_shifted<C, PL::BK, XS>(reinterpret_cast<T*>(st), xg, rows,
                                       c * PL::BK / C, c * PL::BK % C, a.W);
        },
        [&](const unsigned char* st, int c, int kk, int mi,
            uint32_t(&big)[4], uint32_t(&small)[4]) {
          const T* as = reinterpret_cast<const T*>(st);
          const int tap = c * PL::BK / C, k = kk + t;
          const int r = row0 + mi * 16 + g;
          const float4 pa = e0[c * PL::BK % C + k];
          const float4 pb = e0[c * PL::BK % C + k + 4];
          const bool v0 = (vm[mi][0] >> tap) & 1, v1 = (vm[mi][1] >> tap) & 1;
          const float v[4] = {
              v0 ? bn_relu(to_f32(as[r * XS + k]), pa) : 0.f,
              v1 ? bn_relu(to_f32(as[(r + 8) * XS + k]), pa) : 0.f,
              v0 ? bn_relu(to_f32(as[r * XS + k + 4]), pb) : 0.f,
              v1 ? bn_relu(to_f32(as[(r + 8) * XS + k + 4]), pb) : 0.f};
          split4(v, big, small);
        });
    // z2hat = (c1-m2)*i2, kept in registers.
#pragma unroll
    for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = wn * 16 + ni * 8 + 2 * t + (q & 1);
          zh[mi][ni][q] =
              mul(sub(acc[mi][ni][q], __ldg(a.m2 + col)), __ldg(a.i2 + col));
        }
    // dr2 = convT(gy, w2).
    gemm3x3<C, true, PL::STAGE1>(
        acc, ring, a.w2,
        [&](int c, unsigned char* st) {
          issue_shifted<C, PL::BK, PL::AS>(reinterpret_cast<float*>(st), a.gy,
                                           rows, c * PL::BK / C,
                                           c * PL::BK % C, a.W);
        },
        [&](const unsigned char* st, int, int kk, int mi, uint32_t(&big)[4],
            uint32_t(&small)[4]) { frag_f32<C>(st, kk, mi, big, small); });
    // dz2 = dr2*[z2 > 0], then dc1.
#pragma unroll
    for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = p0 + row0 + mi * 16 + g + 8 * h;
        if (p >= a.P) continue;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int col = wn * 16 + ni * 8 + 2 * t;
          float d[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int cc = col + j;
            const float g2 = __ldg(a.g2 + cc), z = zh[mi][ni][2 * h + j];
            const float dz = add(mul(g2, z), __ldg(a.b2 + cc)) > 0.f
                                 ? acc[mi][ni][2 * h + j]
                                 : 0.f;
            d[j] = mul(mul(g2, __ldg(a.i2 + cc)),
                       sub(sub(dz, __fdiv_rn(__ldg(a.t1 + cc), n)),
                           mul(z, __fdiv_rn(__ldg(a.t2 + cc), n))));
          }
          store2(a.dc1 + p * C + col, d[0], d[1]);
        }
      }
  }
}

// Adds a tile's channel sums, sa and sb over the thread's column pairs, to
// sums[col] and sums[C + col]: a warp's 32 rows by shuffles (lanes of one t
// hold one column pair) in a fixed pattern, then the WM warps of a column
// in order.
template <int C>
__device__ __forceinline__ void add_tile_sums(float (&sa)[2][2],
                                              float (&sb)[2][2], float* red,
                                              float* sums) {
  using PL = Plan<C>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / PL::WN, wn = warp % PL::WN;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float u = sa[ni][j], v = sb[ni][j];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        u += __shfl_xor_sync(0xffffffffu, u, o);
        v += __shfl_xor_sync(0xffffffffu, v, o);
      }
      if (g == 0) {
        const int col = wn * 16 + ni * 8 + 2 * t + j;
        red[(wm * 2) * C + col] = u;
        red[(wm * 2 + 1) * C + col] = v;
      }
    }
  __syncthreads();
  for (int k = tid; k < 2 * C; k += kTC) {
    const int which = k / C, col = k % C;
    float s = 0.f;
    for (int m = 0; m < PL::WM; ++m) s += red[(m * 2 + which) * C + col];
    sums[k] += s;
  }
  __syncthreads();
}

// Launch 2 of pass 2: dz1 to device memory, and each block's row [U1, U2,
// dw1] of partial sums.
template <typename T, int C>
__global__ void __launch_bounds__(kTC) block_bwd2_kernel(const Args a) {
  using PL = Plan<C>;
  constexpr int DS = PL::DS;
  constexpr int KP = PL::BM / PL::KS;  // pixels of a dw1 warp group
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  int2* rows = reinterpret_cast<int2*>(smem + PL::L2::ROWS);
  float4* e0 = reinterpret_cast<float4*>(smem + PL::L2::E0);
  float* sums = reinterpret_cast<float*>(smem + PL::SUMS_OFF);
  float* red = reinterpret_cast<float*>(smem + PL::RED_OFF);
  float* dbuf = reinterpret_cast<float*>(smem + PL::DBUF_OFF);
  float* xch = reinterpret_cast<float*>(smem + PL::XCH_OFF);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / PL::WN, wn = warp % PL::WN;
  const int g = lane >> 2, t = lane & 3, row0 = wm * 16 * PL::MT;
  // dw1: the warp's pixel group and its first mma tile (16 in x 8 out).
  const int kg = warp / (8 / PL::KS);
  const int tw = (warp % (8 / PL::KS)) * PL::TPW;
  const int m0 = tw / (C / 8) * 16 + g, n0 = tw % (C / 8);
  const T* xg = static_cast<const T*>(a.x);
  float* row = a.part + (long long)blockIdx.x * PL::ROW_LEN;
  for (int c = tid; c < C; c += kTC)
    e0[c] = make_float4(a.g1[c], a.b1[c], a.m1[c], a.i1[c]);
  for (int k = tid; k < 2 * C; k += kTC) sums[k] = 0.f;

  bool first = true;  // the block's first tile stores its dw1, later add
  // Element k of the row's dw1 (tap, ci, co), owned by this thread.
  auto dw_add = [&](int k, float v) {
    float* o = row + 2 * C + k;
    *o = first ? v : add(*o, v);
  };
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
  const int tiles = (a.P + PL::BM - 1) / PL::BM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * PL::BM;
    tile_rows<C>(a, p0, rows);
    __syncthreads();
    // The tile's own dc1 rows (the centre tap), dw1's second operand.
    issue_shifted<C, C, DS>(dbuf, a.dc1, rows, 4, 0, a.W);
    cp_async_commit();

    // dr1 = convT(dc1, w1).
    float acc[PL::MT][2][4];
    gemm3x3<C, true, PL::STAGE2>(
        acc, ring, a.w1,
        [&](int c, unsigned char* st) {
          issue_shifted<C, PL::BK, PL::AS>(reinterpret_cast<float*>(st),
                                           a.dc1, rows, c * PL::BK / C,
                                           c * PL::BK % C, a.W);
        },
        [&](const unsigned char* st, int, int kk, int mi, uint32_t(&big)[4],
            uint32_t(&small)[4]) { frag_f32<C>(st, kk, mi, big, small); });
    // dz1 = dr1*[z1 > 0], stored; the sums of dz1 and dz1*z1hat.
    float sa[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, sb[2][2] = {{0.f, 0.f},
                                                           {0.f, 0.f}};
#pragma unroll
    for (int mi = 0; mi < PL::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = p0 + row0 + mi * 16 + g + 8 * h;
        const bool ok = p < a.P;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int col = wn * 16 + ni * 8 + 2 * t;
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
          if (ok) store2(a.dz1 + p * C + col, d[0], d[1]);
        }
      }
    add_tile_sums<C>(sa, sb, red, sums);

    // dw1[tap] += sum over the tile's pixels p of r1(p + tap)^T dc1(p).
    ring_loop<PL::STAGE2>(
        9, ring,
        [&](int tap, unsigned char* st) {
          issue_shifted<C, C, DS>(reinterpret_cast<T*>(st), xg, rows, tap, 0,
                                  a.W);
        },
        [&](int tap, const unsigned char* st) {
          if (PL::KS > 1 && tap > 0) dw_sum(tap - 1);
          const T* xs = reinterpret_cast<const T*>(st);
          float w[PL::TPW][4];
#pragma unroll
          for (int j = 0; j < PL::TPW; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) w[j][q] = 0.f;
          const float4 pa = e0[m0], pb = e0[m0 + 8];
#pragma unroll 4
          for (int kk = kg * KP; kk < (kg + 1) * KP; kk += 8) {
            // A = r1^T: rows m0, m0+8 (input channels) at pixels kk+t,
            // kk+t+4; zero where the tap leaves the image.
            const int ra = kk + t, rb = ra + 4;
            const bool va = (rows[ra].y >> tap) & 1;
            const bool vb = (rows[rb].y >> tap) & 1;
            const float v[4] = {
                va ? bn_relu(to_f32(xs[ra * DS + m0]), pa) : 0.f,
                va ? bn_relu(to_f32(xs[ra * DS + m0 + 8]), pb) : 0.f,
                vb ? bn_relu(to_f32(xs[rb * DS + m0]), pa) : 0.f,
                vb ? bn_relu(to_f32(xs[rb * DS + m0 + 8]), pb) : 0.f};
            uint32_t a_big[4], a_small[4];
            split4(v, a_big, a_small);
#pragma unroll
            for (int j = 0; j < PL::TPW; ++j) {
              const int col = (n0 + j) * 8 + g;
              const Split b0 = split(dbuf[ra * DS + col]);
              const Split b1 = split(dbuf[rb * DS + col]);
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
                xch[((tap & 1) * PL::KS + kg) * C * C + ci * C + co] =
                    w[j][q];
              else
                dw_add(tap * C * C + ci * C + co, w[j][q]);
            }
        });
    if constexpr (PL::KS > 1) dw_sum(8);
    first = false;
  }
  for (int k = tid; k < 2 * C; k += kTC) row[k] = sums[k];
}

// Launch 3 of pass 2: out[k] = sum over rows, in row order, of part[row][k].
__global__ void block_bwd2_sum_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int rows,
                                      int L) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= L) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(long long)r * L + k];
  out[k] = s;
}

// Pass 3: dx = gy + (g1*i1)*((dz1 - U1/n) - z1hat*(U2/n)), z1hat =
// (x-m1)*i1, eight channels a thread.
template <typename T>
__global__ void __launch_bounds__(kTC) block_bwd3_kernel(const Args a, int C) {
  __shared__ float4 coef[64];  // g1*i1, U1/n, U2/n, m1
  __shared__ float inv[64];    // i1
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
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
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

// Pass 2's three launches; the rows of partial sums are at most part_rows.
template <typename T, int C>
cudaError_t run_bwd2(const Args& a, float* out, int part_rows, int device,
                     cudaStream_t st) {
  using PL = Plan<C>;
  int blocks = 0;
  cudaError_t err =
      run_tiles(block_bwd2_dc1_kernel<T, C>, PL::SMEM_DC1, a, PL::BM, a.P,
                device, st, &blocks);
  if (err != cudaSuccess) return err;
  err = run_tiles(block_bwd2_kernel<T, C>, PL::SMEM_DZ1, a, PL::BM, part_rows,
                  device, st, &blocks);
  if (err != cudaSuccess) return err;
  block_bwd2_sum_kernel<<<(PL::ROW_LEN + 255) / 256, 256, 0, st>>>(
      a.part, out, blocks, PL::ROW_LEN);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bwd3(const Args& a, int C, int device, cudaStream_t st) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long groups = (long long)a.P * C / 8;
  const int blocks =
      (int)std::min<long long>((groups + kTC - 1) / kTC, 16LL * sms);
  block_bwd3_kernel<T><<<blocks, kTC, 0, st>>>(a, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int mode, const Args& a, float* out, int part_rows,
                     int C, int device, cudaStream_t st) {
  if (mode == kBwd3) return run_bwd3<T>(a, C, device, st);
  switch (C) {
    case 16:
      return run_bwd2<T, 16>(a, out, part_rows, device, st);
    case 32:
      return run_bwd2<T, 32>(a, out, part_rows, device, st);
    default:
      return run_bwd2<T, 64>(a, out, part_rows, device, st);
  }
}

}  // namespace

// p[20], null where a mode does not read it: x, gy, w1, w2, g1, b1, g2, b2,
// m1, i1, m2, i2, T1, T2, U1, U2, dc1, dz1, dx, part, then out at p[20]
// (see Args). x, gy, dc1, dz1, dx [B,H,W,C], x and dx of `dtype`
// (tr::DType), the rest f32; all contiguous and 16-byte aligned; C is 16, 32
// or 64. Mode 2 (pass 2) reads x, gy, the weights, the eight vectors and
// T1, T2, writes dc1 (scratch), dz1 and out = [U1, U2 (C each), dw1 (9C^2,
// HWIO)] through part (part_rows rows of out's length: the tile pass runs
// at most part_rows blocks): three launches. Mode 3 (pass 3) reads x, gy,
// dz1, g1, m1, i1, U1, U2 and writes dx: one launch. Returns the
// cudaError_t of the launches on `stream`.
extern "C" int tr_block_tc(int mode, const void* const* p, int B, int H,
                           int W, int C, int part_rows, int dtype, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long P = (long long)B * H * W;
  if (B < 0 || H < 1 || W < 1 || (C != 16 && C != 32 && C != 64) ||
      (mode != kBwd2 && mode != kBwd3) || P * C >= (1LL << 31) ||
      (mode == kBwd2 && P > 0 && part_rows < 1))
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
  a.dc1 = w(p[16]);
  a.dz1 = w(p[17]);
  a.dx = const_cast<void*>(p[18]);
  a.part = w(p[19]);
  float* out = w(p[20]);
  a.P = (int)P;
  a.H = H;
  a.W = W;
  a.n = (float)P;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 0)
    return mode == kBwd3
               ? cudaSuccess
               : cudaMemsetAsync(out, 0, (2 * C + 9 * C * C) * sizeof(float),
                                 st);
  switch (dtype) {
    case tr::kFloat32:
      return dispatch<float>(mode, a, out, part_rows, C, device, st);
    case tr::kBFloat16:
      return dispatch<__nv_bfloat16>(mode, a, out, part_rows, C, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}
