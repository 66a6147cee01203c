// The fused bottleneck's weight gradients on the tensor cores: out[taps][Ka]
// [Nb] = the sum over the P = B*H*W pixels of A(p, tap)^T . b[p], b f32
// [P][Nb], A by mode:
//   0 rows     f32 [P][Ka] as it is (the folded gradient's dW3 from p3);
//   1 shifted  f32 [B,H,W,Ka] shifted by each of the 9 taps of a 3x3 with
//              SAME zero fill (dw2 = sum p2-patch^T dmid);
//   2 bn_relu  relu(g*((v-mu)*i) + be) of v [P][Ka], f32 or bf16, computed
//              as it is staged (dw1 from x; dw3 from mid, p3 rounded as
//              fused_bottleneck_tc.cu's tile pass rounds m3; the folded
//              gradient's dW1 with (g, be, mu, i) = (s1, b1, 0, 1), so p1 =
//              relu(x*s1 + b1) bit for bit);
//   3 shifted_bn_relu  relu(g*((v-mu)*i) + be) of v [B,H,W,Ka], f32 or
//              bf16, shifted by each of the 9 taps, zero where the tap
//              leaves the image: SAME pads r, after the ReLU, so the zero
//              is applied after the transform (the fused basic block's dw1
//              = sum r1-patch^T dc1 from x with BN1, and dw2 = sum
//              r2-patch^T gy from z2hat with (g2, b2, 0, 1), each rounded
//              as fused_block_tc.cu's tile pass rounds r1 and r2).
// mu and i may be null: (0, 1), a fold.
//
// Replaces the weight-gradient products inside tpu_resnet/ops/
// fused_bottleneck.py's kernels: _train_bwd_calls pass1 (dw3, :662), pass2
// (dw2, :701), pass3 (dw1, :745), and _bwd_kernel's dW3, dw2, dW1 (:339);
// and at C = 128 and 256 inside tpu_resnet/ops/fused_block.py's: pass1
// (dw2, :381), pass2 (dw1, :409), and _block_bwd_kernel's dw2, dw1 (:252).
//
// Bound: operations, 2*P*taps*Ka*Nb flops against (Ka + Nb)*P items read;
// 34*P*f^2 flops a block (dw3 8, dw2 18, dw1 8), 559 GFLOP a ResNet-50 B=128
// step: 8.3 ms at the f32 rate, 3.4 at TF32 over the split's three terms.
//
// Design. M = Ka, N = Nb, K = the pixels. One block per output tile of BM x
// BN (128 where the dimension allows, else 64), tap and split; a split is a
// fixed chunk of the pixels (split-K), chosen by the caller from the shapes
// only, and bottleneck_sum_kernel (row_sums.cuh) adds the splits' partial
// tiles in split order: two calls agree bit for bit, with no atomics. A
// block is producer threads (two warpgroups, one for a 64 x 64 tile) and
// one consumer warpgroup per 64 x 64 outputs. The producers stream the
// pixels in chunks of 16 through a ring of four cp.async stages, four
// pixels of four channels a thread (SAME's zero fill by the copy's source
// size; in mode 3 each copy's validity kept in a register until it is
// converted, and the zero put in after the BN and ReLU), then transpose what
// they copied into K-major rows, apply the BN and ReLU of modes 2 and 3,
// and split each value once into big = tf32(v) and
// small = tf32(v - big) (mma_tf32x3.cuh), into one of four buffers in the
// layout wgmma reads: A's big and small terms, then b's. The consumers run
// Hopper's warpgroup products (wgmma m64n64k8, TF32, both operands from
// shared memory), so the tensor cores are fed while the producers convert
// the next chunks; named barriers hand each buffer over (FULL) and back
// (EMPTY). Each k-step's three products (small*big, big*small, then
// big*big) start from zero and join the running f32 sum rounding to
// nearest: the tensor cores' accumulator truncates, and K reaches 401,408.
// (mma.sync with the same split topped out near 35 TFLOP/s of f32 products
// on an H100, below the f32 units' rate; PERF.md.)

#include <algorithm>

#include "common.cuh"
#include "mma_tf32x3.cuh"
#include "row_sums.cuh"

namespace {

using namespace tr;

enum AMode : int { kRows = 0, kShifted = 1, kBnRelu = 2, kShiftedBnRelu = 3 };
// A shifted by the 9 taps; BN and ReLU applied to A.
__host__ __device__ constexpr bool shifted(int am) {
  return am == kShifted || am == kShiftedBnRelu;
}
__host__ __device__ constexpr bool bn_mode(int am) {
  return am == kBnRelu || am == kShiftedBnRelu;
}

constexpr int kKP = 16;    // pixels per chunk: two k-steps of 8
constexpr int kRaw = 4;    // the producers' cp.async ring
constexpr int kSplit = 4;  // split buffers between producers and consumers
// A split operand (big or small) in wgmma's K-major layout without
// swizzle: 8-row core matrices of 4 values along K (16 bytes a row), the
// four along K of one 8-row group LBO bytes apart, the 8-row groups SBO
// apart. LBO = 144 rather than 128 spreads the producers' 16-byte stores
// over the banks.
constexpr int kLBO = 144, kSBO = 4 * kLBO;

template <typename T, int BM, int BN>
struct WPlan {
  // Consumer warpgroups, each owning 64 x 64 outputs.
  static constexpr int WGM = BM / 64, WGN = BN / 64;
  // The producer threads, which stage and split: A's values on the first
  // B_FIRST, b's on the rest; two warpgroups, or one for a 64 x 64 tile.
  static constexpr int PRODUCERS = WGM * WGN == 1 ? 128 : 256;
  static constexpr int B_FIRST = PRODUCERS / 2;
  static constexpr int THREADS = PRODUCERS + 128 * WGM * WGN;
  static constexpr int A_COPY = 4 * (int)sizeof(T);  // bytes a copy
  // A producer thread copies 4 pixels of 4 channels of A, or of b, a
  // chunk: the groups of channels and pixels.
  static constexpr int A_GROUPS = BM / 4 * (kKP / 4);
  static constexpr int B_GROUPS = BN / 4 * (kKP / 4);
  // One or two consumer warpgroups take a chunk's two k-steps together,
  // each into its own step sum: with few warpgroups an SM, the wait for
  // the first would leave the tensor cores idle.
  static constexpr bool PIPE = WGM * WGN <= 2;
  static constexpr int RAW_A = A_GROUPS * 4 * A_COPY;  // bytes
  static constexpr int RAW = RAW_A + B_GROUPS * 4 * 16;  // one ring stage
  static constexpr int OP_A = BM / 8 * kSBO, OP_B = BN / 8 * kSBO;
  // One split buffer: A's big and small terms, then b's.
  static constexpr int SPLIT = 2 * OP_A + 2 * OP_B;
  static constexpr int SMEM = kRaw * RAW + kSplit * SPLIT;
  static_assert(A_GROUPS <= B_FIRST && B_GROUPS <= PRODUCERS - B_FIRST,
                "groups");
  static_assert(SMEM <= 232448, "smem");
};

struct WArgs {
  const void* a;                    // see the modes above
  const float* b;                   // f32 [P][Nb]
  const float *g, *be, *mu, *i;     // modes 2, 3: the BN ([Ka]); mu, i
                                    // null: (0, 1)
  float* part;                      // [splits][taps][Ka][Nb]
  int P, Ka, Nb, H, W, chunk;       // chunk: pixels per split
};

__device__ __forceinline__ float bn_relu(float v, float g, float be,
                                         float mu, float i) {
  return relu(__fadd_rn(__fmul_rn(g, __fmul_rn(__fsub_rn(v, mu), i)), be));
}

// Byte offset of (row r, k) in a split operand.
__device__ __forceinline__ int op_offset(int r, int k) {
  return (r / 8) * kSBO + (k / 4) * kLBO + (r % 8) * 16 + (k % 4) * 4;
}

// The wgmma shared-memory descriptor of a K-major operand at `p`, no
// swizzle: start address, LBO and SBO, each in 16-byte units.
__device__ __forceinline__ uint64_t op_desc(const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         (uint64_t)((kLBO >> 4) & 0x3FFF) << 16 |
         (uint64_t)((kSBO >> 4) & 0x3FFF) << 32;
}

// d (+)= A . B^T on a 64 x 64 x 8 tile, A and B K-major TF32 in shared
// memory; d starts from zero where scale_d is 0.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of the warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from reading d before the wait: it sees the wgmma's
// registers written only here.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int q = 0; q < 32; ++q) asm volatile("" : "+f"(d[q])::"memory");
}

// Named barriers of all `n` threads of the block between the producers and
// the consumers: FULL(s) when split buffer s holds a chunk, EMPTY(s) when
// the consumers are done with it (id 0 is __syncthreads').
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + kSplit + s; }
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Four channels of A from device to shared memory: 16 bytes (f32) or 8
// (bf16), zero where `valid` is false.
template <typename T>
__device__ __forceinline__ void copy_a(void* dst, const T* src, bool valid) {
  if constexpr (sizeof(T) == 4) {
    cp_async16(dst, src, valid);
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  }
}

// Splits v[0..3] (four pixels of one row) and stores the big terms at
// big + off and the small ones at small + off.
__device__ __forceinline__ void store_split(unsigned char* big,
                                            unsigned char* small, int off,
                                            const float (&v)[4]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Split s = split(v[q]);
    hi[q] = s.big;
    lo[q] = s.small;
  }
  *reinterpret_cast<uint4*>(big + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(small + off) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// The producers: a thread copies four pixels of four channels of A (the
// first B_FIRST threads) or of b (the rest) a chunk through the cp.async
// ring, then transposes them into split buffer c % kSplit in K-major rows,
// BN and ReLU applied (modes 2, 3), each value split once.
template <typename T, int AM, int BM, int BN>
__device__ __forceinline__ void produce(const WArgs& a, unsigned char* ring,
                                        unsigned char* sbuf, int k0, int n0,
                                        int tap, int p_begin, int p_end,
                                        int chunks) {
  using PL = WPlan<T, BM, BN>;
  const bool is_a = threadIdx.x < PL::B_FIRST;
  const int tid = is_a ? threadIdx.x : threadIdx.x - PL::B_FIRST;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  // The thread's pixels 4*kg .. 4*kg+3 of a chunk, and its channels.
  const int kg = tid % 4, ch = (tid / 4) * 4;
  const bool active = tid < (is_a ? PL::A_GROUPS : PL::B_GROUPS);
  float bn[bn_mode(AM) ? 4 : 1][4];
  if constexpr (bn_mode(AM)) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = is_a && active ? k0 + ch + q : k0;
      bn[q][0] = __ldg(a.g + c);
      bn[q][1] = __ldg(a.be + c);
      bn[q][2] = a.mu ? __ldg(a.mu + c) : 0.f;
      bn[q][3] = a.i ? __ldg(a.i + c) : 1.f;
    }
  }
  // Mode 3: the validity of the thread's four copies of each ring stage,
  // bits 4*stage .. 4*stage+3, set where issued and read where converted.
  unsigned valid = 0;
  // Shifted: the (row, column) in its image of the thread's first pixel of
  // the next chunk to issue, advanced kKP pixels a chunk.
  int ay = 0, ax = 0;
  if constexpr (shifted(AM)) {
    const int rem = (p_begin + 4 * kg) % (a.H * a.W);
    ay = rem / a.W;
    ax = rem % a.W;
  }
  const T* asrc = static_cast<const T*>(a.a);
  auto issue = [&](int c) {
    if (c >= chunks) return;
    unsigned char* st = ring + (c % kRaw) * PL::RAW;
    const int p0 = p_begin + c * kKP + 4 * kg;
    if (active && is_a) {
      int y = ay, x = ax;
      unsigned bits = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + q;
        long long pix = p;
        bool ok = p < p_end;
        if constexpr (shifted(AM)) {
          ok = ok && y + dy >= 0 && y + dy < a.H && x + dx >= 0 &&
               x + dx < a.W;
          pix += dy * a.W + dx;
          if (++x == a.W) {
            x = 0;
            if (++y == a.H) y = 0;
          }
        }
        bits |= (unsigned)ok << q;
        copy_a(st + (tid * 4 + q) * PL::A_COPY,
               asrc + (ok ? pix : 0) * a.Ka + k0 + ch, ok);
      }
      if constexpr (AM == kShiftedBnRelu) {
        const int sh = 4 * (c % kRaw);
        valid = (valid & ~(0xFu << sh)) | (bits << sh);
      }
    } else if (active) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + q;
        const bool ok = p < p_end;
        cp_async16(st + PL::RAW_A + (tid * 4 + q) * 16,
                   a.b + (long long)(ok ? p : 0) * a.Nb + n0 + ch, ok);
      }
    }
    if constexpr (shifted(AM)) {
      ax += kKP;
      while (ax >= a.W) {
        ax -= a.W;
        if (++ay == a.H) ay = 0;
      }
    }
  };
  auto convert = [&](int c) {
    const unsigned char* st = ring + (c % kRaw) * PL::RAW;
    unsigned char* big = sbuf + (c % kSplit) * PL::SPLIT;
    const int p0 = p_begin + c * kKP + 4 * kg;
    if (!active) return;
    float v[4][4];  // [channel][pixel]
    if (is_a) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T* raw =
            reinterpret_cast<const T*>(st + (tid * 4 + q) * PL::A_COPY);
        // Mode 3: a tap outside the image reads 0 after the transform.
        const bool ok = AM == kShiftedBnRelu
                            ? (valid >> (4 * (c % kRaw) + q)) & 1
                            : p0 + q < p_end;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float u = to_f32(raw[j]);
          if constexpr (bn_mode(AM))
            u = bn_relu(u, bn[j][0], bn[j][1], bn[j][2], bn[j][3]);
          v[j][q] = ok ? u : 0.f;
        }
      }
    } else {
      big += 2 * PL::OP_A;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 u = *reinterpret_cast<const float4*>(
            st + PL::RAW_A + (tid * 4 + q) * 16);
        v[0][q] = u.x;
        v[1][q] = u.y;
        v[2][q] = u.z;
        v[3][q] = u.w;
      }
    }
    unsigned char* small = big + (is_a ? PL::OP_A : PL::OP_B);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_split(big, small, op_offset(ch + j, 4 * kg), v[j]);
    // The consumers' wgmma reads through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < kRaw; ++s) {
    issue(s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kRaw - 1>();  // this thread's copies of chunk c
    const int s = c % kSplit;
    if (c >= kSplit) bar_sync(empty_bar(s), PL::THREADS);
    convert(c);
    bar_arrive(full_bar(s), PL::THREADS);
    issue(c + kRaw);  // into the stage chunk c left
    cp_async_commit();
  }
  cp_async_wait<0>();
}

template <typename T, int AM, int BM, int BN>
__global__ void __launch_bounds__(WPlan<T, BM, BN>::THREADS,
                                  BM * BN <= 64 * 64 ? 2 : 1)
    bottleneck_wgrad_kernel(const WArgs a) {
  using PL = WPlan<T, BM, BN>;
  constexpr int taps = shifted(AM) ? 9 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sbuf = smem + kRaw * PL::RAW;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM;
  const int split_i = blockIdx.z / taps, tap = blockIdx.z % taps;
  const int p_begin = min(a.P, split_i * a.chunk);
  const int p_end = min(a.P, p_begin + a.chunk);
  const int chunks = (p_end - p_begin + kKP - 1) / kKP;
  if (threadIdx.x < PL::PRODUCERS) {
    produce<T, AM, BM, BN>(a, smem, sbuf, k0, n0, tap, p_begin, p_end,
                           chunks);
    return;
  }
  // A consumer warpgroup: 64 x 64 outputs, rows 64*wgm, columns 64*wgn.
  const int ctid = threadIdx.x - PL::PRODUCERS;
  const int wg = ctid / 128, wgm = wg / PL::WGN, wgn = wg % PL::WGN;
  float acc[32], step[32], step2[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kSplit;
    bar_sync(full_bar(s), PL::THREADS);
    const unsigned char* sa = sbuf + s * PL::SPLIT + wgm * 8 * kSBO;
    const unsigned char* sb =
        sbuf + s * PL::SPLIT + 2 * PL::OP_A + wgn * 8 * kSBO;
    // Each k-step's three products from zero (small*big + big*small, then
    // big*big), added to the running sum rounding to nearest.
    auto products = [&](float(&d)[32], int ks) {
      const int k = 2 * ks * kLBO;
      wgmma_tf32(d, op_desc(sa + PL::OP_A + k), op_desc(sb + k), 0);
      wgmma_tf32(d, op_desc(sa + k), op_desc(sb + PL::OP_B + k), 1);
      wgmma_tf32(d, op_desc(sa + k), op_desc(sb + k), 1);
      wgmma_commit();
    };
    auto add = [&](float(&d)[32]) {
      fence_operands(d);
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[q] = __fadd_rn(acc[q], d[q]);
    };
    wgmma_fence();
    if constexpr (PL::PIPE) {
      products(step, 0);
      products(step2, 1);
      wgmma_wait<1>();
      add(step);
      wgmma_wait<0>();
      add(step2);
    } else {
#pragma unroll
      for (int ks = 0; ks < kKP / 8; ++ks) {
        if (ks) wgmma_fence();
        products(step, ks);
        wgmma_wait<0>();
        add(step);
      }
    }
    // The producers wait for this only where they refill the buffer.
    if (c + kSplit < chunks) bar_arrive(empty_bar(s), PL::THREADS);
  }

  // wgmma's m64nNk8 accumulator: warp w of the warpgroup holds rows 16w +
  // lane/4 and 8 more, columns 8i + 2*(lane%4) and the next.
  const int w = (ctid % 128) / 32, lane = ctid % 32;
  const int row0 = wgm * 64 + 16 * w + lane / 4;
  float* out = a.part + ((long long)blockIdx.z * a.Ka + k0) * a.Nb + n0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = wgn * 64 + 8 * i + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (long long)(row0 + 8 * h) * a.Nb +
                                 col) =
          make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
}

template <typename T, int AM, int BM, int BN>
cudaError_t run(const WArgs& w, int splits, cudaStream_t st) {
  auto kernel = bottleneck_wgrad_kernel<T, AM, BM, BN>;
  constexpr int smem = WPlan<T, BM, BN>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int taps = shifted(AM) ? 9 : 1;
  const dim3 grid(w.Nb / BN, w.Ka / BM, splits * taps);
  kernel<<<grid, WPlan<T, BM, BN>::THREADS, smem, st>>>(w);
  return cudaGetLastError();
}

// The output tile: 128 along a dimension that 128 divides, else 64.
template <typename T, int AM>
cudaError_t run_tiled(const WArgs& w, int splits, cudaStream_t st) {
  const bool m128 = w.Ka % 128 == 0, n128 = w.Nb % 128 == 0;
  if (m128 && n128) return run<T, AM, 128, 128>(w, splits, st);
  if (m128) return run<T, AM, 128, 64>(w, splits, st);
  if (n128) return run<T, AM, 64, 128>(w, splits, st);
  return run<T, AM, 64, 64>(w, splits, st);
}

template <typename T>
cudaError_t launch(int amode, const WArgs& w, int splits, float* out,
                   cudaStream_t st) {
  cudaError_t err;
  switch (amode) {
    case kRows:
      err = run_tiled<float, kRows>(w, splits, st);
      break;
    case kShifted:
      err = run_tiled<float, kShifted>(w, splits, st);
      break;
    case kBnRelu:
      err = run_tiled<T, kBnRelu>(w, splits, st);
      break;
    case kShiftedBnRelu:
      err = run_tiled<T, kShiftedBnRelu>(w, splits, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int taps = shifted(amode) ? 9 : 1;
  return sum_rows(w.part, out, splits, (long long)taps * w.Ka * w.Nb, st);
}

}  // namespace

// out[taps][Ka][Nb] = sum over the P = B*H*W pixels of A^T b, A by `amode`
// (0 rows, 1 shifted, 2 bn_relu, 3 shifted_bn_relu; see the top of this
// file); v of modes 2 and 3 of `dtype` (tr::DType), every other tensor
// f32. p[8]: a, b [P][Nb], g, be, mu, i ([Ka], modes 2 and 3; mu and i may
// be null), part (splits*taps*Ka*Nb floats), out
// (taps*Ka*Nb). Ka and Nb are multiples of 64; every tensor contiguous and
// 16-byte aligned. The pixels go in `splits` chunks of whole 16-pixel
// steps, their partial products added in split order by a second launch.
// Returns the cudaError_t of the two launches on `stream`.
extern "C" int tr_bottleneck_wgrad(int amode, const void* const* p, int P,
                                   int Ka, int Nb, int H, int W, int splits,
                                   int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (P < 1 || Ka < 64 || Nb < 64 || Ka % 64 || Nb % 64 || splits < 1 ||
      H < 1 || W < 1 || (shifted(amode) && P % (H * W)))
    return cudaErrorInvalidValue;
  WArgs w = {};
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  w.a = p[0];
  w.b = f(p[1]);
  w.g = f(p[2]);
  w.be = f(p[3]);
  w.mu = f(p[4]);
  w.i = f(p[5]);
  w.part = static_cast<float*>(const_cast<void*>(p[6]));
  w.P = P;
  w.Ka = Ka;
  w.Nb = Nb;
  w.H = H;
  w.W = W;
  w.chunk = ((P + splits - 1) / splits + kKP - 1) / kKP * kKP;
  float* out = static_cast<float*>(const_cast<void*>(p[7]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::kFloat32:
      return launch<float>(amode, w, splits, out, st);
    case tr::kBFloat16:
      return launch<__nv_bfloat16>(amode, w, splits, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}
