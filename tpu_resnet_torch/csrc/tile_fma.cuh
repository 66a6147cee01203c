// Register-tiled float32 matrix products for the bottleneck's row kernels
// (fused_bottleneck_train.cu): 256 threads, each owning 4 pixels x 8
// channels of an [pixels x F] output tile, the K dimension staged through
// shared memory in chunks of 32 rows. Also the 16-byte loads and stores of
// f32 and bf16, the scale-bias-ReLU and the shared-memory limit the
// bottleneck's kernels share.
#pragma once

#include "common.cuh"

namespace tr {

constexpr int kThreads = 256;
constexpr int kKC = 32;  // rows of K per staged chunk
constexpr int kTM = 4;   // pixels per thread
constexpr int kTN = 8;   // channels per thread
constexpr int kMaxSmem = 232448;

template <int F>
struct Tile {
  static constexpr int TX = F / kTN;          // threads across channels
  static constexpr int TY = kThreads / TX;    // threads across pixels
  static constexpr int BM = TY * kTM;         // pixels per tile
  static constexpr int AG = BM * kKC / 4 / kThreads;  // A float4s per thread
  static constexpr int BG = kKC * F / 4 / kThreads;   // B float4s per thread
  static_assert(TX * TY == kThreads && AG >= 1 && BG >= 1, "tile");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// relu(v*s + b), multiply and add rounded separately as the plain version
// rounds them.
__device__ __forceinline__ float sbr(float v, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), b), 0.f);
}
__device__ __forceinline__ float4 sbr4(float4 v, float4 s, float4 b) {
  return make_float4(sbr(v.x, s.x, b.x), sbr(v.y, s.y, b.y),
                     sbr(v.z, s.z, b.z), sbr(v.w, s.w, b.w));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Channel j (0..7) of the thread's 8: two runs of 4, at 4*tx and F/2+4*tx.
template <int F>
__device__ __forceinline__ int chan(int tx, int j) {
  return (j < 4 ? 4 * tx : F / 2 + 4 * tx) + (j & 3);
}

// acc[i][j] += sum over the chunk's kKC rows k of a[i][k] * bs[k][chan(j)].
// a[i] points at pixel i's first value of the chunk (contiguous, 16-byte
// aligned); bs is a staged [kKC][F] chunk.
template <int F>
__device__ __forceinline__ void fma_chunk(const float* (&a)[kTM],
                                          const float* bs, int tx,
                                          float (&acc)[kTM][kTN]) {
#pragma unroll 2
  for (int k = 0; k < kKC; k += 4) {
    float4 av[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a[i] + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* brow = bs + (k + kk) * F + 4 * tx;
      const float4 b0 = *reinterpret_cast<const float4*>(brow);
      const float4 b1 = *reinterpret_cast<const float4*>(brow + F / 2);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float v = kk == 0 ? av[i].x
                        : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z
                                  : av[i].w;
        acc[i][0] = fmaf(v, b0.x, acc[i][0]);
        acc[i][1] = fmaf(v, b0.y, acc[i][1]);
        acc[i][2] = fmaf(v, b0.z, acc[i][2]);
        acc[i][3] = fmaf(v, b0.w, acc[i][3]);
        acc[i][4] = fmaf(v, b1.x, acc[i][4]);
        acc[i][5] = fmaf(v, b1.y, acc[i][5]);
        acc[i][6] = fmaf(v, b1.z, acc[i][6]);
        acc[i][7] = fmaf(v, b1.w, acc[i][7]);
      }
    }
  }
}

// A [kKC x F] chunk of a row-major weight matrix (row stride ld), carried
// in registers between its load and its store to shared memory.
template <int F>
struct BChunk {
  float4 r[Tile<F>::BG];
  __device__ __forceinline__ void load(const float* __restrict__ src, int ld,
                                       int tid) {
#pragma unroll
    for (int q = 0; q < Tile<F>::BG; ++q) {
      const int idx = tid + q * kThreads;
      r[q] = load4(src + (idx / (F / 4)) * ld + (idx % (F / 4)) * 4);
    }
  }
  __device__ __forceinline__ void store(float* bs, int tid) const {
#pragma unroll
    for (int q = 0; q < Tile<F>::BG; ++q)
      store4(bs + (tid + q * kThreads) * 4, r[q]);
  }
};

__device__ __forceinline__ void zero(float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
}

}  // namespace tr
