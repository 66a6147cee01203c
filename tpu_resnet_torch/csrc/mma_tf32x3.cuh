// Float32 matrix products on Hopper's tensor cores (fused_bottleneck_tc.cu):
// mma.sync m16n8k8 with TF32 operands and f32 accumulation, each f32 operand
// split into big = tf32(v) and small = tf32(v - big), and each product
// accumulated as small*big + big*small, then big*big (the three-term split:
// about 22 of float32's 24 significant bits, the small*small term dropped).
// One TF32 term keeps 11 bits, too few for the sums the kernels are held
// to. The tensor cores add into their accumulator rounding toward zero, a
// bias that grows with K: a caller keeps the accumulator short (one k-step's
// three products from zero) and adds it to its own sum rounding to nearest.
// Also cp.async, the asynchronous 16-byte copy from device to shared
// memory, with zero fill.
#pragma once

#include <cstdint>

namespace tr {

struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ Split split(float v) {
  const uint32_t big = to_tf32(v);
  return {big, to_tf32(__fsub_rn(v, __uint_as_float(big)))};
}

// The split of a warp's A fragment, four values a thread.
__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Split s = split(v[q]);
    big[q] = s.big;
    small[q] = s.small;
  }
}

// d += a . b on one 16x8x8 tile. Thread (g = lane/4, t = lane%4) holds A
// rows g, g+8 at columns t, t+4 (a[0] (g,t), a[1] (g+8,t), a[2] (g,t+4),
// a[3] (g+8,t+4)), B rows t, t+4 of column g, and D rows g, g+8 at columns
// 2t, 2t+1 (d[0], d[1] row g; d[2], d[3] row g+8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three-term product: small*big + big*small, then big*big.
__device__ __forceinline__ void mma_x3(float (&d)[4],
                                       const uint32_t (&a_big)[4],
                                       const uint32_t (&a_small)[4],
                                       const uint32_t (&b_big)[2],
                                       const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// 16 bytes from device memory to shared memory, or 16 zero bytes where
// `valid` is false (src must still be a mapped address; nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tr
