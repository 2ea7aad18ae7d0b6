// Helpers shared by K1 (contrast_infonce.cu), K2 (conv3x3.cu) and K3 (fused_block.cu,
// through conv_tile.cuh) on Hopper (sm_90a): cp.async copies into shared memory, 3xTF32
// and bf16 tensor-core products on mma.sync.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Global -> shared copies that do not block; src_bytes = 0 reads nothing and
// writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo: hi is x with the 13 low mantissa bits cleared (a TF32
// value), lo = x - hi exactly.  The tensor cores read a TF32 operand's top
// 19 bits, so lo enters the products truncated to TF32: |lo - tf32(lo)| <=
// 2^-10 |lo| <= 2^-20 |x|.  Two integer/fp32 instructions, where cvt.rna
// would take two conversions on the slower conversion pipe.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b on one m16n8k8 tile, fp32 accumulation.  Fragments (g = lane / 4,
// t = lane % 4): a = (g, t), (g+8, t), (g, t+4), (g+8, t+4); b = (t, g),
// (t+4, g); d = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on one m16n8k16 tile of bf16 operands, fp32 accumulation; the products of
// bf16 values are exact.  Each register holds two bf16 of consecutive k, the lower k in
// the low half: a = (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..); b = (2t..2t+1,
// g), (2t+8..2t+9, g); d as in mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Waits until at most N of this thread's committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
