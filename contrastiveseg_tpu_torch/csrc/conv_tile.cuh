// The tensor-core 3x3-conv tile shared by K2a (conv3x3.cu: forward and dX) and both
// stages of K3 (fused_block.cu), on Hopper (sm_90a).
//
// A tile computes Y[p, n] += sum over taps (ky, kx) and k of X[k][p + (ky, kx)] W[tap][k][n]
// for a warp's pixels p (rows of the MMA, m16) and output channels n (columns, n8): the
// implicit GEMM [pixels, 9 K] x [9 K, N] of a 3x3 SAME convolution over one chunk of K.
// The im2col of X is never formed: A fragments are read from haloed rows of X in shared
// memory at each pixel's offset plus the tap's.  Both operands are chunks of 8 "k rows"
// of 32-bit words:
//   * Tf32x3 (fp32): a k row is one channel; mma.sync m16n8k8 TF32 in the 3xTF32 split
//     (x = hi + lo; hi.hi + hi.lo + lo.hi; fp32 accumulation), fp32 accuracy;
//   * Bf16 (bf16): a k row is a channel pair packed as bf16x2 (the lower channel in the
//     low half), mma.sync m16n8k16 bf16 with fp32 accumulation: products of bf16 values
//     are exact, as in the JAX kernel's preferred_element_type=float32 dots.
// The fragment pattern is the same for both (g = lane / 4, t = lane % 4): A words (pixel
// g, k row t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B words (k row t, column g),
// (t + 4, g); the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
//
// Layouts, in 32-bit words.  X: k row r at a + r * KS, pixel rows LDA apart; KS = 8 or
// 24 mod 32, so the 32 lanes of an A load (8 pixels apart by 1, 4 k rows apart by KS) hit
// 32 banks, and the +-1 pixel shift of a tap does not matter.  W: column (output channel)
// n, k row k, tap t at n * W_COL + 9 k + t, W_COL = 4 mod 32: the 8 x 4 lanes of a B load
// add 4 g and 9 t, which are distinct mod 32.  fp32 weights (Tf32x3, W_COL = BS) keep a
// column's 72 words of a chunk contiguous, as an OIHW chunk is in device memory, so
// cp.async copies it coalesced; bf16 weights are packed pairs (Bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace conv_tile {

constexpr int KROWS = 8;  // k rows of words per chunk (8 channels fp32, 16 bf16)

// X's k-row stride: at least `words`, 8 or 24 mod 32.
__host__ __device__ constexpr int conflict_free_stride(int words) {
  const int r = (words + 7) / 8 * 8;
  return r % 16 == 0 ? r + 8 : r;
}

// W's column stride for a chunk of fp32 weights (above).
constexpr int BS = 100;

// threadIdx.x, hidden from loop-invariant code motion: a loader that derives its copies'
// coordinates from it recomputes them at each chunk instead of holding them in registers
// across the chunk loop (hoisted, they spilled K3's and K2a's accumulators).
__device__ __forceinline__ int opaque_tid() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return t;
}

// Packs two fp32 values (bf16 values already, or rounded here) as bf16x2, lo first.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// fp32 operands, PRODUCTS TF32 products per fp32 product (3 ships; 1 = hi.hi alone,
// TF32 accuracy; 0 = none, for the variants tools).  ACCS = 2 keeps hi.hi in one
// accumulator and the two cross terms in another; ACCS = 1 sums all three in one, for
// tiles that cannot spare the registers.  The tensor cores' fp32 accumulation truncates,
// so its error grows with the MMAs summed into one accumulator (K2b: drift over
// 10^5-long chains); with ACCS = 2 the large hi.hi terms see a third of them.  WCOL,
// WKROW, WTAP: W's strides (below) where they differ from the default layout (K2a's dX
// keeps its weights tap-reversed).
template <int PRODUCTS, int ACCS, int WCOL = BS, int WKROW = 9, int WTAP = 1>
struct Tf32x3 {
  struct Acc { float hh[4], x[4]; };
  struct A { unsigned h[4], l[4]; };
  struct B { unsigned h[2], l[2]; };
  static constexpr int W_COL = WCOL, W_KROW = WKROW, W_TAP = WTAP;

  __device__ static void zero(Acc& c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) c.hh[q] = c.x[q] = 0.f;
  }
  __device__ static A a_frag(unsigned w0, unsigned w1, unsigned w2, unsigned w3) {
    A a;
    split_tf32(__uint_as_float(w0), a.h[0], a.l[0]);
    split_tf32(__uint_as_float(w1), a.h[1], a.l[1]);
    split_tf32(__uint_as_float(w2), a.h[2], a.l[2]);
    split_tf32(__uint_as_float(w3), a.h[3], a.l[3]);
    return a;
  }
  __device__ static B b_frag(const float* w) {
    B b;
    split_tf32(w[0], b.h[0], b.l[0]);
    split_tf32(w[4 * W_KROW], b.h[1], b.l[1]);
    return b;
  }
  __device__ static void mma(Acc& c, const A& a, const B& b) {
    float(&cross)[4] = ACCS == 2 ? c.x : c.hh;
    if (PRODUCTS >= 3) {
      mma_tf32(cross, a.l, b.h[0], b.h[1]);
      mma_tf32(cross, a.h, b.l[0], b.l[1]);
    }
    if (PRODUCTS >= 1) mma_tf32(c.hh, a.h, b.h[0], b.h[1]);
  }
  __device__ static float value(const Acc& c, int q) {
    return ACCS == 2 ? c.hh[q] + c.x[q] : c.hh[q];
  }
};

// bf16 operands (PRODUCTS = 0 skips the products, for the variants tool).  W holds
// bf16x2 words, channel pair k, tap t at n * W_COL + 9 k + t, W_COL = 4 mod 32.
template <int PRODUCTS, int WCOL>
struct Bf16 {
  struct Acc { float d[4]; };
  struct A { unsigned w[4]; };
  struct B { unsigned w[2]; };
  static constexpr int W_COL = WCOL, W_KROW = 9, W_TAP = 1;

  __device__ static void zero(Acc& c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) c.d[q] = 0.f;
  }
  __device__ static A a_frag(unsigned w0, unsigned w1, unsigned w2, unsigned w3) {
    return A{{w0, w1, w2, w3}};
  }
  __device__ static B b_frag(const float* w) {
    return B{{__float_as_uint(w[0]), __float_as_uint(w[4 * W_KROW])}};
  }
  __device__ static void mma(Acc& c, const A& a, const B& b) {
    if (PRODUCTS >= 1) mma_bf16(c.d, a.w, b.w[0], b.w[1]);
  }
  __device__ static float value(const Acc& c, int q) { return c.d[q]; }
};

// One chunk of 8 k rows through the 9 taps, for NM m-tiles x NJ n-tiles of a warp.
// a: k row 0 of X; pix[m][h]: the offset in X of the warp's pixel g + 8h of m-tile m at
// tap (0, 0); b: column 0 of W; n0: the warp's first column (n-tile j at n0 + 8j).  The
// taps of one kernel row are unrolled and the rows are not, which bounds how many
// fragments the compiler loads ahead (all 9 taps unrolled spilled).
template <class Op, int NM, int NJ, int LDA>
__device__ __forceinline__ void conv_taps(typename Op::Acc (&acc)[NM][NJ],
                                          const unsigned* __restrict__ a, int ks,
                                          const int (&pix)[NM][2],
                                          const float* __restrict__ b, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned* a0 = a + t * ks;
  const unsigned* a1 = a0 + 4 * ks;
  const float* b0 = b + (n0 + g) * Op::W_COL + t * Op::W_KROW;
#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int off = ky * LDA + kx, tap = 3 * ky + kx;
      typename Op::B bf[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        bf[j] = Op::b_frag(b0 + 8 * j * Op::W_COL + tap * Op::W_TAP);
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int p0 = pix[m][0] + off, p1 = pix[m][1] + off;
        const typename Op::A af = Op::a_frag(a0[p0], a0[p1], a1[p0], a1[p1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) Op::mma(acc[m][j], af, bf[j]);
      }
    }
  }
}

template <class Op, int NM, int NJ>
__device__ __forceinline__ void zero(typename Op::Acc (&acc)[NM][NJ]) {
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j) Op::zero(acc[m][j]);
}

}  // namespace conv_tile
