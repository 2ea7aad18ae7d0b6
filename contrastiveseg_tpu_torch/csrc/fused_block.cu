// K3: the inference HRNet BasicBlock as one kernel for Hopper (sm_90a), NCHW.
//
// Replaces the Pallas TPU kernel _fused_block_kernel of
// contrastiveseg_tpu/ops/block_pallas.py (:51, via fused_basic_block_eval :135):
//     y = relu(conv2(y1) + b2 + x),  y1 = relu(conv1(x) + b1),
// 3x3 SAME convs whose fp32 weights already carry the folded BN scales; the kernel
// rounds them to x's type (bf16: to nearest even as it packs them), as the JAX wrapper
// rounds the folded weights (:158-159).  x and y are fp32 or bf16; sums are fp32; y1 is
// rounded to x's type, as the JAX kernel's y1 scratch holds it.
//
// Bound: at [8, 48, 128, 256] the block is 2 convs x 2*9*C*C*B*H*W = 21.7 GFLOP against
// 2 x 25 MB of x and y in bf16 (50 MB each in fp32): the operations, 22 us on bf16
// tensor cores (989 TFLOP/s) and 132 us in fp32 at the 3xTF32 rate (495/3 TFLOP/s).
//
// Design: both convs are passes of K2a's tensor-core tile (conv_tile.cuh): pixels as the
// MMA's rows, output channels as its columns, A fragments read from haloed rows in shared
// memory at each tap's offset.
//   * bf16 (the bench's type, and the JAX kernel's arithmetic: bf16 operands, fp32
//     accumulation): mma.sync m16n8k16 bf16, exact products, no split.  Its A register
//     holds channels 2t and 2t + 1 of one pixel, which NCHW does not give and which
//     ldmatrix cannot fetch at a tap's 2-byte shift, so x and y1 sit in shared memory as
//     [channel pair][pixel] bf16x2 words: the loader packs x's pairs through registers,
//     and stage 1's accumulator fragment (pixel g, channels 2t and 2t + 1) is rounded,
//     packed and stored straight into the layout stage 2 reads.  fp32: 3xTF32 m16n8k8
//     with the three products in one accumulator a tile, x copied by cp.async;
//   * an 8 x 32 output tile of one image and all C <= 64 channels to a block at a time
//     (conv2 needs every channel of y1); 16 warps = 8 pixel groups x 2 channel halves.
//     Stage 1 computes y1 on the haloed 10 x 34 tile (22 m-tiles of 16 pixels, 1.375x
//     conv1's own work) from x chunks of 8 (fp32) or 16 (bf16) channels with their 12 x
//     36 halo, through a two-stage ring: the next chunk's copies are in flight (cp.async;
//     bf16 x in registers) while one is computed.  y1 stays in shared memory and never
//     touches device memory.  Stage 2 adds b2 and x, through shared memory so that x and
//     y move in 16- or 8-byte accesses;
//   * weights: fp32 streams each chunk's w1 or w2 through the ring with x (w1, w2, y1 and
//     the ring do not all fit at fp32).  bf16 packs both to bf16x2 once a block and keeps
//     them resident (224,768 bytes with y1 and the ring at C = 64); its blocks are
//     persistent, one an SM, walking the tiles, so conv2 runs with no loads and the
//     next tile's first x chunk is fetched while it runs (streamed per tile, as fp32
//     does, the weights were the largest cost of the bf16 kernel beyond its products);
//   * conv2's SAME padding reads zeros, never conv1 evaluated on the padding (relu(b1)
//     != 0): stage 1 writes 0 for every y1 position outside the image, so the first and
//     last row tiles and the ragged column tile read zeros there (block_pallas.py:93-101
//     masks the same positions).  x's halo is masked in the loader: no padded copy of x.
//
// Plain C interface (loaded with ctypes).  fused_block_init() raises the kernels' dynamic
// shared-memory limit once per device.  Entry points launch on the given stream, do not
// synchronise and return cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv_tile.cuh"
#include "tc_common.cuh"

namespace {

// K3's diagnostic build switches, for tools/bench_k2_variants.py; the port builds the
// defaults.  K3_PRODUCTS: products per product, 3 (fp32: 3xTF32; bf16: one bf16
// product), 1 (fp32: one TF32 product; bf16: unchanged) or 0 (none).  K3_NO_LOADS: skip
// the x and streamed weight loads (the products on whatever shared memory holds).
#ifndef K3_PRODUCTS
#define K3_PRODUCTS 3
#endif

constexpr int KR = conv_tile::KROWS;
constexpr int TH = 8, TW = 32;             // output tile
constexpr int WARPS = 16, NT = WARPS * 32;
constexpr int NG = WARPS / 8;              // warps of a pixel group: output-channel groups
constexpr int NS = 2;                      // chunks in the ring
constexpr int YR = TH + 2, YC = TW + 2;    // y1 tile, one halo row/column each side
constexpr int P1 = YR * YC;                // 340 stage-1 pixels
constexpr int NM1 = (P1 + 16 * 8 - 1) / (16 * 8);  // stage-1 m-tiles a warp: 3 (22 of 24)
constexpr int NM2 = TH * TW / (16 * 8);            // stage-2 m-tiles a warp: 2
// x tile: rows h0 - 2 .. h0 + TH + 1; column X0 + c holds x column w0 + c (16-byte
// aligned), for c in [-2, TW + 2).
constexpr int XR = TH + 4, X0 = 4, LDX = X0 + TW + 4;
constexpr int KSX = conv_tile::conflict_free_stride(XR * LDX);  // 488 words
constexpr int LDY = YC;
constexpr int KSY = conv_tile::conflict_free_stride(YR * LDY);  // 344 words
constexpr int LDO = TH * TW + 4;           // output staging: 4 mod 32, conflict-free
constexpr int MAX_C = 64;

// fp32 (streamed weights): y1 [16 nj][KSY], then NS stages of [KR][KSX] x words and
// [16 nj][conv_tile::BS] weights; 170,496 bytes at nj = 4.
__host__ __device__ constexpr int f32_stage_words(int nj) {
  return KR * KSX + 16 * nj * conv_tile::BS;
}
__host__ __device__ constexpr int f32_smem_bytes(int nj) {
  return (16 * nj * KSY + NS * f32_stage_words(nj)) * 4;
}
// bf16 (resident weights): w1 and w2 packed [16 nj][bf16_wcol] (9 words a channel pair of
// the 8 nj pairs, 4 mod 32), y1 [8 nj][KSY], then NS stages of [KR][KSX] x words;
// 224,768 bytes at nj = 4.
__host__ __device__ constexpr int bf16_wcol(int nj) {
  return 72 * nj + (4 - 72 * nj % 32 + 32) % 32;
}
__host__ __device__ constexpr int bf16_smem_bytes(int nj) {
  return (2 * 16 * nj * bf16_wcol(nj) + 8 * nj * KSY + NS * KR * KSX) * 4;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four consecutive values as one 16-byte (fp32) or 8-byte (bf16) access.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(conv_tile::pack_bf16(v[0], v[1]), conv_tile::pack_bf16(v[2], v[3]));
}

// A tile of one image: output rows h0 .., columns w0 ...
struct Tile {
  int b, h0, w0;
};
__device__ __forceinline__ Tile tile_at(int i, int H, int W) {
  const int nw = (W + TW - 1) / TW, nh = (H + TH - 1) / TH;
  return {i / (nw * nh), i / nw % nh * TH, i % nw * TW};
}

// The x loads of a chunk of 8 k rows: channels [c0, c0 + 8) in fp32, channel pairs of
// [c0, c0 + 16) in bf16: the tile's 12 rows and 36 columns as [k row][row][column], zero
// outside the image and past C.  fp32 by cp.async (16-byte copies of the body where
// `wide`); bf16 fetched into registers, pairs packed (4-byte loads of pixel pairs where
// `wide`), and committed to shared memory after the chunk being computed.
template <typename T>
struct XLoader {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int XP = (KR * XR * 18 + NT - 1) / NT;  // bf16: pixel pairs a thread
  const T* x;  // the tile's image
  int C, H, W, h0, w0;
  bool wide;
  unsigned rx[F32 ? 1 : 2 * XP];

  __device__ void fetch(int c0, unsigned* xs) {
#ifdef K3_NO_LOADS
    return;
#endif
    const int tid = conv_tile::opaque_tid();
    const size_t plane = (size_t)H * W;
    if constexpr (F32) {
      float* xf = reinterpret_cast<float*>(xs);
      if (wide) {
        for (int i = tid; i < KR * XR * 8; i += NT) {  // the body, 4 columns a copy
          const int k = i / (XR * 8), r = i / 8 % XR, q = i % 8 * 4;
          const int gh = h0 - 2 + r, gw = w0 + q, ci = c0 + k;
          const bool ok = gh >= 0 && gh < H && gw < W && ci < C;
          cp_async16(xf + k * KSX + r * LDX + X0 + q, x + (ok ? ci * plane + gh * W + gw : 0),
                     ok ? 16 : 0);
        }
      }
      // The halo columns (2 a side), or every column.
      const int per = wide ? 4 : TW + 4;
      for (int i = tid; i < KR * XR * per; i += NT) {
        const int k = i / (XR * per), r = i / per % XR, e = i % per;
        const int c = wide ? (e < 2 ? e - 2 : TW + e - 2) : e - 2;
        const int gh = h0 - 2 + r, gw = w0 + c, ci = c0 + k;
        const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W && ci < C;
        cp_async4(xf + k * KSX + r * LDX + X0 + c, x + (ok ? ci * plane + gh * W + gw : 0),
                  ok ? 4 : 0);
      }
    } else {
      // Pixel pair (gw, gw + 1) of channels ci and ci + 1 (gw even) becomes the words of
      // pixels gw and gw + 1; with W even the pair is wholly in or out of the image.
      const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
#pragma unroll
      for (int s = 0; s < XP; ++s) {
        const int i = tid + s * NT;
        if (i >= KR * XR * 18) break;
        const int k = i / (XR * 18), r = i / 18 % XR, c = i % 18 * 2 - 2;
        const int gh = h0 - 2 + r, gw = w0 + c, ci = c0 + 2 * k;
        const bool row = gh >= 0 && gh < H, c0ok = ci < C, c1ok = ci + 1 < C;
        const size_t at = ci * plane + (size_t)gh * W + gw;
        unsigned lo, hi;  // channels ci and ci + 1 at pixels gw (low half), gw + 1
        if (wide) {
          const bool in = row && gw >= 0 && gw < W;
          lo = in && c0ok ? *reinterpret_cast<const unsigned*>(xh + at) : 0u;
          hi = in && c1ok ? *reinterpret_cast<const unsigned*>(xh + at + plane) : 0u;
        } else {
          const bool in0 = row && gw >= 0 && gw < W, in1 = row && gw + 1 >= 0 && gw + 1 < W;
          lo = (in0 && c0ok ? xh[at] : 0u) | (in1 && c0ok ? (unsigned)xh[at + 1] << 16 : 0u);
          hi = (in0 && c1ok ? xh[at + plane] : 0u) |
               (in1 && c1ok ? (unsigned)xh[at + plane + 1] << 16 : 0u);
        }
        rx[2 * s] = __byte_perm(lo, hi, 0x5410);
        rx[2 * s + 1] = __byte_perm(lo, hi, 0x7632);
      }
    }
  }
  __device__ void commit(unsigned* xs) const {
    if constexpr (!F32) {
      const int tid = conv_tile::opaque_tid();
#pragma unroll
      for (int s = 0; s < XP; ++s) {
        const int i = tid + s * NT;
        if (i >= KR * XR * 18) break;
        unsigned* dst = xs + i / (XR * 18) * KSX + i / 18 % XR * LDX + X0 + i % 18 * 2 - 2;
        dst[0] = rx[2 * s];
        dst[1] = rx[2 * s + 1];
      }
    }
  }
};

// fp32's streamed weights: chunk c0 (channels [c0, c0 + 8)) of every output channel n is
// 72 contiguous words at (n C + c0) 9, copied by cp.async to ws[n BS + 9 k + tap]
// (16-byte copies where the runs are whole and aligned).
template <int NJ>
__device__ void fetch_w_f32(const float* __restrict__ w, int C, int c0, bool wide, float* ws) {
#ifdef K3_NO_LOADS
  return;
#endif
  const int tid = conv_tile::opaque_tid();
  if (wide && C % 4 == 0 && c0 + KR <= C) {
    for (int i = tid; i < 16 * NJ * 18; i += NT) {
      const int n = i / 18, r = i % 18 * 4;
      cp_async16(ws + n * conv_tile::BS + r, w + (n < C ? ((size_t)n * C + c0) * 9 + r : 0),
                 n < C ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < 16 * NJ * 72; i += NT) {
    const int n = i / 72, r = i % 72;
    const bool ok = n < C && c0 + r / 9 < C;
    cp_async4(ws + n * conv_tile::BS + r, w + (ok ? ((size_t)n * C + c0) * 9 + r : 0),
              ok ? 4 : 0);
  }
}

// The warp's pixel offsets.  Stage 1: pixel p of the y1 tile is m-tile p / 16 (warp group
// (p / 16) % 8); its tap (0, 0) reads x tile row p / YC, column X0 - 2 + p % YC; pixels
// past P1 read pixel P1 - 1 and are not stored.  Stage 2: output pixel p reads y1 row
// p / TW, column p % TW.
__device__ __forceinline__ void pixel_offsets(int mg, int g, int (&pix1)[NM1][2],
                                              int (&pix2)[NM2][2]) {
#pragma unroll
  for (int m = 0; m < NM1; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min(16 * (mg + 8 * m) + 8 * h + g, P1 - 1);
      pix1[m][h] = p / YC * LDX + X0 - 2 + p % YC;
    }
#pragma unroll
  for (int m = 0; m < NM2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * (mg + 8 * m) + 8 * h + g;
      pix2[m][h] = p / TW * LDY + p % TW;
    }
}

// y1 = relu(conv1 + b1) rounded to T into shared memory ([channel][KSY] fp32, [pair][KSY]
// bf16x2); 0 outside the image (conv2's padding) and past C.
template <typename T, class Op, int NJW>
__device__ __forceinline__ void store_y1(const typename Op::Acc (&acc)[NM1][NJW],
                                         const float* __restrict__ b1, unsigned* y1s, int C,
                                         int H, int W, Tile tl, int mg, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int m = 0; m < NM1; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * (mg + 8 * m) + 8 * h + g;
      if (p >= P1) continue;
      const int r = p / YC, q = p % YC, gh = tl.h0 - 1 + r, gw = tl.w0 - 1 + q;
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
#pragma unroll
      for (int j = 0; j < NJW; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = in && n + e < C
                     ? to_f(from_f<T>(fmaxf(Op::value(acc[m][j], 2 * h + e) + b1[n + e], 0.f)))
                     : 0.f;
        if constexpr (std::is_same<T, float>::value) {
          float* y1f = reinterpret_cast<float*>(y1s);
          y1f[n * KSY + r * LDY + q] = v[0];
          y1f[(n + 1) * KSY + r * LDY + q] = v[1];
        } else {
          y1s[n / 2 * KSY + r * LDY + q] = conv_tile::pack_bf16(v[0], v[1]);
        }
      }
    }
}

// y = relu(conv2 + b2 + x): conv2 + b2 goes through shared memory os ([channel][LDO],
// free when called), then runs in rows of 4 pixels: 16-byte (fp32) or 8-byte (bf16)
// loads and stores where `wide`, full sectors either way.
template <typename T, class Op, int NJW>
__device__ __forceinline__ void write_output(const typename Op::Acc (&acc)[NM2][NJW],
                                             const float* __restrict__ b2, float* os,
                                             const T* __restrict__ x, T* __restrict__ y, int C,
                                             int H, int W, Tile tl, int mg, int n0, bool wide) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int m = 0; m < NM2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + 2 * t + e;
          if (n < C)
            os[n * LDO + 16 * (mg + 8 * m) + 8 * h + g] =
                Op::value(acc[m][j], 2 * h + e) + b2[n];
        }
  __syncthreads();
  const size_t plane = (size_t)H * W, image = tl.b * C * plane;
  for (int i = threadIdx.x; i < C * TH * TW / 4; i += NT) {
    const int n = i / (TH * TW / 4), p = i % (TH * TW / 4) * 4;
    const int gh = tl.h0 + p / TW, gw = tl.w0 + p % TW;
    if (gh >= H || gw >= W) continue;
    const size_t at = image + n * plane + (size_t)gh * W + gw;
    float v[4], xv[4];
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(os + n * LDO + p);
    if (wide) {
      load4(x + at, xv);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = fmaxf(v[e] + xv[e], 0.f);
      store4(y + at, v);
    } else {
      for (int e = 0; e < 4 && gw + e < W; ++e)
        y[at + e] = from_f<T>(fmaxf(v[e] + to_f(x[at + e]), 0.f));
    }
  }
}

// fp32: one block a tile.  The ring's chunks: q < nk is conv1's chunk q (x and w1), then
// conv2's (w2 over y1).
template <int NJ>
__global__ void __launch_bounds__(NT, 1) fused_block_f32(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ b1, const float* __restrict__ b2, float* __restrict__ y, int C,
    int H, int W, int wide) {
  using Op = conv_tile::Tf32x3<K3_PRODUCTS, 1>;
  constexpr int STAGE = f32_stage_words(NJ), NJW = 2 * NJ / NG;
  static_assert(16 * NJ * LDO <= NS * STAGE, "the output staging fits in the ring");
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* y1s = smem;  // [16 NJ][KSY]
  unsigned* ring = smem + 16 * NJ * KSY;
  auto xs = [&](int q) { return ring + q % NS * STAGE; };
  auto ws = [&](int q) { return reinterpret_cast<float*>(ring + q % NS * STAGE + KR * KSX); };

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int mg = warp / NG, n0 = warp % NG * 8 * NJW;
  const Tile tl{(int)blockIdx.z, (int)blockIdx.y * TH, (int)blockIdx.x * TW};
  XLoader<float> ld{x + (size_t)tl.b * C * H * W, C, H, W, tl.h0, tl.w0, wide != 0};
  const int nk = (C + KR - 1) / KR, nq = 2 * nk;
  auto fetch = [&](int q) {
    if (q < nk) ld.fetch(q * KR, xs(q));
    fetch_w_f32<NJ>(q < nk ? w1 : w2, C, q % nk * KR, wide != 0, ws(q));
  };
  // Before chunk q: waits for it, and starts chunk q + NS - 1 into the stage of q - 1.
  auto advance = [&](int q) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // chunk q is in shared memory; chunk q - 1 is consumed
    if (q + NS - 1 < nq) fetch(q + NS - 1);
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < NS - 1; ++q) {
    fetch(q);
    cp_async_commit();
  }

  int pix1[NM1][2], pix2[NM2][2];
  pixel_offsets(mg, g, pix1, pix2);
  typename Op::Acc acc1[NM1][NJW];
  conv_tile::zero<Op, NM1, NJW>(acc1);
  for (int q = 0; q < nk; ++q) {
    advance(q);
    conv_tile::conv_taps<Op, NM1, NJW, LDX>(acc1, xs(q), KSX, pix1, ws(q), n0);
  }
  store_y1<float, Op, NJW>(acc1, b1, y1s, C, H, W, tl, mg, n0);
  typename Op::Acc acc2[NM2][NJW];
  conv_tile::zero<Op, NM2, NJW>(acc2);
  for (int q = nk; q < nq; ++q) {
    advance(q);  // at q = nk, also: y1 is stored
    conv_tile::conv_taps<Op, NM2, NJW, LDY>(acc2, y1s + (q - nk) * KR * KSY, KSY, pix2, ws(q),
                                            n0);
  }
  __syncthreads();  // the ring is consumed
  write_output<float, Op, NJW>(acc2, b2, reinterpret_cast<float*>(ring), x, y, C, H, W, tl,
                               mg, n0, wide != 0);
}

// bf16: persistent blocks.  w1 and w2 are packed to bf16x2 once a block and stay in shared
// memory; then the block walks tiles blockIdx.x, + gridDim.x, ...: conv1 over x chunks of
// 16 channels through a two-stage register-staged ring, y1, conv2 with no loads (its
// operands are all resident), the output; the next tile's first x chunk is fetched while
// conv2 runs.
template <int NJ>
__global__ void __launch_bounds__(NT, 1) fused_block_bf16(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ w2, const float* __restrict__ b1, const float* __restrict__ b2,
    __nv_bfloat16* __restrict__ y, int C, int H, int W, int wide, int n_tiles) {
  constexpr int WCOL = bf16_wcol(NJ), NJW = 2 * NJ / NG;
  using Op = conv_tile::Bf16<K3_PRODUCTS, WCOL>;
  using L = XLoader<__nv_bfloat16>;
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* wp1 = smem;                   // [16 NJ][WCOL]
  unsigned* wp2 = wp1 + 16 * NJ * WCOL;
  unsigned* y1s = wp2 + 16 * NJ * WCOL;   // [8 NJ][KSY]
  unsigned* ring = y1s + 8 * NJ * KSY;    // NS x [KR][KSX]
  float* os = reinterpret_cast<float*>(y1s);  // output staging over y1 and the ring
  static_assert(16 * NJ * LDO <= 8 * NJ * KSY + NS * KR * KSX, "the output staging fits");

  // Word r = 9 k + tap of channel n's column: channels 2k and 2k + 1 (of 16 NJ) at tap.
  for (int i = threadIdx.x; i < 16 * NJ * 72 * NJ; i += NT) {
    const int n = i / (72 * NJ), r = i % (72 * NJ), c = r / 9 * 2;
    const size_t at = ((size_t)n * C + c) * 9 + r % 9;
    const bool lo = n < C && c < C, hi = n < C && c + 1 < C;
    wp1[n * WCOL + r] = conv_tile::pack_bf16(lo ? w1[at] : 0.f, hi ? w1[at + 9] : 0.f);
    wp2[n * WCOL + r] = conv_tile::pack_bf16(lo ? w2[at] : 0.f, hi ? w2[at + 9] : 0.f);
  }

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int mg = warp / NG, n0 = warp % NG * 8 * NJW;
  int pix1[NM1][2], pix2[NM2][2];
  pixel_offsets(mg, g, pix1, pix2);
  const size_t image = (size_t)C * H * W;
  auto loader = [&](Tile tl) {
    return L{x + tl.b * image, C, H, W, tl.h0, tl.w0, wide != 0};
  };
  if (blockIdx.x < n_tiles) {
    L first = loader(tile_at(blockIdx.x, H, W));
    first.fetch(0, ring);
    first.commit(ring);
  }
  for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
    const Tile tl = tile_at(i, H, W);
    L ld = loader(tl);
    typename Op::Acc acc1[NM1][NJW];
    conv_tile::zero<Op, NM1, NJW>(acc1);
    for (int q = 0; q < NJ; ++q) {
      __syncthreads();  // chunk q is in shared memory; chunk q - 1 (or the output) is done
      if (q + 1 < NJ) ld.fetch((q + 1) * 2 * KR, nullptr);
      conv_tile::conv_taps<Op, NM1, NJW, LDX>(acc1, ring + q % NS * KR * KSX, KSX, pix1,
                                              reinterpret_cast<const float*>(wp1) + q * 72, n0);
      if (q + 1 < NJ) ld.commit(ring + (q + 1) % NS * KR * KSX);
    }
    store_y1<__nv_bfloat16, Op, NJW>(acc1, b1, y1s, C, H, W, tl, mg, n0);
    __syncthreads();  // y1 is stored
    L next = loader(tile_at(i + gridDim.x, H, W));
    if (i + gridDim.x < n_tiles) next.fetch(0, nullptr);
    typename Op::Acc acc2[NM2][NJW];
    conv_tile::zero<Op, NM2, NJW>(acc2);
    for (int q = 0; q < NJ; ++q)
      conv_tile::conv_taps<Op, NM2, NJW, LDY>(acc2, y1s + q * KR * KSY, KSY, pix2,
                                              reinterpret_cast<const float*>(wp2) + q * 72, n0);
    __syncthreads();  // y1 and the ring are consumed
    write_output<__nv_bfloat16, Op, NJW>(acc2, b2, os, x, y, C, H, W, tl, mg, n0, wide != 0);
    __syncthreads();  // the output staging is consumed
    if (i + gridDim.x < n_tiles) next.commit(ring);
  }
}

// One case per count of n-tiles a warp, ceil(C / 16).
#define K3_TILES(X) X(1) X(2) X(3) X(4)

}  // namespace

extern "C" {

const char* fused_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Lets the kernels take the shared memory that C = 64 needs, on the current device.
int fused_block_init() {
  int err = 0;
#define K3_INIT(J)                                                                       \
  if (!err)                                                                              \
    err = (int)cudaFuncSetAttribute((const void*)fused_block_f32<J>,                     \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                                    f32_smem_bytes(J));                                  \
  if (!err)                                                                              \
    err = (int)cudaFuncSetAttribute((const void*)fused_block_bf16<J>,                    \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                                    bf16_smem_bytes(J));
  K3_TILES(K3_INIT)
#undef K3_INIT
  return err;
}

// x, y [B, C, H, W] of type dtype (0 fp32, 1 bf16); w1, w2 [C, C, 3, 3] fp32 with the BN
// scales folded in; b1, b2 [C] fp32.
int fused_block(const void* x, const float* w1, const float* w2, const float* b1,
                const float* b2, void* y, int B, int C, int H, int W, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || C > MAX_C || H <= 0 || W <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nj = (C + 15) / 16;
  // `wide`: 4-pixel groups wholly in or out of the image, x and y aligned to 4 values
  // and w1 and w2 to 16 bytes.
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  const uintptr_t walign = reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2);
  const int wide = W % 4 == 0 && align % (dtype ? 8 : 16) == 0 && walign % 16 == 0;
  if (dtype == 0) {
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
    const size_t bytes = f32_smem_bytes(nj);
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    switch (nj) {
#define K3_F32(J)                                                                        \
  case J:                                                                                \
    fused_block_f32<J><<<grid, NT, bytes, st>>>(xf, w1, w2, b1, b2, yf, C, H, W, wide);   \
    break;
      K3_TILES(K3_F32)
#undef K3_F32
    }
  } else {
    int device = 0, sms = 0;
    int err = (int)cudaGetDevice(&device);
    if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err) return err;
    const int n_tiles = ((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
    const dim3 grid(n_tiles < sms ? n_tiles : sms);
    const size_t bytes = bf16_smem_bytes(nj);
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    switch (nj) {
#define K3_BF16(J)                                                                       \
  case J:                                                                                \
    fused_block_bf16<J><<<grid, NT, bytes, st>>>(xb, w1, w2, b1, b2, yb, C, H, W, wide,   \
                                                  n_tiles);                              \
    break;
      K3_TILES(K3_BF16)
#undef K3_BF16
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
