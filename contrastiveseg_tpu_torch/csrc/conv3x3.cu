// K2: small-channel 3x3 convolution (stride 1, SAME) for Hopper (sm_90a), fp32 and bf16,
// NCHW.
//
// Replaces the Pallas TPU kernels of contrastiveseg_tpu/ops/conv_pallas.py:
//   K2a _conv3x3_kernel    (:55, via conv3x3_small_c :91) -> conv3x3_fwd: y = conv(x, w)
//       as the product of an on-chip im2col [pixels, 9C] and the weights [9C, Co], fp32
//       accumulation; with flip = 1 the weights are read spatially flipped with in/out
//       swapped, which makes the same kernel dX of the forward (_conv3x3_bwd :241-246);
//   K2b _conv3x3_dw_kernel (:141, via _conv3x3_dw :179) -> conv3x3_dw: dW[co][ci][ky][kx]
//       = sum over (batch, pixel) of x[ci][pixel + (ky-1, kx-1)] * g[co][pixel].
// Layouts are the port's own: x, y, g are NCHW, w and dW OIHW [Co, C, 3, 3].
//
// Bound on the H100: at HRNet-W48 branch 0 (B=2, C=Co=48, 128x256) each launch is
// 2*9*C*Co*B*H*W = 2.72 GFLOP against ~25 MB, ~100 flop/byte, so the operations: fp32
// products at their fastest fp32-accurate rate, three TF32 tensor-core products each
// (3xTF32, 495/3 TFLOP/s: 16.5 us), above the bytes (7.5 us at 3.35 TB/s).  Both
// kernels run 3xTF32 mma.sync on the tensor cores.
//
// Design, against the TPU kernels:
//   * halos are masked in the kernel: the tile loaders write zeros outside the image, so
//     there is no padded copy of x (the TPU version pads rows by 7 and 1 and columns to a
//     multiple of 8 for Mosaic's alignment; jnp.pad cost +30 ms/step on the TPU).  Any H
//     and W work, ragged tiles included;
//   * the forward is the implicit GEMM Y[P, Co] = X^[P, 9C] W[9C, Co] on the tile of
//     conv_tile.cuh (shared with K3): pixels are the MMA's row side, output channels its
//     column side (Co = 48 is 6 n-tiles; channels on the row side would pad 48 to 64 in
//     blocks of 16), and A fragments come from haloed x rows in shared memory at the tap's
//     offset.  One block = an 8 x 32 output tile of one image x up to 64 output
//     channels, one warp an output row (2 x 2 ceil(Co / 16) tiles: each A fragment
//     serves every n-tile, so shared-memory loads stay under the products).  Input
//     channels stream 8 at a time with their [Co][8][9] weights through a three-stage
//     cp.async ring (16-byte copies where W % 4 == 0); the weights are read in source
//     order, so flip (dX) is only an index change in that load.  The reduction is 9C
//     long (432 at C = 48), with the hi.hi products in one accumulator and the cross
//     terms in another: the tensor cores' accumulation truncates, and summing all three
//     in one (which would fit two blocks an SM, and ran faster) left the forward several
//     times further from fp64 and the flag-on weight gradients nearer chip_smoke.py's
//     bound;
//   * dW is the GEMM dW[Co, 9C] = G[Co, P] X^[P, 9C] over the P = B*H*W pixels, X^ the
//     im2col of x, as an implicit GEMM on the tensor cores: 3xTF32 mma.sync m16n8k8
//     (x = hi + lo; hi.hi + hi.lo + lo.hi in three accumulators), g the A operand (16
//     output channels x 8 pixels), B read straight from haloed x rows at each tap's
//     offset, so no im2col and no padded x exist in device memory.  A block takes 16
//     output channels and a run of 128-pixel row segments down an image column; x rows
//     sit in a ring of row slots, so a segment loads one new x row and one g row
//     through a two-stage cp.async ring while the previous segment is computed.  The
//     output [16, 9C] is cut into 9*ceil(C/8) MMA tiles over 16 warps (at most 5 a
//     warp: 124 registers at C = 64, no spills).  The hi.hi products are summed one
//     segment at a time and then added in fp32: run over a whole split, the tensor
//     cores' own accumulation drifted from fp64 by 7x (batch 2) to 16x (batch 8)
//     cuDNN's fp32 error on an H100 (tools/bench_k2_variants.py, K2_FLUSH=0);
//   * dW has no ordered grid on this card (the TPU kernel accumulates one VMEM block over
//     a sequential grid): split-K over pixel ranges, sized so that (splits x channel
//     blocks) fills the SMs about once; each block writes a partial [its Co, C, 9], and
//     dw_sum_splits adds the partials in split order: dW is deterministic, with no float
//     atomics.
//
// bf16: the JAX package's arithmetic when a net computes in bf16 (conv_pallas.py:91-134,
// :179-208: bf16 operands and patch scratch, fp32 accumulation, the forward and dX written
// in bf16; dW in fp32, which the VJP rounds to the weights' bf16, :253).  Products of bf16
// values are exact, so the tensor cores take them with no split.  Bound at [8, 48, 128,
// 256]: 10.87 GFLOP (11.0 us at 989 TFLOP/s) against 50.3 MB of bf16 x and y (15.0 us at
// 3.35 TB/s): the bytes.  Two routes:
//   * conv3x3_fwd_bf16_tma / conv3x3_dw_bf16_tma, every shape with W % 8 == 0, C and Co
//     <= 64 and 16-byte aligned tensors (HRNet's branch 0): persistent blocks fed by TMA
//     through an mbarrier ring of x rows, the products on wgmma (m64nNk16, fp32
//     accumulators in registers), warp-specialised (a producer warp, shifter warps,
//     consumer warpgroups).  Design notes at "bf16 on TMA and wgmma" below: how the
//     three tap offsets of a row are built (TMA copies start only on 16-byte
//     boundaries), the forward's weights loaded once a block, dW's taps split over three
//     warpgroups with the tensor cores' sums flushed into fp32 every 64 pixels;
//   * conv3x3_fwd_bf16 / conv3x3_dw_bf16 (PR 16), the other shapes (the ragged widths):
//     the forward and dX are K2a's tile on conv_tile.cuh's Bf16 route, as K3 runs it: an
//     A word holds channels 2t and 2t + 1 of one pixel, which NCHW does not give, so x
//     sits in shared memory as [channel pair][row][column] bf16x2 words, a chunk 16
//     channels (8 pair rows), loaded through registers into two stages; the weights are
//     packed into the default layout (column n, pair k, tap t at n BS + 9 k + t), so
//     flip (dX) is only the index of the load.  dW contracts over pixels with m16n8k16
//     on pixel pairs of g (A) and of x at each tap's offset (B), plain bf16 rows copied
//     by cp.async as they lie in memory; at dx = +-1 a pair straddles a word and is one
//     byte_perm of the two aligned words around it.  The rest is the fp32 kernel's:
//     split-K over row segments through the same x-row ring, the per-segment flush of
//     the MMA accumulator into fp32 totals, fp32 partials and dw_sum_splits in split
//     order (deterministic).
//
// Plain C interface (loaded with ctypes).  conv3x3_init() raises the kernels' dynamic
// shared-memory limits once per device, before the first launch.  Each entry point
// launches on the given stream, does not synchronise and returns cudaGetLastError() (0 on
// success).  Callers allocate every buffer.  The cp.async copies and the TF32 products
// are in tc_common.cuh, shared with K1 and K3.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv_tile.cuh"
#include "hopper.cuh"
#include "tc_common.cuh"

namespace {

// K2a's tile: FW_TH x FW_TW output pixels of one image x up to 64 output channels; one
// warp per output row: two m-tiles of 16 pixels by 2 NJ n-tiles of 8 channels, with the
// hi.hi products and the cross terms in two accumulators (up to 128 registers of them,
// so one block of 8 warps an SM).
constexpr int FW_TH = 8;                   // output rows per block, one a warp
constexpr int FW_TW = 32;                  // output columns per block
constexpr int FW_NT = FW_TH * 32;          // 256 threads
constexpr int FW_X0 = 4;                   // x tile column of pixel w0 (16-byte aligned)
constexpr int FW_LDX = 40;                 // >= FW_X0 + FW_TW + 1, the right halo
constexpr int FW_XR = FW_TH + 2;           // x rows of the tile, with the halo
constexpr int FW_KS = conv_tile::conflict_free_stride(FW_XR * FW_LDX);  // 408 words
constexpr int FW_MAX_NJ = 4;               // 64 output channels a block, at most
constexpr int KR = conv_tile::KROWS;       // input channels per chunk
constexpr int FW_NS = 3;                   // chunks in the cp.async ring

// K2's diagnostic build switches, for tools/bench_k2_variants.py; the port builds the
// defaults.  K2_PRODUCTS: TF32 products per fp32 product in K2a and K2b (3; 1 = hi.hi
// only, TF32 accuracy; 0 = none).  K2_NO_LOADS: skip K2a's chunk loads and K2b's
// segment loads (the products on whatever shared memory holds).  K2_FLUSH=0: K2b's
// hi.hi accumulator runs over the whole split.
#ifndef K2_PRODUCTS
#define K2_PRODUCTS 3
#endif
#ifndef K2_FLUSH
#define K2_FLUSH 1
#endif

// K2a's shared memory: FW_NS stages of [8 channels][FW_KS] x words and [16 nj output
// channels][conv_tile::BS] weights ([8 channels][9 taps] each).
__host__ __device__ constexpr int fw_stage_words(int nj) {
  return KR * FW_KS + 16 * nj * conv_tile::BS;
}
// With flip, a chunk's weights are [8 input channels][fw_flip_ks] (9 x 16 nj words each,
// k rows 8 or 24 mod 32: B loads add 9 g and fw_flip_ks t, distinct mod 32).
__host__ __device__ constexpr int fw_flip_ks(int nj) {
  return conv_tile::conflict_free_stride(9 * 16 * nj);
}
static_assert(KR * fw_flip_ks(4) <= 16 * 4 * conv_tile::BS, "flipped weights fit a stage");
__host__ __device__ constexpr int fw_smem_bytes(int nj) {
  return FW_NS * fw_stage_words(nj) * (int)sizeof(float);
}

constexpr int DW_SW = 128;       // dW: pixels per row segment, 16 MMA k-steps
constexpr int DW_LOG_SW = 7;
constexpr int DW_CO = 16;        // dW: output channels per block, the MMA's row side
constexpr int DW_WARPS = 16;     // dW: warps per block
constexpr int DW_UNROLL = 8;     // dW: k-steps unrolled
constexpr int DW_MAX_C = 64;     // dW: input channels, at most (8 MMA column blocks a tap)
constexpr int DW_X0 = 4;         // dW: x tile column of pixel w0 (16-byte aligned)
// Row strides of dW's x and g tiles, in words: DW_LDX = 12 and DW_LDG = 4 mod 32, so
// the B fragment loads (8 channel rows x 4 pixels) and the A fragment loads (8 output
// channel rows x 4 pixels) hit 32 distinct banks.
constexpr int DW_LDX = DW_SW + 12;  // >= DW_X0 + DW_SW + 1, the right halo
constexpr int DW_LDG = DW_SW + 4;
constexpr int DW_STAGES = 2;     // dW: segments in the cp.async ring
constexpr int DW_SLOTS = 3 * DW_STAGES;   // dW: x row slots, enough for every segment's 3

// dW's shared memory for 8 ncb input channels: DW_SLOTS x rows of [8 ncb][DW_LDX], then
// DW_STAGES g tiles of [DW_CO][DW_LDG]; 231,936 bytes at ncb = 8, within the 232,448 a
// block may take.
__host__ __device__ constexpr int dw_smem_bytes(int ncb) {
  return (DW_SLOTS * 8 * ncb * DW_LDX + DW_STAGES * DW_CO * DW_LDG) * (int)sizeof(float);
}

// Copies chunk c0 (input channels [c0, c0 + 8)) of K2a's operands into stage st with
// cp.async: x rows h0 - 1 .. h0 + FW_TH, columns w0 - 1 .. w0 + FW_TW, as [channel][row]
// [FW_X0 - 1 + column]; and the weights of those channels for output channels [co0,
// co0 + 16 NJ), each run of them that is contiguous in w kept contiguous: without FLIP
// (w[o][i][t]) output channel n's 72 words, at n BS + 9 k + t; with FLIP (w[i][o][8 - t],
// dX) input channel k's 9 x 16 NJ words, at k fw_flip_ks + 9 n + (8 - t).  Everything
// outside the image, past C or past Co is zero-filled, so no padded copy of x exists.
// VEC (W % 4 == 0, x and w 16-byte aligned): 16-byte copies of the x body, a 4-pixel
// group wholly in or out, and of whole weight runs; else 4-byte.
template <int NJ, bool VEC, bool FLIP>
__device__ __forceinline__ void fwd_load(float* st, const float* __restrict__ x,
                                         const float* __restrict__ w, int C, int Co, int H,
                                         int W, int b, int h0, int w0, int co0, int c0) {
#ifdef K2_NO_LOADS
  return;
#endif
  constexpr int COB = 16 * NJ, PER = VEC ? FW_TW / 4 : FW_TW;
  const int tid = conv_tile::opaque_tid();
  const float* xb = x + (size_t)b * C * H * W;
  for (int i = tid; i < KR * FW_XR * PER; i += FW_NT) {
    const int k = i / (FW_XR * PER), r = i / PER % FW_XR, q = i % PER * (VEC ? 4 : 1);
    const int ci = c0 + k, gh = h0 - 1 + r, gw = w0 + q;
    const bool ok = ci < C && gh >= 0 && gh < H && gw < W;
    const float* src = ok ? xb + ((size_t)ci * H + gh) * W + gw : x;
    float* dst = st + k * FW_KS + r * FW_LDX + FW_X0 + q;
    if (VEC) cp_async16(dst, src, ok ? 16 : 0);
    else cp_async4(dst, src, ok ? 4 : 0);
  }
  for (int i = tid; i < KR * FW_XR * 2; i += FW_NT) {  // the halo columns
    const int k = i / (2 * FW_XR), r = i / 2 % FW_XR, right = i & 1;
    const int ci = c0 + k, gh = h0 - 1 + r, gw = right ? w0 + FW_TW : w0 - 1;
    const bool ok = ci < C && gh >= 0 && gh < H && gw >= 0 && gw < W;
    const float* src = ok ? xb + ((size_t)ci * H + gh) * W + gw : x;
    cp_async4(st + k * FW_KS + r * FW_LDX + (right ? FW_X0 + FW_TW : FW_X0 - 1), src,
              ok ? 4 : 0);
  }
  float* ws = st + KR * FW_KS;
  // Run u (an output channel, or with FLIP an input channel) of RUN words: its source,
  // destination and how many of its words exist.
  constexpr int RUNS = FLIP ? KR : COB, RUN = FLIP ? 9 * COB : 9 * KR;
  constexpr int DST = FLIP ? fw_flip_ks(NJ) : conv_tile::BS;
  auto src = [&](int u) {
    return FLIP ? w + ((size_t)(c0 + u) * Co + co0) * 9 : w + ((size_t)(co0 + u) * C + c0) * 9;
  };
  auto valid = [&](int u) {  // words of run u inside w
    const int runs_ok = FLIP ? c0 + u < C : co0 + u < Co;
    const int left = FLIP ? Co - co0 : C - c0;
    return runs_ok ? 9 * (left < RUN / 9 ? left : RUN / 9) : 0;
  };
  const int whole = FLIP ? Co % 4 == 0 && co0 + COB <= Co : C % 4 == 0 && c0 + KR <= C;
  if (VEC && whole) {
    for (int i = tid; i < RUNS * RUN / 4; i += FW_NT) {
      const int u = i / (RUN / 4), r = i % (RUN / 4) * 4;
      const bool ok = valid(u) > 0;
      cp_async16(ws + u * DST + r, ok ? src(u) + r : w, ok ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < RUNS * RUN; i += FW_NT) {
    const int u = i / RUN, r = i % RUN;
    const bool ok = r < valid(u);
    cp_async4(ws + u * DST + r, ok ? src(u) + r : w, ok ? 4 : 0);
  }
}

// K2a as an implicit GEMM on the tensor cores: y[p, co] = sum over (tap, ci) of
// x^[p, (tap, ci)] w[(tap, ci), co], x^ the im2col of x, never formed (conv_tile.cuh).
// Block (column tile, row tile, image x output-channel block) computes FW_TH x FW_TW
// pixels x 16 NJ output channels; the input channels stream through a three-stage
// cp.async ring 8 at a time (two chunks in flight while one is computed), with the
// chunk's weights.  Warp r holds output row r: 2 x 2 NJ tiles of 16 pixels x 8 channels.
// No split-K: each output is one block's sum, in one order, so K2a is deterministic.
template <int NJ, bool VEC, bool FLIP>
__global__ void __launch_bounds__(FW_NT, 1)
conv3x3_fwd_tc(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
               int C, int Co, int H, int W, int n_co_blocks) {
  // B at column n, channel k, tap t: without FLIP n BS + 9 k + t; with FLIP the taps are
  // stored reversed, k fw_flip_ks + 9 n + 8 - t.
  using Op = std::conditional_t<
      FLIP, conv_tile::Tf32x3<K2_PRODUCTS, 2, 9, fw_flip_ks(NJ), -1>,
      conv_tile::Tf32x3<K2_PRODUCTS, 2, conv_tile::BS, 9, 1>>;
  constexpr int STAGE = fw_stage_words(NJ), NJW = 2 * NJ;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w0 = blockIdx.x * FW_TW, h0 = blockIdx.y * FW_TH;
  const int b = blockIdx.z / n_co_blocks, co0 = blockIdx.z % n_co_blocks * 16 * NJ;

  int pix[2][2];  // pixel (warp, 16 m + 8 h + g) at tap (0, 0): x tile row warp, column - 1
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) pix[m][h] = warp * FW_LDX + FW_X0 - 1 + 16 * m + 8 * h + g;
  typename Op::Acc acc[2][NJW];
  conv_tile::zero<Op, 2, NJW>(acc);

  const int nc = (C + KR - 1) / KR;
#pragma unroll
  for (int c = 0; c < FW_NS - 1; ++c) {
    if (c < nc)
      fwd_load<NJ, VEC, FLIP>(smem + c * STAGE, x, w, C, Co, H, W, b, h0, w0, co0, c * KR);
    cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<FW_NS - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1 is consumed
    const int cn = c + FW_NS - 1;
    if (cn < nc)
      fwd_load<NJ, VEC, FLIP>(smem + cn % FW_NS * STAGE, x, w, C, Co, H, W, b, h0, w0, co0,
                              cn * KR);
    cp_async_commit();
    const unsigned* st = reinterpret_cast<const unsigned*>(smem + c % FW_NS * STAGE);
    const float* ws = reinterpret_cast<const float*>(st) + KR * FW_KS + (FLIP ? 8 : 0);
    conv_tile::conv_taps<Op, 2, NJW, FW_LDX>(acc, st, FW_KS, pix, ws, 0);
  }

  const int gh = h0 + warp;
  if (gh >= H) return;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NJW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gw = w0 + 16 * m + 8 * (q >> 1) + g, co = co0 + 8 * j + 2 * t + (q & 1);
        if (gw < W && co < Co)
          y[(((size_t)b * Co + co) * H + gh) * W + gw] = Op::value(acc[m][j], q);
      }
}

// dW's row segments in order u = (b * nwc + wc) * H + h: DW_SW pixels [w0, w0 + DW_SW)
// of image row h, w0 = DW_SW wc.  A split walks down image columns, so segment u shares the x
// rows h - 1 and h with segment u - 1.  The x rows live in a ring of DW_SLOTS row slots:
// segment u's rows h - 1, h, h + 1 are the virtual rows vb(u) .. vb(u) + 2, in slot
// (virtual row) % DW_SLOTS, where vb advances by 1 a segment and by 3 where a new column
// starts.  Loading DW_STAGES - 1 segments ahead touches at most 3 DW_STAGES virtual rows
// past the segment being computed, so no slot in use is overwritten.
//
// load(u) copies with cp.async what segment u adds: x row h + 1 (all three rows at the
// split's first segment and at a column's first), each over columns [w0 - 1, w0 + DW_SW]
// for the 8 NCB channels, and g row h of the block's 16 output channels into g stage
// (u - u0) % DW_STAGES.  Everything outside the image, past C or past Co is zero-filled,
// so no padded copy of x exists.  16-byte copies where W % 4 == 0 and x and g are 16-byte
// aligned (a 4-pixel group is then wholly inside or outside the image), else 4-byte.
template <int NCB>
struct SegmentLoader {
  static constexpr int CH = 8 * NCB, SLOT = CH * DW_LDX;
  const float* x;
  const float* g;
  float* xring;
  float* gring;
  int C, Co, H, W, nwc, co0, u0, shift;  // 2^shift copies per row

  __device__ int vbase(int u) const { return u - u0 + 2 * (u / H - u0 / H); }

  __device__ void load(int u) const {
#ifdef K2_NO_LOADS
    return;
#endif
    const int col = u / H, h = u - col * H, b = col / nwc, w0 = (col - b * nwc) * DW_SW;
    const int first = (u == u0 || h == 0) ? 0 : 2, vb = vbase(u);
    const int xrows = (3 - first) * CH;
    const int width = DW_SW >> shift, per = 1 << shift;
    float* gs = gring + (u - u0) % DW_STAGES * DW_CO * DW_LDG;
    for (int i = threadIdx.x; i < (xrows + DW_CO) << shift; i += blockDim.x) {
      const int r = i >> shift, w = w0 + (i & (per - 1)) * width;
      const float* src = x;
      float* dst;
      bool ok;
      if (r < xrows) {
        const int k = r / CH, ci = r - k * CH, ky = first + k, gh = h + ky - 1;
        ok = ci < C && gh >= 0 && gh < H && w < W;
        if (ok) src = x + (((size_t)b * C + ci) * H + gh) * W + w;
        dst = xring + (vb + ky) % DW_SLOTS * SLOT + ci * DW_LDX + DW_X0 + (w - w0);
      } else {
        const int co = co0 + r - xrows;
        ok = co < Co && w < W;
        if (ok) src = g + (((size_t)b * Co + co) * H + h) * W + w;
        dst = gs + (r - xrows) * DW_LDG + (w - w0);
      }
      if (width == 4) cp_async16(dst, src, ok ? 16 : 0);
      else cp_async4(dst, src, ok ? 4 : 0);
    }
    for (int i = threadIdx.x; i < 2 * xrows; i += blockDim.x) {  // the halo columns
      const int r = i >> 1, k = r / CH, ci = r - k * CH, ky = first + k, gh = h + ky - 1;
      const int w = (i & 1) ? w0 + DW_SW : w0 - 1;
      const bool ok = ci < C && gh >= 0 && gh < H && w >= 0 && w < W;
      const float* src = ok ? x + (((size_t)b * C + ci) * H + gh) * W + w : x;
      cp_async4(xring + (vb + ky) % DW_SLOTS * SLOT + ci * DW_LDX + DW_X0 + (w - w0), src,
                ok ? 4 : 0);
    }
  }
};

// K2b as an implicit GEMM on the tensor cores: dW[co, (ky, kx, ci)] =
// sum_p g[co, p] x^[p, (ky, kx, ci)] with x^ the im2col of x, never formed:
// B fragments are read from the haloed x rows at the tap's offset.  Block (split s,
// output channels [16 y, 16 y + 16)) sums the row segments [s ups, (s + 1) ups) through
// a ring of DW_STAGES cp.async stages (the next segment in flight while one is
// computed).  Its output [16, 9 C] is 9 NCB MMA tiles of 16 x 8 (one tap, 8 input
// channels each); tile i goes to warp i % DW_WARPS, so a warp holds at most NJ tiles, in
// 3xTF32 with the three products in separate accumulators.  The hi.hi accumulator runs
// over one segment (DW_SW pixels) and is then added to an fp32 total: the tensor cores' own
// accumulation, run over a whole split, strays from fp32 sums by an error that grows
// with the chain.  The block writes its partial [Co rows of its own, C, 9] of split s.
template <int NCB>
__global__ void __launch_bounds__(DW_WARPS * 32, 1)
conv3x3_dw_tc(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ part,
              int B, int C, int Co, int H, int W, int units_per_split, int vec) {
  using Loader = SegmentLoader<NCB>;
  constexpr int NTILE = 9 * NCB, NJ = (NTILE + DW_WARPS - 1) / DW_WARPS, NS = DW_STAGES;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int s = blockIdx.x, co0 = blockIdx.y * DW_CO;
  const int n_units = B * H * ((W + DW_SW - 1) / DW_SW);
  const int u0 = s * units_per_split, u1 = min(n_units, u0 + units_per_split);
  float* gring = smem + DW_SLOTS * Loader::SLOT;
  const Loader loader{x, g, smem, gring, C, Co, H, W, (W + DW_SW - 1) / DW_SW, co0, u0,
                      vec ? DW_LOG_SW - 2 : DW_LOG_SW};

  // Tile j of this warp: tap (ky, kx) and input-channel block cb; its B fragment (k =
  // pixel t or t + 4, n = channel gq) starts at xoff[j] in the slot of x row ky.
  int xoff[NJ], kyj[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int i = min(j * DW_WARPS + warp, NTILE - 1), tap = i / NCB, cb = i - tap * NCB;
    kyj[j] = tap / 3;
    xoff[j] = (8 * cb + gq) * DW_LDX + DW_X0 - 1 + tap - 3 * kyj[j] + t;
  }
  const int nj = (NTILE - warp + DW_WARPS - 1) / DW_WARPS;
  float tot[NJ][4], hl[NJ][4], lh[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) tot[j][q] = hl[j][q] = lh[j][q] = 0.f;

#pragma unroll
  for (int k = 0; k < NS - 1; ++k) {
    if (u0 + k < u1) loader.load(u0 + k);
    cp_async_commit();
  }
  for (int u = u0; u < u1; ++u) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // segment u has landed; segment u - 1 is consumed
    if (u + NS - 1 < u1) loader.load(u + NS - 1);
    cp_async_commit();
    const int vb = loader.vbase(u) % DW_SLOTS;
    int xb[NJ];  // tile j's B fragments at smem[xb[j] + k0], smem[xb[j] + k0 + 4]
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int slot = vb + kyj[j];
      xb[j] = (slot < DW_SLOTS ? slot : slot - DW_SLOTS) * Loader::SLOT + xoff[j];
    }
    const float* gr = gring + (u - u0) % NS * DW_CO * DW_LDG + gq * DW_LDG + t;
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll DW_UNROLL
    for (int k0 = 0; k0 < DW_SW; k0 += 8) {
      unsigned ah[4], al[4];
      split_tf32(gr[k0], ah[0], al[0]);
      split_tf32(gr[k0 + 8 * DW_LDG], ah[1], al[1]);
      split_tf32(gr[k0 + 4], ah[2], al[2]);
      split_tf32(gr[k0 + 8 * DW_LDG + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          unsigned bh[2], bl[2];
          split_tf32(smem[xb[j] + k0], bh[0], bl[0]);
          split_tf32(smem[xb[j] + k0 + 4], bh[1], bl[1]);
          if (K2_PRODUCTS >= 3) {
            mma_tf32(lh[j], al, bh[0], bh[1]);
            mma_tf32(hl[j], ah, bl[0], bl[1]);
          }
          if (K2_PRODUCTS >= 1) mma_tf32(K2_FLUSH ? acc[j] : tot[j], ah, bh[0], bh[1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) tot[j][q] += acc[j][q];
  }

  float* dst = part + (size_t)s * Co * C * 9;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j >= nj) continue;
    const int i = j * DW_WARPS + warp, tap = i / NCB, cb = i - tap * NCB;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + gq + 8 * h;
      if (co >= Co) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ci = 8 * cb + 2 * t + e;
        if (ci < C)
          dst[((size_t)co * C + ci) * 9 + tap] =
              tot[j][2 * h + e] + (hl[j][2 * h + e] + lh[j][2 * h + e]);
      }
    }
  }
}

// ---- bf16 ----

// K2a-bf16: a chunk is 16 input channels, 8 k rows of channel pairs; its x tile holds
// pixel pairs of FW_XR rows x 18 pairs (columns w0 - 2 .. w0 + 33), so FW_B_XP pairs a
// thread.  Two stages, each fw_stage_words(nj) words as in fp32.
constexpr int FW_B_NS = 2;
constexpr int FW_B_PAIRS = KR * FW_XR * 18;
constexpr int FW_B_XP = (FW_B_PAIRS + FW_NT - 1) / FW_NT;
__host__ __device__ constexpr int fw_b_smem_bytes(int nj) {
  return FW_B_NS * fw_stage_words(nj) * (int)sizeof(float);
}

// Fetches chunk c0 (input channels [c0, c0 + 16)) of K2a-bf16's operands into registers
// and commits them, packed as bf16x2, to a stage: x pair row k (channels c0 + 2k, + 1) at
// st + k FW_KS + row FW_LDX + FW_X0 + column (columns -2 .. 33 of the tile), and the
// weights of output channel co0 + n at ws[n BS + 9 k + tap] (with flip, w[ci][co][8 - tap]:
// dX).  Zero outside the image, past C and past Co.  wide (W even, x 4-byte aligned):
// one 4-byte load a pixel pair and channel, a pair wholly inside or outside the image.
// wide and flip are uniform over the grid: run-time branches, not template cases.
template <int NJ>
struct Bf16ChunkLoader {
  static constexpr int WW = 16 * NJ * 72, WP = (WW + FW_NT - 1) / FW_NT;
  const unsigned short* x;  // image b
  const unsigned short* w;
  int C, Co, H, W, h0, w0, co0;
  bool wide, flip;
  unsigned rx[2 * FW_B_XP], rw[WP];

  __device__ void fetch(int c0) {
#ifdef K2_NO_LOADS
    return;
#endif
    const int tid = conv_tile::opaque_tid();
    const size_t plane = (size_t)H * W;
#pragma unroll
    for (int s = 0; s < FW_B_XP; ++s) {
      const int i = tid + s * FW_NT;
      if (i >= FW_B_PAIRS) break;
      const int k = i / (FW_XR * 18), r = i / 18 % FW_XR, c = i % 18 * 2 - 2;
      const int gh = h0 - 1 + r, gw = w0 + c, ci = c0 + 2 * k;
      const bool row = gh >= 0 && gh < H, c0ok = ci < C, c1ok = ci + 1 < C;
      const size_t at = ci * plane + (size_t)gh * W + gw;
      unsigned lo, hi;  // channels ci and ci + 1 at pixels gw (low half) and gw + 1
      if (wide) {
        const bool in = row && gw >= 0 && gw < W;
        lo = in && c0ok ? *reinterpret_cast<const unsigned*>(x + at) : 0u;
        hi = in && c1ok ? *reinterpret_cast<const unsigned*>(x + at + plane) : 0u;
      } else {
        const bool in0 = row && gw >= 0 && gw < W, in1 = row && gw + 1 >= 0 && gw + 1 < W;
        lo = (in0 && c0ok ? x[at] : 0u) | (in1 && c0ok ? (unsigned)x[at + 1] << 16 : 0u);
        hi = (in0 && c1ok ? x[at + plane] : 0u) |
             (in1 && c1ok ? (unsigned)x[at + plane + 1] << 16 : 0u);
      }
      rx[2 * s] = __byte_perm(lo, hi, 0x5410);
      rx[2 * s + 1] = __byte_perm(lo, hi, 0x7632);
    }
#pragma unroll
    for (int s = 0; s < WP; ++s) {
      const int i = tid + s * FW_NT;
      if (i >= WW) break;
      const int n = i / 72, r = i % 72, kp = r / 9, t = r % 9;
      const int co = co0 + n, ci = c0 + 2 * kp;
      unsigned lo = 0u, hi = 0u;
      if (co < Co) {
        if (flip) {
          if (ci < C) lo = w[((size_t)ci * Co + co) * 9 + 8 - t];
          if (ci + 1 < C) hi = w[((size_t)(ci + 1) * Co + co) * 9 + 8 - t];
        } else {
          if (ci < C) lo = w[((size_t)co * C + ci) * 9 + t];
          if (ci + 1 < C) hi = w[((size_t)co * C + ci + 1) * 9 + t];
        }
      }
      rw[s] = lo | hi << 16;
    }
  }

  __device__ void commit(unsigned* st) const {
#ifdef K2_NO_LOADS
    return;
#endif
    const int tid = conv_tile::opaque_tid();
#pragma unroll
    for (int s = 0; s < FW_B_XP; ++s) {
      const int i = tid + s * FW_NT;
      if (i >= FW_B_PAIRS) break;
      unsigned* dst = st + i / (FW_XR * 18) * FW_KS + i / 18 % FW_XR * FW_LDX + FW_X0 +
                      i % 18 * 2 - 2;
      dst[0] = rx[2 * s];
      dst[1] = rx[2 * s + 1];
    }
    unsigned* ws = st + KR * FW_KS;
#pragma unroll
    for (int s = 0; s < WP; ++s) {
      const int i = tid + s * FW_NT;
      if (i >= WW) break;
      ws[i / 72 * conv_tile::BS + i % 72] = rw[s];
    }
  }
};

// K2a-bf16: K2a's tile and grid (FW_TH x FW_TW pixels x 16 NJ output channels a block,
// warp r on output row r) on the Bf16 route, input channels 16 at a time through two
// register-staged stages: chunk c + 1 is fetched into registers before chunk c's products
// and stored after them.  fp32 sums, rounded once to bf16 at the store.
template <int NJ>
__global__ void __launch_bounds__(FW_NT, 1)
conv3x3_fwd_bf16_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, int C, int Co, int H, int W,
                    int n_co_blocks, int wide, int flip) {
  using Op = conv_tile::Bf16<K2_PRODUCTS, conv_tile::BS>;
  constexpr int STAGE = fw_stage_words(NJ), NJW = 2 * NJ;
  extern __shared__ __align__(16) float smem[];
  unsigned* stages = reinterpret_cast<unsigned*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w0 = blockIdx.x * FW_TW, h0 = blockIdx.y * FW_TH;
  const int b = blockIdx.z / n_co_blocks, co0 = blockIdx.z % n_co_blocks * 16 * NJ;

  int pix[2][2];  // pixel (warp, 16 m + 8 h + g) at tap (0, 0): x tile row warp, column - 1
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) pix[m][h] = warp * FW_LDX + FW_X0 - 1 + 16 * m + 8 * h + g;
  typename Op::Acc acc[2][NJW];
  conv_tile::zero<Op, 2, NJW>(acc);

  Bf16ChunkLoader<NJ> ld{
      reinterpret_cast<const unsigned short*>(x) + (size_t)b * C * H * W,
      reinterpret_cast<const unsigned short*>(w), C, Co, H, W, h0, w0, co0, wide != 0,
      flip != 0};
  const int nc = (C + 2 * KR - 1) / (2 * KR);
  ld.fetch(0);
  ld.commit(stages);
  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // chunk c is stored; chunk c - 1 is consumed
    if (c + 1 < nc) ld.fetch((c + 1) * 2 * KR);
    const unsigned* st = stages + c % FW_B_NS * STAGE;
    conv_tile::conv_taps<Op, 2, NJW, FW_LDX>(acc, st, FW_KS, pix,
                                              reinterpret_cast<const float*>(st) + KR * FW_KS,
                                              0);
    if (c + 1 < nc) ld.commit(stages + (c + 1) % FW_B_NS * STAGE);
  }

  const int gh = h0 + warp;
  if (gh >= H) return;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NJW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gw = w0 + 16 * m + 8 * (q >> 1) + g, co = co0 + 8 * j + 2 * t + (q & 1);
        if (gw < W && co < Co)
          y[(((size_t)b * Co + co) * H + gh) * W + gw] = __float2bfloat16(Op::value(acc[m][j], q));
      }
}

// K2b-bf16's tiles, as bf16 rows: an x channel row holds pixel w0 + q at element
// DWB_X0 + q (elements 0 .. 143: pixels w0 - 8 .. w0 + 135, 18 16-byte groups); a g row
// holds pixel w0 + q at element q.  Row strides in 32-bit words, DWB_LDX = 12 and DWB_LDG
// = 4 mod 32, so the B loads (8 channel rows x 4 words) and the A loads (8 output channel
// rows x 4 words) hit 32 distinct banks; each row starts 16-byte aligned.
constexpr int DWB_X0 = 8;
constexpr int DWB_LDX = 76;
constexpr int DWB_LDG = 68;
__host__ __device__ constexpr int dw_b_smem_bytes(int ncb) {
  return (DW_SLOTS * 8 * ncb * DWB_LDX + DW_STAGES * DW_CO * DWB_LDG) * (int)sizeof(float);
}

// SegmentLoader's ring and segment order, on bf16 rows.  vec (W % 8 == 0, x and g
// 16-byte aligned): 16-byte cp.async copies of 8 pixels, a group wholly inside or
// outside the image; else 2-byte loads and stores of the pixels the products read
// (cp.async copies 4 bytes at least).
template <int NCB>
struct Bf16SegmentLoader {
  static constexpr int CH = 8 * NCB, SLOT = CH * DWB_LDX;  // words
  const unsigned short* x;
  const unsigned short* g;
  unsigned* xring;
  unsigned* gring;
  int C, Co, H, W, nwc, co0, u0;
  bool vec;

  __device__ int vbase(int u) const { return u - u0 + 2 * (u / H - u0 / H); }

  __device__ void load(int u) const {
#ifdef K2_NO_LOADS
    return;
#endif
    const int col = u / H, h = u - col * H, b = col / nwc, w0 = (col - b * nwc) * DW_SW;
    const int first = (u == u0 || h == 0) ? 0 : 2, vb = vbase(u);
    const int xrows = (3 - first) * CH;
    unsigned* gs = gring + (u - u0) % DW_STAGES * DW_CO * DWB_LDG;
    auto xrow = [&](int r, int& ci, int& gh) {  // x row r of this load: its slot row
      const int k = r / CH, ky = first + k;
      ci = r - k * CH;
      gh = h + ky - 1;
      return xring + (vb + ky) % DW_SLOTS * SLOT + ci * DWB_LDX;
    };
    if (vec) {
      for (int i = threadIdx.x; i < xrows * 18 + DW_CO * 16; i += blockDim.x) {
        const unsigned short* src = x;
        unsigned* dst;
        bool ok;
        if (i < xrows * 18) {
          const int r = i / 18, q = i - r * 18, pw = w0 - 8 + 8 * q;
          int ci, gh;
          dst = xrow(r, ci, gh) + 4 * q;
          ok = ci < C && gh >= 0 && gh < H && pw >= 0 && pw < W;
          if (ok) src = x + (((size_t)b * C + ci) * H + gh) * W + pw;
        } else {
          const int j = i - xrows * 18, r = j >> 4, q = j & 15, co = co0 + r, pw = w0 + 8 * q;
          dst = gs + r * DWB_LDG + 4 * q;
          ok = co < Co && pw < W;
          if (ok) src = g + (((size_t)b * Co + co) * H + h) * W + pw;
        }
        cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src),
                   ok ? 16 : 0);
      }
      return;
    }
    constexpr int XW = DW_SW + 2;  // x pixels w0 - 1 .. w0 + DW_SW
    for (int i = threadIdx.x; i < xrows * XW + DW_CO * DW_SW; i += blockDim.x) {
      unsigned short v = 0;
      unsigned short* dst;
      if (i < xrows * XW) {
        const int r = i / XW, q = i - r * XW - 1, pw = w0 + q;
        int ci, gh;
        dst = reinterpret_cast<unsigned short*>(xrow(r, ci, gh)) + DWB_X0 + q;
        if (ci < C && gh >= 0 && gh < H && pw >= 0 && pw < W)
          v = x[(((size_t)b * C + ci) * H + gh) * W + pw];
      } else {
        const int j = i - xrows * XW, r = j / DW_SW, q = j - r * DW_SW, co = co0 + r;
        dst = reinterpret_cast<unsigned short*>(gs + r * DWB_LDG) + q;
        if (co < Co && w0 + q < W) v = g[(((size_t)b * Co + co) * H + h) * W + w0 + q];
      }
      *dst = v;
    }
  }
};

// K2b-bf16: K2b's blocks, splits and tiles (16 output channels x 8 input channels at one
// tap an MMA tile, 9 NCB of them over 16 warps) on m16n8k16 bf16, a k-step 16 pixels.
// A word (output channel, pixels 2t, 2t + 1) is one aligned read of the g row; B word
// (pixels 2t + dx, + 1; input channel) is one aligned read of the x row at dx = 0 and the
// byte_perm of its two aligned neighbours at dx = -1 and +1.  The MMA accumulator runs
// over one segment and is then added to fp32 totals, as in fp32.
template <int NCB>
__global__ void __launch_bounds__(DW_WARPS * 32, 1)
conv3x3_dw_bf16_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                   float* __restrict__ part, int B, int C, int Co, int H, int W,
                   int units_per_split, int vec) {
  using Loader = Bf16SegmentLoader<NCB>;
  constexpr int NTILE = 9 * NCB, NJ = (NTILE + DW_WARPS - 1) / DW_WARPS, NS = DW_STAGES;
  extern __shared__ __align__(16) float smem[];
  unsigned* xring = reinterpret_cast<unsigned*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int s = blockIdx.x, co0 = blockIdx.y * DW_CO;
  const int n_units = B * H * ((W + DW_SW - 1) / DW_SW);
  const int u0 = s * units_per_split, u1 = min(n_units, u0 + units_per_split);
  unsigned* gring = xring + DW_SLOTS * Loader::SLOT;
  const Loader loader{reinterpret_cast<const unsigned short*>(x),
                      reinterpret_cast<const unsigned short*>(g), xring, gring, C, Co, H, W,
                      (W + DW_SW - 1) / DW_SW, co0, u0, vec != 0};

  // Tile j of this warp: tap (ky, kx) and input-channel block cb; lane (gq, t) reads the
  // word of pixels 2t, 2t + 1 of channel 8 cb + gq at xoff[j] in the slot of x row ky.
  int xoff[NJ], kyj[NJ], kxj[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int i = min(j * DW_WARPS + warp, NTILE - 1), tap = i / NCB, cb = i - tap * NCB;
    kyj[j] = tap / 3;
    kxj[j] = tap - 3 * kyj[j];
    xoff[j] = (8 * cb + gq) * DWB_LDX + DWB_X0 / 2 + t;
  }
  const int nj = (NTILE - warp + DW_WARPS - 1) / DW_WARPS;
  float tot[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) tot[j][q] = 0.f;

#pragma unroll
  for (int k = 0; k < NS - 1; ++k) {
    if (u0 + k < u1) loader.load(u0 + k);
    cp_async_commit();
  }
  for (int u = u0; u < u1; ++u) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // segment u has landed; segment u - 1 is consumed
    if (u + NS - 1 < u1) loader.load(u + NS - 1);
    cp_async_commit();
    const int vb = loader.vbase(u) % DW_SLOTS;
    int xb[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int slot = vb + kyj[j];
      xb[j] = (slot < DW_SLOTS ? slot : slot - DW_SLOTS) * Loader::SLOT + xoff[j];
    }
    const unsigned* gr = gring + (u - u0) % NS * DW_CO * DWB_LDG + gq * DWB_LDG + t;
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll
    for (int kw = 0; kw < DW_SW / 2; kw += 8) {  // 16 pixels, 8 words, a k-step
      const unsigned a[4] = {gr[kw], gr[kw + 8 * DWB_LDG], gr[kw + 4],
                             gr[kw + 8 * DWB_LDG + 4]};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const unsigned* p = xring + xb[j] + kw;
          unsigned b0, b1;
          if (kxj[j] == 1) {
            b0 = p[0];
            b1 = p[4];
          } else {  // dx = -1: words -1 and 0; dx = +1: words 0 and 1
            const int o = kxj[j] >> 1;
            b0 = __byte_perm(p[o - 1], p[o], 0x5432);
            b1 = __byte_perm(p[o + 3], p[o + 4], 0x5432);
          }
          if (K2_PRODUCTS >= 1) mma_bf16(K2_FLUSH ? acc[j] : tot[j], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) tot[j][q] += acc[j][q];
  }

  float* dst = part + (size_t)s * Co * C * 9;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j >= nj) continue;
    const int i = j * DW_WARPS + warp, tap = i / NCB, cb = i - tap * NCB;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + gq + 8 * h;
      if (co >= Co) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ci = 8 * cb + 2 * t + e;
        if (ci < C) dst[((size_t)co * C + ci) * 9 + tap] = tot[j][2 * h + e];
      }
    }
  }
}

// ---- bf16 on TMA and wgmma: the route of every shape with W % 8 == 0, C <= 64, Co <= 64
// and 16-byte aligned tensors (HRNet's branch 0 among them) ----
//
// A "tile" is one row segment of TB_W = 64 pixels of up to 64 channels (of x, g or y) in
// the layout of a TMA copy with the 128-byte swizzle: a 128-byte row per channel
// (hopper.cuh, SW128).  Both kernels are persistent (at most one block an SM) and walk
// down image columns: the row segments u = (b * nwc + wc) * H + h in order, block s
// taking [s ups, (s + 1) ups).  x rows arrive in a ring of row slots.  A slot holds one x
// row at the three column offsets of the taps, w0 - 1, w0 and w0 + 1, as three tiles, so
// that every tap's operand starts on a 16-byte boundary, as wgmma's descriptors need.
// TMA cannot write them: a copy's innermost coordinate must be a multiple of 16 bytes (8
// pixels; the card refuses an odd one as an illegal instruction).  So the producer warp
// copies the row at w0 (the middle tile) and 8 pixels on each side (halo boxes at w0 - 8
// and w0 + 64, unswizzled), and shifter warps build the two outer tiles from them in
// shared memory, a 2-byte funnel shift of each 128-byte channel row.  The image's halo
// (left, right, above, below) and the channel tail past C are TMA's zero fill (a 4-D map,
// so the tail does not read the next image).  A segment loads one new x row (three at a
// column's start): x is read once from device memory, and once more for each column a
// block starts.
constexpr int TB_W = 64;             // pixels of a row segment: wgmma's M, one 128-byte row
constexpr int TB_ROW = 2 * TB_W;     // bytes of a tile's channel row
constexpr int TB_HALO = 8;           // pixels of a halo box (16 bytes, TMA's least)
constexpr int TB_SMEM = 232448;      // dynamic shared memory a block may take
constexpr int TB_MAX_SLOTS = 8;      // x row slots, at most
constexpr int TF_SHIFTERS = 3;       // forward: shifter warps
constexpr int TF_THREADS = 288 + 32 * TF_SHIFTERS;  // two consumer warpgroups, producer, shifters
constexpr int TD_SHIFTERS = 2;       // dW: shifter warps
constexpr int TD_THREADS = 416 + 32 * TD_SHIFTERS;  // three consumer warpgroups, producer, shifters
constexpr int TD_G_STAGES = 4;       // dW: g tiles in flight
constexpr int TD_G_TILE = 64 * TB_ROW;  // dW: a g tile, 64 output channels (wgmma's M)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A row slot of cp channels: the tiles at kx = 0, 1, 2, then the left and right halo
// boxes ([cp][8 pixels] each); 1024-byte aligned, as the swizzle needs.
__host__ __device__ constexpr int slot_bytes(int cp) {
  return cdiv(3 * cp * TB_ROW + 2 * cp * 2 * TB_HALO, 1024) * 1024;
}

// The ring of x rows shared by both kernels: load event v (the v-th x row a block loads,
// in segment order) goes to slot v % nslot; segment u reads the events vbase(u) ..
// vbase(u) + 2 (its rows h - 1, h, h + 1).  Each slot has three barriers: full (the TMA
// copies have landed), ready (the shifter has built the outer tiles) and empty (every
// consumer warp is done with the row).
struct RowRing {
  int u0, u1, H, nslot;
  uint64_t *full, *ready, *empty;
  __device__ int vbase(int u) const { return u - u0 + 2 * (u / H - u0 / H); }
  __device__ int events() const { return u1 > u0 ? vbase(u1 - 1) + 3 : 0; }
  __device__ int slot(int v) const { return v % nslot; }
  __device__ unsigned round(int v) const { return (unsigned)(v / nslot) & 1u; }
};

// The producer's copies of the x rows segment u adds (rows h - 1 .. h + 1 at a column's
// first segment, else h + 1): the middle tile and the two halo boxes of each, into a slot
// that every consumer warp has released.  K2_NO_LOADS arrives without copying.
__device__ __forceinline__ void load_x_rows(const RowRing& ring, int u, int& v,
                                            const CUtensorMap* xmap, const CUtensorMap* hmap,
                                            uint8_t* xs, int cp, int nwc) {
  const int col = u / ring.H, h = u - col * ring.H, b = col / nwc, w0 = (col - b * nwc) * TB_W;
  const int tile = cp * TB_ROW, box = cp * 2 * TB_HALO;
  for (int r = (u == ring.u0 || h == 0) ? h - 1 : h + 1; r <= h + 1; ++r, ++v) {
    const int s = ring.slot(v);
    if (v >= ring.nslot) hopper::mbar_wait(&ring.empty[s], ring.round(v) ^ 1u);
#ifdef K2_NO_LOADS
    hopper::mbar_arrive(&ring.full[s]);
#else
    uint8_t* dst = xs + s * slot_bytes(cp);
    hopper::mbar_arrive_expect_tx(&ring.full[s], tile + 2 * box);
    hopper::tma_load_4d(dst + tile, xmap, &ring.full[s], w0, r, 0, b);
    hopper::tma_load_4d(dst + 3 * tile, hmap, &ring.full[s], w0 - TB_HALO, r, 0, b);
    hopper::tma_load_4d(dst + 3 * tile + box, hmap, &ring.full[s], w0 + TB_W, r, 0, b);
#endif
  }
}

// The shifter warps (SHIFTERS of them, lane sid of 32 SHIFTERS): for each load event, once
// it has landed, the tiles at kx = 0 (pixel p of the row is x at w0 - 1 + p) and kx = 2
// (w0 + 1 + p) from the middle tile (w0 + p) and the halos, a 16-byte chunk (8 pixels) of
// a channel row a job: with the row's 32 words w (pixels 2i, 2i + 1 in word i, the lower in
// the low half), out[i] = w[i] << 16 | w[i - 1] >> 16 and w[i] >> 16 | w[i + 1] << 16, the
// halos giving w[-1] and w[32].  Then a fence for wgmma's reads and an arrival on ready
// (one a lane).  K2_NO_SHIFT skips the copies (a diagnostic build).
template <int SHIFTERS>
__device__ __forceinline__ void shift_rows(const RowRing& ring, uint8_t* xs, int cp, int sid) {
  const int tile = cp * TB_ROW, box = cp * 2 * TB_HALO, nv = ring.events();
  for (int v = 0; v < nv; ++v) {
    const int s = ring.slot(v);
    hopper::mbar_wait(&ring.full[s], ring.round(v));
    uint8_t* base = xs + s * slot_bytes(cp);
#ifndef K2_NO_SHIFT
    for (int t = sid; t < 8 * cp; t += 32 * SHIFTERS) {
      const int k = t >> 3, j = t & 7, sw = k & 7;
      const uint8_t* row = base + tile + k * TB_ROW;
      const uint4 c = *reinterpret_cast<const uint4*>(row + ((j ^ sw) << 4));
      const unsigned prev =
          j == 0 ? *reinterpret_cast<const unsigned*>(base + 3 * tile + k * 16 + 12)
                 : *reinterpret_cast<const unsigned*>(row + (((j - 1) ^ sw) << 4) + 12);
      const unsigned next =
          j == 7 ? *reinterpret_cast<const unsigned short*>(base + 3 * tile + box + k * 16)
                 : *reinterpret_cast<const unsigned*>(row + (((j + 1) ^ sw) << 4));
      *reinterpret_cast<uint4*>(base + k * TB_ROW + ((j ^ sw) << 4)) =
          make_uint4(c.x << 16 | prev >> 16, c.y << 16 | c.x >> 16, c.z << 16 | c.y >> 16,
                     c.w << 16 | c.z >> 16);
      *reinterpret_cast<uint4*>(base + 2 * tile + k * TB_ROW + ((j ^ sw) << 4)) =
          make_uint4(c.x >> 16 | c.y << 16, c.y >> 16 | c.z << 16, c.z >> 16 | c.w << 16,
                     c.w >> 16 | next << 16);
    }
#endif
    hopper::fence_proxy_async();
    hopper::mbar_arrive(&ring.ready[s]);
  }
}

// Releases, for one consumer warp, every load event before `until` that it has not
// released yet.  An event is released only once it is ready: its slot's empty barrier
// then counts the arrivals of that event's round, never the next one's.
__device__ __forceinline__ void release_rows(const RowRing& ring, int& rel, int until) {
  for (; rel < until; ++rel) {
    hopper::mbar_wait(&ring.ready[ring.slot(rel)], ring.round(rel));
    hopper::mbar_arrive(&ring.empty[ring.slot(rel)]);
  }
}

// Initialises the ring's barriers (one thread): `consumer_warps` arrivals empty a slot,
// `shifter_warps` warps' lanes make it ready.
__device__ __forceinline__ void init_ring(const RowRing& ring, int consumer_warps,
                                          int shifter_warps) {
  for (int s = 0; s < ring.nslot; ++s) {
    hopper::mbar_init(&ring.full[s], 1);
    hopper::mbar_init(&ring.ready[s], 32 * shifter_warps);
    hopper::mbar_init(&ring.empty[s], consumer_warps);
  }
}

// K2a-bf16's shared memory, in bytes from a 1024-aligned base: nslot x row slots, two
// output tiles of n channel rows (one a consumer warpgroup), the weights (9 taps x cp x n
// bf16), the barriers of the slots.
struct FwdSmem {
  int stage, w, bars, total;
};
__host__ __device__ constexpr FwdSmem fwd_smem(int cp, int n, int nslot) {
  return {nslot * slot_bytes(cp), nslot * slot_bytes(cp) + 2 * n * TB_ROW,
          nslot * slot_bytes(cp) + 2 * n * TB_ROW + 9 * cp * n * 2,
          nslot * slot_bytes(cp) + 2 * n * TB_ROW + 9 * cp * n * 2 + 24 * nslot + 1024};
}

// The weight of tap t, input channel ci, output channel co of the forward (w [Co][C][9]),
// or with flip of dX (w [C][Co][9] read at tap 8 - t), at source index i: the loop runs in
// source order, so the reads are coalesced either way.
__device__ __forceinline__ void weight_at(int i, int C, int Co, int flip, int& t, int& ci,
                                          int& co) {
  if (flip) {
    ci = i / (9 * Co);
    co = i / 9 % Co;
    t = 8 - i % 9;
  } else {
    co = i / (9 * C);
    ci = i / 9 % C;
    t = i % 9;
  }
}

// K2a-bf16 on wgmma: y[p, co] = sum over taps and input channels of x[p + tap][ci]
// w[tap][ci][co] for a row segment of 64 pixels (wgmma's M) by N output channels (Co
// rounded up to 24, 48 or 64).  A is the x tile of the tap's column offset, read
// MN-major (pixels contiguous); B the block's weights, loaded once (fp32 weights are
// rounded to bf16 here, as w.to(bf16) rounds them) into K-major core matrices
// (INTERLEAVE: 8 output channels x 8 input channels a core matrix, 16 input channels a
// wgmma).  9 cp / 16 wgmma m64nNk16 accumulate a segment in fp32, rounded once to bf16
// into an output tile that one TMA store writes (its rows past Co and its columns past W
// are not written).  Two consumer warpgroups take alternate segments, so that one's
// epilogue overlaps the other's products; the producer and shifter warps keep the ring
// full.  Each output is one warpgroup's sum in one order: deterministic.
template <int N>
__global__ void __launch_bounds__(TF_THREADS, 1)
conv3x3_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap hmap,
                       const __grid_constant__ CUtensorMap ymap, const void* __restrict__ w,
                       int w_fp32, int flip, int C, int Co, int H, int nwc, int n_units, int ups,
                       int nslot) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const int cp = cdiv(C, 16) * 16, nk = cp / 16, tile = cp * TB_ROW, slot = slot_bytes(cp);
  const FwdSmem L = fwd_smem(cp, N, nslot);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const int tid = threadIdx.x, blk = blockIdx.x;
  const RowRing ring{blk * ups, min(n_units, (blk + 1) * ups), H, nslot,
                     bars, bars + nslot, bars + 2 * nslot};
  if (ring.u0 >= ring.u1) return;
  if (tid == 0) {
    init_ring(ring, 8, TF_SHIFTERS);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid >= 256) {  // warp 8 copies, the warps after it shift
    if (tid == 256) {
      int v = 0;
      for (int u = ring.u0; u < ring.u1; ++u) load_x_rows(ring, u, v, &xmap, &hmap, smem, cp, nwc);
    } else if (tid >= 288) {
      shift_rows<TF_SHIFTERS>(ring, smem, cp, tid - 288);
    }
    return;
  }
  // The consumers load the weights while the first rows arrive: zeros past C and Co, then
  // each weight at (co / 8) 256 + (ci % 16 / 8) 128 + (co % 8) 16 + (ci % 8) 2 bytes of the
  // N x 16 block of its tap and 16 input channels.
  uint8_t* ws = smem + L.w;
  for (int i = tid; i < 9 * cp * N / 8; i += 256) reinterpret_cast<uint4*>(ws)[i] = make_uint4(0, 0, 0, 0);
  hopper::named_bar_sync(3, 256);
  constexpr int WB = 16;  // weights a thread has in flight: the loads do not wait on each other
  for (int i0 = tid; i0 < 9 * C * Co; i0 += WB * 256) {
    __nv_bfloat16 v[WB];
#pragma unroll
    for (int e = 0; e < WB; ++e) {
      const int i = min(i0 + e * 256, 9 * C * Co - 1);
      v[e] = w_fp32 ? __float2bfloat16_rn(static_cast<const float*>(w)[i])
                    : static_cast<const __nv_bfloat16*>(w)[i];
    }
#pragma unroll
    for (int e = 0; e < WB; ++e) {
      const int i = i0 + e * 256;
      if (i >= 9 * C * Co) break;
      int t, ci, co;
      weight_at(i, C, Co, flip, t, ci, co);
      *reinterpret_cast<__nv_bfloat16*>(ws + (t * nk + ci / 16) * N * 32 + (co >> 3) * 256 +
                                        (ci >> 3 & 1) * 128 + (co & 7) * 16 + (ci & 7) * 2) = v[e];
    }
  }
  hopper::fence_proxy_async();
  hopper::named_bar_sync(3, 256);

  // The warpgroup, warp-uniform for the compiler (a lane's shuffle): its loop over segments
  // then holds no divergent wgmma.
  const int k = __shfl_sync(0xffffffffu, tid >> 7, 0), ltid = tid & 127, warp = ltid >> 5,
            lane = tid & 31;
  uint8_t* out = smem + L.stage + k * N * TB_ROW;
  float acc[N / 2];
  int rel = 0;
  for (int u = ring.u0 + k; u < ring.u1; u += 2) {
    const int vb = ring.vbase(u);
    for (int ky = 0; ky < 3; ++ky)
      hopper::mbar_wait(&ring.ready[ring.slot(vb + ky)], ring.round(vb + ky));
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
    for (int ky = 0; ky < 3; ++ky) {
      const uint8_t* xr = smem + ring.slot(vb + ky) * slot;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        for (int kc = 0; kc < nk; ++kc) {
          const uint64_t a = hopper::gmma_desc(xr + kx * tile + kc * 16 * TB_ROW, 16, 1024,
                                               hopper::LAYOUT_SW128);
          const uint64_t b = hopper::gmma_desc(ws + ((ky * 3 + kx) * nk + kc) * N * 32, 128,
                                               256, hopper::LAYOUT_INTERLEAVE);
          if (K2_PRODUCTS) hopper::Wgmma<N, 1>::mma(acc, a, b, ky | kx | kc);
        }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(acc);
    if (lane == 0) release_rows(ring, rel, u + 2 < ring.u1 ? ring.vbase(u + 2) : ring.events());
    __syncwarp();
    // The epilogue: fp32 sums rounded once to bf16 into the output tile (row co, the
    // 16-byte chunk of pixel p at (p / 8) ^ (co % 8): the 128-byte swizzle of the TMA
    // store), then one TMA store of the tile.
    const int col = u / H, h = u - col * H, b = col / nwc, w0 = (col - b * nwc) * TB_W;
    if (ltid == 0) hopper::bulk_wait_read();  // the previous store has read the tile
    hopper::named_bar_sync(1 + k, 128);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = 16 * warp + (lane >> 2) + 8 * (q >> 1), co = 8 * j + 2 * (lane & 3) + (q & 1);
        *reinterpret_cast<__nv_bfloat16*>(out + co * TB_ROW + (((p >> 3) ^ (co & 7)) << 4) +
                                          (p & 7) * 2) = __float2bfloat16_rn(acc[4 * j + q]);
      }
    hopper::fence_proxy_async();
    hopper::named_bar_sync(1 + k, 128);
    if (ltid == 0) {
      hopper::tma_store_4d(&ymap, out, w0, h, 0, b);
      hopper::bulk_commit();
    }
  }
  if (lane == 0) release_rows(ring, rel, ring.events());
  if (ltid == 0) hopper::bulk_wait();
}

// K2b-bf16's shared memory, in bytes from a 1024-aligned base: nslot x row slots, the g
// tiles, the barriers (the slots', then g full and empty).
struct DwSmem {
  int g, bars, total;
};
__host__ __device__ constexpr DwSmem dw_smem(int cp, int nslot) {
  return {nslot * slot_bytes(cp), nslot * slot_bytes(cp) + TD_G_STAGES * TD_G_TILE,
          nslot * slot_bytes(cp) + TD_G_STAGES * TD_G_TILE + 24 * nslot + 16 * TD_G_STAGES +
              1024};
}

// K2b-bf16 on wgmma: dW[co][ci][ky][kx] = sum over pixels p of g[co][p] x[ci][p + (ky - 1,
// kx - 1)].  A is the g tile (64 output channels, wgmma's M; rows past Co are TMA's zero
// fill), B the x tile of column offset kx (N = CP input channels: C rounded up to 32, 48
// or 64, the rows past C TMA's zero fill), both K-major (pixels contiguous), 16 pixels a
// wgmma.  Consumer warpgroup ky takes the x row h + ky - 1 of segment h: every warpgroup
// reads the same g tile, and each x row serves three segments, one a warpgroup, so x and
// g are each read once per block column.  A segment is 3 x 4 wgmma m64nCPk16 in three
// groups (kx), each summed from zero in the tensor core and then added to fp32 totals in
// registers: the tensor core's accumulation runs over 64 pixels only (run over a whole
// split it drifts from fp32 sums; conv3x3_dw_tc's note).  While a warpgroup adds a group,
// the other two keep the tensor cores busy.  The block writes its partial [9][Co][C] of
// split s; dw_sum_taps adds the partials in a fixed order (deterministic, no float
// atomics).
template <int CP>
__global__ void __launch_bounds__(TD_THREADS, 1)
conv3x3_dw_bf16_wgmma(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap gmap, float* __restrict__ part, int C,
                      int Co, int H, int nwc, int n_units, int ups, int nslot) {
  constexpr int R = CP / 2, tile = CP * TB_ROW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const DwSmem L = dw_smem(CP, nslot);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* gfull = bars + 3 * nslot;
  uint64_t* gempty = gfull + TD_G_STAGES;
  const int tid = threadIdx.x, s = blockIdx.x;
  const RowRing ring{s * ups, min(n_units, (s + 1) * ups), H, nslot,
                     bars, bars + nslot, bars + 2 * nslot};
  if (tid == 0) {
    init_ring(ring, 12, TD_SHIFTERS);
    for (int i = 0; i < TD_G_STAGES; ++i) {
      hopper::mbar_init(&gfull[i], 1);
      hopper::mbar_init(&gempty[i], 12);  // one arrival a consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 384) {  // warp 12 copies, the warps after it shift
    if (tid == 384) {
      int v = 0;
      for (int u = ring.u0; u < ring.u1; ++u) {
        load_x_rows(ring, u, v, &xmap, &hmap, smem, CP, nwc);
        const int i = u - ring.u0, st = i % TD_G_STAGES;
        const int col = u / H, h = u - col * H, b = col / nwc, w0 = (col - b * nwc) * TB_W;
        if (i >= TD_G_STAGES)
          hopper::mbar_wait(&gempty[st], (unsigned)(i / TD_G_STAGES & 1) ^ 1u);
#ifdef K2_NO_LOADS
        hopper::mbar_arrive(&gfull[st]);
#else
        hopper::mbar_arrive_expect_tx(&gfull[st], TD_G_TILE);
        hopper::tma_load_4d(smem + L.g + st * TD_G_TILE, &gmap, &gfull[st], w0, h, 0, b);
#endif
      }
    } else if (tid >= 416) {
      shift_rows<TD_SHIFTERS>(ring, smem, CP, tid - 416);
    }
    return;
  }
  const int ky = __shfl_sync(0xffffffffu, tid >> 7, 0), warp = (tid >> 5) & 3, lane = tid & 31;
  float tot[3][R], acc[R];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < R; ++i) tot[kx][i] = 0.f;
  int rel = 0;
  for (int u = ring.u0; u < ring.u1; ++u) {
    const int i = u - ring.u0, st = i % TD_G_STAGES, v = ring.vbase(u) + ky;
    hopper::mbar_wait(&ring.ready[ring.slot(v)], ring.round(v));
    hopper::mbar_wait(&gfull[st], (unsigned)(i / TD_G_STAGES) & 1u);
    const uint8_t* xr = smem + ring.slot(v) * slot_bytes(CP);
    const uint8_t* gt = smem + L.g + st * TD_G_TILE;
    // Group kx: the 64 pixels' 4 wgmma into acc, from zero, then added to the totals.
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      hopper::fence_operand(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = hopper::gmma_desc(gt + 32 * kk, 16, 1024, hopper::LAYOUT_SW128);
        const uint64_t b = hopper::gmma_desc(xr + kx * tile + 32 * kk, 16, 1024,
                                             hopper::LAYOUT_SW128);
        if (K2_PRODUCTS) hopper::Wgmma<CP, 0>::mma(acc, a, b, kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
#pragma unroll
      for (int q = 0; q < R; ++q) tot[kx][q] += acc[q];
    }
    if (lane == 0) {
      hopper::mbar_arrive(&gempty[st]);
      release_rows(ring, rel, u + 1 < ring.u1 ? ring.vbase(u + 1) + ky : ring.events());
    }
    __syncwarp();
  }
  if (lane == 0) release_rows(ring, rel, ring.events());

  // The partial of split s, [9][Co][C]: tot[kx][4 j + q] is output channel 16 warp + lane
  // / 4 + 8 (q / 2), input channel 8 j + 2 (lane % 4) + q % 2, tap 3 ky + kx.
  float* dst = part + (size_t)s * 9 * Co * C;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int j = 0; j < CP / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = 16 * warp + (lane >> 2) + 8 * (q >> 1), ci = 8 * j + 2 * (lane & 3) + (q & 1);
        if (co < Co && ci < C) dst[((size_t)(3 * ky + kx) * Co + co) * C + ci] = tot[kx][4 * j + q];
      }
}

// dW[co][ci][tap] = sum over splits k of part[k][tap][co][ci], in a fixed order (four
// interleaved sums of the splits in order, then added pairwise), so deterministic; with
// round_bf16 each sum is rounded to bf16 (and kept in fp32: the gradient that a bf16
// weight's cast back to its fp32 parameter would give).
__global__ void dw_sum_taps(const float* __restrict__ part, float* __restrict__ out, int S,
                            int Co, int C, int round_bf16) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, n = 9 * Co * C;
  if (i >= n) return;
  float a[4] = {0.f, 0.f, 0.f, 0.f};  // splits k = 4 m + r summed in a[r], in order of m
  int k = 0;
#pragma unroll 4
  for (; k + 4 <= S; k += 4)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] += part[(size_t)(k + r) * n + i];
  for (; k < S; ++k) a[k & 3] += part[(size_t)k * n + i];
  float v = (a[0] + a[1]) + (a[2] + a[3]);
  if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  const int tap = i / (Co * C), co = i / C % Co, ci = i % C;
  out[((size_t)co * C + ci) * 9 + tap] = v;
}

// out[i] = sum over splits k of part[k][i], in split order.
__global__ void dw_sum_splits(const float* __restrict__ part, float* __restrict__ out, int S,
                           int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float v = 0.f;
  for (int k = 0; k < S; ++k) v += part[(size_t)k * N + i];
  out[i] = v;
}

int bad_shape(int B, int C, int Co, int H, int W) {
  return B <= 0 || C <= 0 || Co <= 0 || H <= 0 || W <= 0;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda at build).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a bf16 NCHW tensor [B, Cn, H, W] for K2's tiles: box {box_w pixels, 1 row,
// rows channels, 1 image}, zero fill out of bounds; the 128-byte swizzle for a 64-pixel
// tile, none for a halo box.
int tile_map(CUtensorMap* map, const void* p, int B, int Cn, int H, int W, int rows,
             int box_w = TB_W) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Cn, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                 (cuuint64_t)Cn * H * W * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, 1, (cuuint32_t)rows, 1}, step[4] = {1, 1, 1, 1};
  auto run = [&] {
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides,
                  box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  box_w == TB_W ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = run();
  int dev;
  // A driver call needs a current context, which the runtime binds to a thread only at
  // its first call that needs one: on a thread that made none yet (autograd's backward
  // worker, a new Python thread), bind the device's primary context and encode again.
  if (r == CUDA_ERROR_INVALID_CONTEXT && cudaGetDevice(&dev) == cudaSuccess &&
      cudaSetDevice(dev) == cudaSuccess)
    r = run();
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Can the TMA/wgmma kernels take these tensors?  TMA needs rows of a multiple of 16
// bytes and 16-byte aligned bases; the weights and accumulators hold 64 channels a side.
bool tma_shape(int B, int C, int Co, int H, int W, const void* a, const void* b) {
  return !bad_shape(B, C, Co, H, W) && W % 8 == 0 && C <= 64 && Co <= 64 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// One case per count of 8-channel input blocks of dW.
#define DW_CHANNEL_BLOCKS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)
// One case per (16-channel column blocks, 16-byte copies, flip) of K2a.
#define FW_TILES(X)                                                                      \
  X(1, 0, 0) X(1, 0, 1) X(1, 1, 0) X(1, 1, 1) X(2, 0, 0) X(2, 0, 1) X(2, 1, 0) X(2, 1, 1) \
  X(3, 0, 0) X(3, 0, 1) X(3, 1, 0) X(3, 1, 1) X(4, 0, 0) X(4, 0, 1) X(4, 1, 0) X(4, 1, 1)
// One case per count of 16-channel column blocks of K2a-bf16.
#define FW_B_TILES(X) X(1) X(2) X(3) X(4)
// One case per output-channel width (wgmma's N) of K2a-bf16 on TMA and wgmma: Co rounded
// up to 24 (HRNet-W18's 18), 48 (W48's) or 64.
#define FW_TMA_WIDTHS(X) X(24) X(48) X(64)
// One case per input-channel width (wgmma's N) of K2b-bf16 on TMA and wgmma: C rounded up
// to 32, 48 or 64.
#define DW_TMA_CHANNELS(X) X(32) X(48) X(64)

}  // namespace

extern "C" {

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2a.  x [B, C, H, W], y [B, Co, H, W]; w [Co, C, 3, 3], or [C, Co, 3, 3] with flip.
// Any C and Co: output channels in ceil(Co / 64) blocks of 16 NJ, NJ = ceil(Co / blocks
// / 16).
int conv3x3_fwd(const float* x, const float* w, float* y, int B, int C, int Co, int H, int W,
                int flip, void* stream) {
  if (bad_shape(B, C, Co, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_co_blocks = (Co + 16 * FW_MAX_NJ - 1) / (16 * FW_MAX_NJ);
  const int nj = ((Co + n_co_blocks - 1) / n_co_blocks + 15) / 16;
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((W + FW_TW - 1) / FW_TW, (H + FW_TH - 1) / FW_TH, B * n_co_blocks);
  const size_t bytes = fw_smem_bytes(nj);
  switch (4 * nj + 2 * vec + (flip != 0)) {
#define K2_FWD(nj, v, f)                                                                 \
  case 4 * nj + 2 * v + f:                                                               \
    conv3x3_fwd_tc<nj, v, f><<<grid, FW_NT, bytes, st>>>(x, w, y, C, Co, H, W,            \
                                                         n_co_blocks);                   \
    break;
    FW_TILES(K2_FWD)
#undef K2_FWD
  }
  return (int)cudaGetLastError();
}

// Lets K2a and conv3x3_dw_tc take the shared memory of their two stages, on the current
// device.
int conv3x3_init() {
  int err = 0;
#define K2_INIT(ncb)                                                                     \
  if (!err)                                                                              \
    err = (int)cudaFuncSetAttribute((const void*)conv3x3_dw_tc<ncb>,                     \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                                    dw_smem_bytes(ncb));
  DW_CHANNEL_BLOCKS(K2_INIT)
#undef K2_INIT
#define K2_FWD_INIT(nj, v, f)                                                            \
  if (!err)                                                                              \
    err = (int)cudaFuncSetAttribute((const void*)conv3x3_fwd_tc<nj, v, f>,               \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                                    fw_smem_bytes(nj));
  FW_TILES(K2_FWD_INIT)
#undef K2_FWD_INIT
#define K2_DW_BF16_INIT(ncb)                                                             \
  if (!err)                                                                              \
    err = (int)cudaFuncSetAttribute((const void*)conv3x3_dw_bf16_tc<ncb>,                \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                                    dw_b_smem_bytes(ncb));
  DW_CHANNEL_BLOCKS(K2_DW_BF16_INIT)
#undef K2_DW_BF16_INIT
#define K2_FWD_BF16_INIT(nj)                                                             \
  if (!err)                                                                              \
    err = (int)cudaFuncSetAttribute((const void*)conv3x3_fwd_bf16_tc<nj>,                \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                                    fw_b_smem_bytes(nj));
  FW_B_TILES(K2_FWD_BF16_INIT)
#undef K2_FWD_BF16_INIT
#define K2_TMA_INIT(kernel)                                                              \
  if (!err)                                                                              \
    err = (int)cudaFuncSetAttribute((const void*)kernel,                                 \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, TB_SMEM);
#define K2_FWD_TMA_INIT(n) K2_TMA_INIT(conv3x3_fwd_bf16_wgmma<n>)
  FW_TMA_WIDTHS(K2_FWD_TMA_INIT)
#define K2_DW_TMA_INIT(c) K2_TMA_INIT(conv3x3_dw_bf16_wgmma<c>)
  DW_TMA_CHANNELS(K2_DW_TMA_INIT)
#undef K2_DW_TMA_INIT
#undef K2_FWD_TMA_INIT
#undef K2_TMA_INIT
  return err;
}

// K2a-bf16.  x [B, C, H, W] and y [B, Co, H, W] bf16; w bf16 [Co, C, 3, 3], or [C, Co, 3,
// 3] with flip.  Any C and Co, output channels in blocks as conv3x3_fwd.
int conv3x3_fwd_bf16(const void* x, const void* w, void* y, int B, int C, int Co, int H,
                     int W, int flip, void* stream) {
  if (bad_shape(B, C, Co, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_co_blocks = (Co + 16 * FW_MAX_NJ - 1) / (16 * FW_MAX_NJ);
  const int nj = ((Co + n_co_blocks - 1) / n_co_blocks + 15) / 16;
  const bool wide = W % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const dim3 grid((W + FW_TW - 1) / FW_TW, (H + FW_TH - 1) / FW_TH, B * n_co_blocks);
  const size_t bytes = fw_b_smem_bytes(nj);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  switch (nj) {
#define K2_FWD_BF16(nj)                                                                  \
  case nj:                                                                               \
    conv3x3_fwd_bf16_tc<nj><<<grid, FW_NT, bytes, st>>>(xb, wb, yb, C, Co, H, W,          \
                                                        n_co_blocks, wide, flip);        \
    break;
    FW_B_TILES(K2_FWD_BF16)
#undef K2_FWD_BF16
  }
  return (int)cudaGetLastError();
}

// K2b-bf16.  x [B, C, H, W] and g [B, Co, H, W] bf16; part [S, Co, C, 9] fp32 scratch; dw
// [Co, C, 3, 3] fp32.  C <= 64; splits as conv3x3_dw.
int conv3x3_dw_bf16(const void* x, const void* g, float* part, float* dw, int B, int C,
                    int Co, int H, int W, int S, void* stream) {
  if (bad_shape(B, C, Co, H, W) || C > DW_MAX_C || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_units = B * H * ((W + DW_SW - 1) / DW_SW);
  const int ups = (n_units + S - 1) / S;
  const int vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid(S, (Co + DW_CO - 1) / DW_CO);
  const int ncb = (C + 7) / 8;
  const size_t bytes = dw_b_smem_bytes(ncb);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  switch (ncb) {
#define K2_DW_BF16(ncb)                                                                  \
  case ncb:                                                                              \
    conv3x3_dw_bf16_tc<ncb><<<grid, DW_WARPS * 32, bytes, st>>>(xb, gb, part, B, C, Co,   \
                                                                H, W, ups, vec);         \
    break;
    DW_CHANNEL_BLOCKS(K2_DW_BF16)
#undef K2_DW_BF16
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int N = Co * C * 9;
  dw_sum_splits<<<(N + 255) / 256, 256, 0, st>>>(part, dw, S, N);
  return (int)cudaGetLastError();
}

// K2b.  x [B, C, H, W], g [B, Co, H, W]; part [S, Co, C, 9] scratch; dw [Co, C, 3, 3].
// C <= 64.  S splits of ceil(n_units / S) row segments each, n_units = B*H*ceil(W/64),
// times ceil(Co / 16) output-channel blocks.
int conv3x3_dw(const float* x, const float* g, float* part, float* dw, int B, int C, int Co,
               int H, int W, int S, void* stream) {
  if (bad_shape(B, C, Co, H, W) || C > DW_MAX_C || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_units = B * H * ((W + DW_SW - 1) / DW_SW);
  const int ups = (n_units + S - 1) / S;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid(S, (Co + DW_CO - 1) / DW_CO);
  const int ncb = (C + 7) / 8;
  const size_t bytes = dw_smem_bytes(ncb);
  switch (ncb) {
#define K2_DW(ncb)                                                                       \
  case ncb:                                                                              \
    conv3x3_dw_tc<ncb><<<grid, DW_WARPS * 32, bytes, st>>>(x, g, part, B, C, Co, H, W,    \
                                                           ups, vec);                    \
    break;
    DW_CHANNEL_BLOCKS(K2_DW)
#undef K2_DW
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int N = Co * C * 9;
  dw_sum_splits<<<(N + 255) / 256, 256, 0, st>>>(part, dw, S, N);
  return (int)cudaGetLastError();
}

// K2a-bf16 on TMA and wgmma.  x [B, C, H, W] and y [B, Co, H, W] bf16, W % 8 == 0, C and
// Co <= 64, x and y 16-byte aligned; w [Co, C, 3, 3] (or [C, Co, 3, 3] with flip), bf16,
// or fp32 (w_fp32) rounded to bf16 as it is loaded.  At most `blocks` blocks (the SMs).
int conv3x3_fwd_bf16_tma(const void* x, const void* w, int w_fp32, void* y, int B, int C,
                         int Co, int H, int W, int flip, int blocks, void* stream) {
  if (!tma_shape(B, C, Co, H, W, x, y) || blocks <= 0) return (int)cudaErrorInvalidValue;
  const int cp = cdiv(C, 16) * 16, n = Co <= 24 ? 24 : Co <= 48 ? 48 : 64;
  int nslot = TB_MAX_SLOTS;
  while (nslot > 4 && fwd_smem(cp, n, nslot).total > TB_SMEM) --nslot;
  CUtensorMap xmap, hmap, ymap;
  int err = tile_map(&xmap, x, B, C, H, W, cp);
  if (!err) err = tile_map(&hmap, x, B, C, H, W, cp, TB_HALO);
  if (!err) err = tile_map(&ymap, y, B, Co, H, W, n);
  if (err) return err;
  // At most `blocks` blocks, each ceil(n_units / blocks) row segments.
  const int nwc = cdiv(W, TB_W), n_units = B * H * nwc, ups = cdiv(n_units, blocks);
  const int grid = cdiv(n_units, ups);
  const size_t bytes = fwd_smem(cp, n, nslot).total;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define K2_FWD_TMA(nn)                                                                     \
  case nn:                                                                                 \
    conv3x3_fwd_bf16_wgmma<nn><<<grid, TF_THREADS, bytes, st>>>(                           \
        xmap, hmap, ymap, w, w_fp32, flip, C, Co, H, nwc, n_units, ups, nslot);           \
    break;
    FW_TMA_WIDTHS(K2_FWD_TMA)
#undef K2_FWD_TMA
  }
  return (int)cudaGetLastError();
}

// K2b-bf16 on TMA and wgmma.  x [B, C, H, W] and g [B, Co, H, W] bf16 (shapes as
// conv3x3_fwd_bf16_tma); part [S, 9, Co, C] fp32 scratch, S = the blocks, each
// ceil(n_units / S) row segments of 64 pixels (n_units = B H ceil(W / 64)); dw [Co, C, 3,
// 3] fp32, each value rounded to bf16 with round_bf16.
int conv3x3_dw_bf16_tma(const void* x, const void* g, float* part, float* dw, int B, int C,
                        int Co, int H, int W, int S, int round_bf16, void* stream) {
  if (!tma_shape(B, C, Co, H, W, x, g) || S <= 0) return (int)cudaErrorInvalidValue;
  const int cp = C <= 32 ? 32 : C <= 48 ? 48 : 64;
  int nslot = TB_MAX_SLOTS;
  while (nslot > 4 && dw_smem(cp, nslot).total > TB_SMEM) --nslot;
  CUtensorMap xmap, hmap, gmap;
  int err = tile_map(&xmap, x, B, C, H, W, cp);
  if (!err) err = tile_map(&hmap, x, B, C, H, W, cp, TB_HALO);
  if (!err) err = tile_map(&gmap, g, B, Co, H, W, 64);
  if (err) return err;
  const int nwc = cdiv(W, TB_W), n_units = B * H * nwc, ups = cdiv(n_units, S);
  const size_t bytes = dw_smem(cp, nslot).total;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cp) {
#define K2_DW_TMA(c)                                                                       \
  case c:                                                                                  \
    conv3x3_dw_bf16_wgmma<c><<<S, TD_THREADS, bytes, st>>>(xmap, hmap, gmap, part, C, Co, H, \
                                                          nwc, n_units, ups, nslot);       \
    break;
    DW_TMA_CHANNELS(K2_DW_TMA)
#undef K2_DW_TMA
  }
  err = (int)cudaGetLastError();
  if (err) return err;
  const int n = 9 * Co * C;
  dw_sum_taps<<<cdiv(n, 256), 256, 0, st>>>(part, dw, S, Co, C, round_bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
