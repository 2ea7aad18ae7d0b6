// K2: small-channel 3x3 convolution (stride 1, SAME) for Hopper (sm_90a), fp32, NCHW.
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
// Bound: at HRNet-W48 branch 0 (B=2, C=Co=48, 128x256) each launch is 2*9*C*Co*B*H*W =
// 2.72 GFLOP against ~25 MB, ~100 flop/byte, so compute-bound on the fp32 SIMT cores
// (67 TFLOP/s: 41 us).  This first version is fp32 FMA with shared-memory tiles and
// register blocking; TF32/bf16 wgmma is the next lever and a numerics decision (the JAX
// path is fp32 HIGHEST).
//
// Design, against the TPU kernels:
//   * halos are masked in the kernel: the tile loader writes zeros outside the image, so
//     there is no padded copy of x (the TPU version pads rows by 7 and 1 and columns to a
//     multiple of 8 for Mosaic's alignment; jnp.pad cost +30 ms/step on the TPU).  Any H
//     and W work, ragged tiles included;
//   * forward: one block = a 16x32 output tile of one image x up to 64 output channels.
//     256 threads = 64 pixel threads x 4 channel groups; each thread owns 8 pixels (rows
//     2 apart at one column) x QC channels in registers.  The input channels stream
//     through shared memory 8 at a time, with their halo and their [8][9][<=64] weights;
//   * dW has no ordered grid on this card (the TPU kernel accumulates one VMEM block over
//     a sequential grid).  Each block sums a contiguous range of row segments into
//     registers (one thread = one input channel x 9 taps x QC output channels), writes a
//     partial [Co, C, 9], and dw_sum_splits adds the partials in split order: dW is
//     deterministic, with no float atomics.
//
// Plain C interface (loaded with ctypes).  Each entry point launches on the given stream,
// does not synchronise and returns cudaGetLastError() (0 on success).  Callers allocate
// every buffer.

#include <cuda_runtime.h>

namespace {

constexpr int NPT = 64;          // pixel threads (forward) / unused lanes never exist
constexpr int NCG = 4;           // output-channel groups per block
constexpr int NT = NPT * NCG;    // 256 threads (forward)
constexpr int TH = 16;           // forward: output rows per block
constexpr int TW = 32;           // forward: output columns per block
constexpr int NPIX = TH * TW / NPT;  // 8 pixels per thread
constexpr int CK = 8;            // forward: input channels per shared-memory chunk
constexpr int XH = TH + 2;       // haloed input tile
constexpr int XW = TW + 2;
constexpr int MAX_COP = 64;      // output channels per block, at most
constexpr int DW_TW = 32;        // dW: pixels per row segment
constexpr int DW_MAX_CI = 64;    // dW: input channels per block, at most

// Output-channel registers per thread: ceil(min(Co, 64) / 4), rounded up to 4, 8, 12, 16.
int qc_for(int co) {
  int c = co < MAX_COP ? co : MAX_COP;
  int q = (c + NCG - 1) / NCG;
  return (q + 3) / 4 * 4;
}

template <int QC>
__device__ __forceinline__ void load_q(const float* src, float (&v)[QC]) {
#pragma unroll
  for (int j = 0; j < QC / 4; ++j) {
    float4 f = reinterpret_cast<const float4*>(src)[j];
    v[4 * j] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
}

template <int QC>
__global__ void __launch_bounds__(NT) conv3x3_fwd_tiles(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y, int C,
    int Co, int H, int W, int flip, int n_co_blocks) {
  constexpr int COP = NCG * QC;
  __shared__ float xs[CK][XH][XW];
  __shared__ __align__(16) float ws[CK][9][COP];

  const int tid = threadIdx.x;
  const int pt = tid % NPT;
  const int cg = tid / NPT;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int b = blockIdx.z / n_co_blocks;
  const int co0 = (blockIdx.z % n_co_blocks) * COP;
  const float* xb = x + (size_t)b * C * H * W;

  float acc[NPIX][QC];
#pragma unroll
  for (int p = 0; p < NPIX; ++p)
#pragma unroll
    for (int q = 0; q < QC; ++q) acc[p][q] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < CK * XH * XW; i += NT) {
      const int c = i / (XH * XW), r = (i / XW) % XH, q = i % XW;
      const int gc = c0 + c, gh = h0 - 1 + r, gw = w0 - 1 + q;
      float v = 0.f;
      if (gc < C && gh >= 0 && gh < H && gw >= 0 && gw < W) v = xb[((size_t)gc * H + gh) * W + gw];
      xs[c][r][q] = v;
    }
    // Weight of (output o, input i, tap t = 3*ky + kx): w[o][i][t], or with flip
    // w[i][o][8 - t] (w is then [C, Co, 3, 3]: the forward's [Co_fwd, C_fwd, 3, 3]).
    for (int i = tid; i < CK * 9 * COP; i += NT) {
      const int c = i / (9 * COP), t = (i / COP) % 9, o = i % COP;
      const int gc = c0 + c, go = co0 + o;
      float v = 0.f;
      if (gc < C && go < Co)
        v = flip ? w[((size_t)gc * Co + go) * 9 + 8 - t] : w[((size_t)go * C + gc) * 9 + t];
      ws[c][t][o] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < CK; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float wv[QC];
          load_q<QC>(&ws[c][3 * ky + kx][cg * QC], wv);
#pragma unroll
          for (int p = 0; p < NPIX; ++p) {
            const int i = pt + NPT * p;
            const float xv = xs[c][i / TW + ky][i % TW + kx];
#pragma unroll
            for (int q = 0; q < QC; ++q) acc[p][q] = fmaf(xv, wv[q], acc[p][q]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < NPIX; ++p) {
    const int i = pt + NPT * p;
    const int gh = h0 + i / TW, gw = w0 + i % TW;
    if (gh >= H || gw >= W) continue;
#pragma unroll
    for (int q = 0; q < QC; ++q) {
      const int o = co0 + cg * QC + q;
      if (o < Co) y[(((size_t)b * Co + o) * H + gh) * W + gw] = acc[p][q];
    }
  }
}

// One block: input channels [ci0, ci0 + blockDim/4) x output channels [co0, co0 + 4*QC),
// summed over row segments [u0, u1) of DW_TW pixels.  Thread: cg = tid % 4, ci = tid / 4.
template <int QC>
__global__ void __launch_bounds__(NCG * DW_MAX_CI) conv3x3_dw_tiles(
    const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ part, int B,
    int C, int Co, int H, int W, int units_per_split) {
  constexpr int COP = NCG * QC;
  constexpr int XW2 = DW_TW + 2;
  __shared__ float xs[DW_MAX_CI][3][XW2];
  __shared__ __align__(16) float gs[DW_TW][MAX_COP];

  const int nthreads = blockDim.x;
  const int ckw = nthreads / NCG;
  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int ci = tid / NCG;
  const int s = blockIdx.x;
  const int ci0 = blockIdx.y * ckw;
  const int co0 = blockIdx.z * COP;
  const int nwc = (W + DW_TW - 1) / DW_TW;
  const int n_units = B * H * nwc;
  const int u0 = s * units_per_split;
  const int u1 = min(n_units, u0 + units_per_split);

  float acc[9][QC];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int q = 0; q < QC; ++q) acc[t][q] = 0.f;

  for (int u = u0; u < u1; ++u) {
    const int b = u / (H * nwc);
    const int h = (u / nwc) % H;
    const int w0 = (u % nwc) * DW_TW;
    __syncthreads();
    for (int i = tid; i < ckw * 3 * XW2; i += nthreads) {
      const int c = i / (3 * XW2), r = (i / XW2) % 3, q = i % XW2;
      const int gc = ci0 + c, gh = h - 1 + r, gw = w0 - 1 + q;
      float v = 0.f;
      if (gc < C && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = x[(((size_t)b * C + gc) * H + gh) * W + gw];
      xs[c][r][q] = v;
    }
    for (int i = tid; i < COP * DW_TW; i += nthreads) {
      const int o = i / DW_TW, px = i % DW_TW;
      const int go = co0 + o, gw = w0 + px;
      float v = 0.f;
      if (go < Co && gw < W) v = g[(((size_t)b * Co + go) * H + h) * W + gw];
      gs[px][o] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int px = 0; px < DW_TW; ++px) {
      float gv[QC];
      load_q<QC>(&gs[px][cg * QC], gv);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float xv = xs[ci][ky][px + kx];
#pragma unroll
          for (int q = 0; q < QC; ++q) acc[3 * ky + kx][q] = fmaf(xv, gv[q], acc[3 * ky + kx][q]);
        }
      }
    }
  }

  const int gci = ci0 + ci;
  if (gci >= C) return;
  float* dst = part + (size_t)s * Co * C * 9;
#pragma unroll
  for (int q = 0; q < QC; ++q) {
    const int o = co0 + cg * QC + q;
    if (o >= Co) continue;
#pragma unroll
    for (int t = 0; t < 9; ++t) dst[((size_t)o * C + gci) * 9 + t] = acc[t][q];
  }
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

}  // namespace

extern "C" {

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2a.  x [B, C, H, W], y [B, Co, H, W]; w [Co, C, 3, 3], or [C, Co, 3, 3] with flip.
int conv3x3_fwd(const float* x, const float* w, float* y, int B, int C, int Co, int H, int W,
                int flip, void* stream) {
  if (bad_shape(B, C, Co, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qc = qc_for(Co);
  const int n_co_blocks = (Co + NCG * qc - 1) / (NCG * qc);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_co_blocks);
  switch (qc) {
    case 4: conv3x3_fwd_tiles<4><<<grid, NT, 0, st>>>(x, w, y, C, Co, H, W, flip, n_co_blocks); break;
    case 8: conv3x3_fwd_tiles<8><<<grid, NT, 0, st>>>(x, w, y, C, Co, H, W, flip, n_co_blocks); break;
    case 12: conv3x3_fwd_tiles<12><<<grid, NT, 0, st>>>(x, w, y, C, Co, H, W, flip, n_co_blocks); break;
    default: conv3x3_fwd_tiles<16><<<grid, NT, 0, st>>>(x, w, y, C, Co, H, W, flip, n_co_blocks); break;
  }
  return (int)cudaGetLastError();
}

// K2b.  x [B, C, H, W], g [B, Co, H, W]; part [S, Co, C, 9] scratch; dw [Co, C, 3, 3].
// S row-segment splits of ceil(n_units / S) segments each, n_units = B*H*ceil(W/32).
int conv3x3_dw(const float* x, const float* g, float* part, float* dw, int B, int C, int Co,
               int H, int W, int S, void* stream) {
  if (bad_shape(B, C, Co, H, W) || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qc = qc_for(Co);
  const int n_co_blocks = (Co + NCG * qc - 1) / (NCG * qc);
  const int ckw = C < DW_MAX_CI ? (C + 7) / 8 * 8 : DW_MAX_CI;
  const int n_ci_blocks = (C + ckw - 1) / ckw;
  const int n_units = B * H * ((W + DW_TW - 1) / DW_TW);
  const int ups = (n_units + S - 1) / S;
  dim3 grid(S, n_ci_blocks, n_co_blocks);
  const int threads = NCG * ckw;
  switch (qc) {
    case 4: conv3x3_dw_tiles<4><<<grid, threads, 0, st>>>(x, g, part, B, C, Co, H, W, ups); break;
    case 8: conv3x3_dw_tiles<8><<<grid, threads, 0, st>>>(x, g, part, B, C, Co, H, W, ups); break;
    case 12: conv3x3_dw_tiles<12><<<grid, threads, 0, st>>>(x, g, part, B, C, Co, H, W, ups); break;
    default: conv3x3_dw_tiles<16><<<grid, threads, 0, st>>>(x, g, part, B, C, Co, H, W, ups); break;
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int N = Co * C * 9;
  dw_sum_splits<<<(N + 255) / 256, 256, 0, st>>>(part, dw, S, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
