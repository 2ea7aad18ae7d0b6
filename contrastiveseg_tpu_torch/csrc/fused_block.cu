// K3: the inference HRNet BasicBlock as one kernel for Hopper (sm_90a), NCHW.
//
// Replaces the Pallas TPU kernel _fused_block_kernel of
// contrastiveseg_tpu/ops/block_pallas.py (:51, via fused_basic_block_eval :135):
//     y = relu(conv2(y1) + b2 + x),  y1 = relu(conv1(x) + b1),
// 3x3 SAME convs whose weights already carry the folded BN scales (the caller folds
// them and rounds them to x's type, as the JAX wrapper does, :158-159).  x and y are
// fp32 or bf16; products and sums are fp32; y1 is rounded to x's type, as the JAX
// kernel's y1 scratch holds it.
//
// Bound: at [8, 48, 128, 256] the block is 2 convs x 2*9*C*C*B*H*W = 21.7 GFLOP against
// 2 x 50 MB of x and y in fp32 (25 MB each in bf16): compute-bound on the fp32 SIMT cores
// (0.32 ms at 67 TFLOP/s); in bf16 on tensor cores the bound would be ~22 us.  This first
// version is fp32 FMA on the SIMT cores for both types; wgmma is the next lever.
//
// Design:
//   * one block = an 8x32 output tile of one image, all C <= 64 channels (conv2 needs all
//     of y1's channels).  Stage 1 computes y1 on the haloed 10x34 tile, streaming x's
//     channels through shared memory 8 at a time with their halo (12x36) and weights;
//     y1 stays in shared memory (C x 10 x 34 fp32) and never touches device memory.
//     Stage 2 computes conv2 from it, streaming w2 the same way, and adds b2 and x;
//   * the boundary, where a port goes wrong: conv2's SAME padding must read zeros, not
//     conv1 evaluated on the padding (relu(b1) != 0).  Stage 1 writes 0 for every y1
//     position outside the image, so the first and last row tiles and the ragged column
//     tile read zeros there (block_pallas.py:93-101 masks the same positions);
//   * x's halo is masked in the loader: no padded copy of x (the TPU version pads rows by
//     6 and 2 and columns to a multiple of 8 for Mosaic);
//   * 256 threads = 64 pixel threads x 4 channel groups; a thread owns 6 stage-1 pixels
//     and 4 output pixels x QC channels in registers.
//
// Plain C interface (loaded with ctypes).  fused_block_init() raises the kernels' dynamic
// shared-memory limit once per device.  Entry points launch on the given stream, do not
// synchronise and return cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NPT = 64;
constexpr int NCG = 4;
constexpr int NT = NPT * NCG;          // 256 threads
constexpr int TH = 8;                  // output rows per block
constexpr int TW = 32;                 // output columns per block
constexpr int YH = TH + 2, YW = TW + 2;    // y1 tile (one halo row/column each side)
constexpr int XH = TH + 4, XW = TW + 4;    // x tile for stage 1
constexpr int NPIX1 = (YH * YW + NPT - 1) / NPT;  // 6 stage-1 pixels per thread
constexpr int NPIX2 = TH * TW / NPT;              // 4 output pixels per thread
constexpr int CK = 8;                  // channels per streamed chunk
constexpr int MAX_C = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

size_t smem_bytes(int cop) {
  return sizeof(float) * ((size_t)cop * YH * YW + CK * XH * XW + CK * 9 * cop);
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

// ws[c][t][o] = w[o][c0 + c][t] for the chunk's channels; zero past C.
template <int COP>
__device__ __forceinline__ void load_weights(float* ws, const float* __restrict__ w, int c0,
                                             int C) {
  for (int i = threadIdx.x; i < CK * 9 * COP; i += NT) {
    const int c = i / (9 * COP), t = (i / COP) % 9, o = i % COP;
    const int gc = c0 + c;
    ws[i] = (gc < C && o < C) ? w[((size_t)o * C + gc) * 9 + t] : 0.f;
  }
}

template <typename T, int QC>
__global__ void __launch_bounds__(NT) fused_block_tiles(
    const T* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ b1, const float* __restrict__ b2, T* __restrict__ y, int C,
    int H, int W) {
  constexpr int COP = NCG * QC;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                       // [CK][9][COP]
  float* y1s = ws + CK * 9 * COP;         // [COP][YH][YW]
  float* xs = y1s + COP * YH * YW;        // [CK][XH][XW]

  const int tid = threadIdx.x;
  const int pt = tid % NPT;
  const int cg = tid / NPT;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * C * H * W;

  // ---- stage 1: y1 on rows h0-1 .. h0+TH, columns w0-1 .. w0+TW.
  float acc1[NPIX1][QC];
#pragma unroll
  for (int p = 0; p < NPIX1; ++p)
#pragma unroll
    for (int q = 0; q < QC; ++q) acc1[p][q] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();
    for (int i = tid; i < CK * XH * XW; i += NT) {
      const int c = i / (XH * XW), r = (i / XW) % XH, q = i % XW;
      const int gc = c0 + c, gh = h0 - 2 + r, gw = w0 - 2 + q;
      float v = 0.f;
      if (gc < C && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = to_f(xb[((size_t)gc * H + gh) * W + gw]);
      xs[i] = v;
    }
    load_weights<COP>(ws, w1, c0, C);
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < CK; ++c) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        float wv[QC];
        load_q<QC>(&ws[(c * 9 + t) * COP + cg * QC], wv);
#pragma unroll
        for (int p = 0; p < NPIX1; ++p) {
          int i = pt + NPT * p;
          i = i < YH * YW ? i : YH * YW - 1;  // the last thread's spare slots
          const float xv = xs[(c * XH + i / YW + t / 3) * XW + i % YW + t % 3];
#pragma unroll
          for (int q = 0; q < QC; ++q) acc1[p][q] = fmaf(xv, wv[q], acc1[p][q]);
        }
      }
    }
  }
  // y1 = relu(acc + b1), rounded to T, and 0 outside the image (conv2's padding).
#pragma unroll
  for (int p = 0; p < NPIX1; ++p) {
    const int i = pt + NPT * p;
    if (i >= YH * YW) continue;
    const int r = i / YW, q = i % YW;
    const int gh = h0 - 1 + r, gw = w0 - 1 + q;
    const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
#pragma unroll
    for (int k = 0; k < QC; ++k) {
      const int o = cg * QC + k;
      float v = 0.f;
      if (inside && o < C) v = to_f(from_f<T>(fmaxf(acc1[p][k] + b1[o], 0.f)));
      y1s[(o * YH + r) * YW + q] = v;
    }
  }

  // ---- stage 2: y = relu(conv2(y1) + b2 + x) on the 8x32 output tile.
  float acc2[NPIX2][QC];
#pragma unroll
  for (int p = 0; p < NPIX2; ++p)
#pragma unroll
    for (int q = 0; q < QC; ++q) acc2[p][q] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // y1s complete; the previous chunk's weights consumed
    load_weights<COP>(ws, w2, c0, C);
    __syncthreads();
    const int cn = C - c0 < CK ? C - c0 : CK;
#pragma unroll 1
    for (int c = 0; c < cn; ++c) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        float wv[QC];
        load_q<QC>(&ws[(c * 9 + t) * COP + cg * QC], wv);
#pragma unroll
        for (int p = 0; p < NPIX2; ++p) {
          const int i = pt + NPT * p;
          const float yv = y1s[((c0 + c) * YH + i / TW + t / 3) * YW + i % TW + t % 3];
#pragma unroll
          for (int q = 0; q < QC; ++q) acc2[p][q] = fmaf(yv, wv[q], acc2[p][q]);
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < NPIX2; ++p) {
    const int i = pt + NPT * p;
    const int gh = h0 + i / TW, gw = w0 + i % TW;
    if (gh >= H || gw >= W) continue;
#pragma unroll
    for (int k = 0; k < QC; ++k) {
      const int o = cg * QC + k;
      if (o >= C) continue;
      const size_t at = ((size_t)o * H + gh) * W + gw;
      const float v = acc2[p][k] + b2[o] + to_f(xb[at]);
      y[(size_t)b * C * H * W + at] = from_f<T>(fmaxf(v, 0.f));
    }
  }
}

int qc_for(int c) {
  const int q = (c + NCG - 1) / NCG;
  return (q + 3) / 4 * 4;
}

template <typename T>
int launch(const T* x, const float* w1, const float* w2, const float* b1, const float* b2,
           T* y, int B, int C, int H, int W, cudaStream_t st) {
  const int qc = qc_for(C);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const size_t bytes = smem_bytes(NCG * qc);
  switch (qc) {
    case 4: fused_block_tiles<T, 4><<<grid, NT, bytes, st>>>(x, w1, w2, b1, b2, y, C, H, W); break;
    case 8: fused_block_tiles<T, 8><<<grid, NT, bytes, st>>>(x, w1, w2, b1, b2, y, C, H, W); break;
    case 12: fused_block_tiles<T, 12><<<grid, NT, bytes, st>>>(x, w1, w2, b1, b2, y, C, H, W); break;
    default: fused_block_tiles<T, 16><<<grid, NT, bytes, st>>>(x, w1, w2, b1, b2, y, C, H, W); break;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int set_smem() {
  int err;
  if ((err = (int)cudaFuncSetAttribute((const void*)fused_block_tiles<T, 4>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(16)))) return err;
  if ((err = (int)cudaFuncSetAttribute((const void*)fused_block_tiles<T, 8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(32)))) return err;
  if ((err = (int)cudaFuncSetAttribute((const void*)fused_block_tiles<T, 12>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(48)))) return err;
  return (int)cudaFuncSetAttribute((const void*)fused_block_tiles<T, 16>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(64));
}

}  // namespace

extern "C" {

const char* fused_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Lets the kernels take the shared memory that C = 64 needs, on the current device.
int fused_block_init() {
  int err = set_smem<float>();
  return err ? err : set_smem<__nv_bfloat16>();
}

// x, y [B, C, H, W] of type dtype (0 fp32, 1 bf16); w1, w2 [C, C, 3, 3] fp32 with the BN
// scales folded in; b1, b2 [C] fp32.
int fused_block(const void* x, const float* w1, const float* w2, const float* b1,
                const float* b2, void* y, int B, int C, int H, int W, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || C > MAX_C || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const float*>(x), w1, w2, b1, b2, static_cast<float*>(y), B, C, H,
                  W, st);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x), w1, w2, b1, b2,
                  static_cast<__nv_bfloat16*>(y), B, C, H, W, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
