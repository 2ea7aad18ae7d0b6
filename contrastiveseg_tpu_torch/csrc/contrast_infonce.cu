// K1: fused anchors x contrast-set InfoNCE for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels of contrastiveseg_tpu/ops/contrast_pallas.py:
//   K1a _pass1_kernel (:50)  -> infonce_pass1: row max m over the valid
//       columns, negative exp-sum ns rescaled online as m moves, positive
//       count p;
//   K1b _pass2_kernel (:75)  -> infonce_pass2: s1 = sum_pos (l-m - log(denom)),
//       t = sum_pos 1/denom, denom = e^{l-m} + ns + 1e-30;
//   K1c _bwd_kernel   (:98)  -> infonce_bwd: dA = sum_k dl * c / tau with
//       dl = w(1 - e/denom) on positives and -w*t*e on negatives.
// where l = a . c / tau.  The [M, K] logits are never stored.
//
// Bound on the H100: at the main path's M (38 anchors at batch 2) the bytes,
// 195 MB of bank per pass (0.058 ms at 3.35 TB/s); from M ~ 150 the
// operations, 2*M*K*D flops a product.  One design for all three kernels,
// and what it does about each:
//   * anchor-sized tiles: a bank tile of 64 rows is the MMA's row side, an
//     anchor chunk of mc <= 64 columns (M rounded up to 8: 40 at M=38) its
//     column side, so no product runs on padding rows; M > 64 is cut into
//     equal chunks across blockIdx.x (anchor_chunks).  The chunk stays in
//     shared memory; the K split fills one wave of one block per SM;
//   * a pipelined bank stream (bank_loop): two shared-memory stages of 64
//     rows x D filled by 16-byte cp.async (zero-fill past K, no division per
//     copy), so the next tile's 66 KB are in flight while this one is
//     computed; labels and validity come one tile ahead;
//   * tensor cores at fp32 accuracy: mma.sync m16n8k8 TF32 in the 3xTF32
//     split (x = hi + lo; hi.hi + hi.lo + lo.hi, fp32 accumulation), ~2^-19
//     relative error per product at worst, within the rtol 1e-4 the plain
//     version is held to (a single TF32 product, ~1e-3 relative before the
//     1/tau = 14.3 scale and the exp, moves pass 1's ns past it).  mma.sync
//     reaches its rate only with many independent MMA chains per SM, so K1a
//     and K1b give each warp one 16 x 8 logits block (two at mc = 64), 4-28
//     warps a block, and keep the three products in separate accumulators;
//   * the epilogue in registers: masks, the online max and the rescaled
//     exp-sum (K1a), the positive sums s1 and t (K1b) or dl (K1c) act on the
//     accumulator fragments; K1a and K1b merge lanes by shuffles and the
//     four row groups in shared memory;
//   * K1c's second product on the same stage: dl / tau goes to shared memory
//     as an MMA operand and dA^T += C_tile^T dl runs in 3xTF32 with the dA
//     accumulators in registers across the block's K range (16 warps, one
//     16-row block of dA^T each), so the bank is read once per backward; one
//     [mc, D] partial per (chunk, split).
//
// Common to all three, against the TPU kernel's block structure:
//   * the TPU runs a sequential grid over K carrying sums in VMEM scratch;
//     here the grid is (anchors x K split), each block loops over its K range
//     in tiles and writes partials; a small merge kernel combines them in a
//     fixed split order, so results are deterministic (pass 1 merges
//     log-sum-exp style, pass 2 and the backward by plain sums), with no
//     float atomics;
//   * no padded copy of the bank and no 8-row label blocks: the ragged K
//     tail is masked in the kernel;
//   * masks are selects, never multiplies: exp(l - m) of an invalid column
//     can be inf and is never read.
// Semantics kept exactly: m over all valid columns (positives included),
// ns over valid negatives only, +1e-30 in both denominators, no
// self-exclusion against the bank.  Every D <= MAX_D = 256 is taken (4-byte
// copies where D % 4 != 0).
//
// K1_PRODUCTS (3 unless set) is a diagnostic build switch for
// tools/bench_k1_variants.py, which times the three kernels with 1 (hi.hi
// only: one TF32 product, TF32 accuracy) and 0 (no products: the bank stream,
// labels and epilogue on zero logits) to show what bounds them.  The port
// builds 3.
//
// Plain C interface (loaded with ctypes).  infonce_init() raises the
// kernels' dynamic shared-memory limit once per device, before the first
// launch.  Each entry point launches on the given stream, does not
// synchronise and returns cudaGetLastError() after every launch (0 on
// success).  Callers allocate every buffer.  The cp.async copies and the
// TF32 products are in tc_common.cuh, shared with K2.

#include <cuda_runtime.h>

#include <cstdint>

#include "tc_common.cuh"

#ifndef K1_PRODUCTS
#define K1_PRODUCTS 3
#endif

namespace {

constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

__global__ void pass1_merge(const float* __restrict__ m_part, const float* __restrict__ ns_part,
                            const float* __restrict__ p_part, float* __restrict__ m,
                            float* __restrict__ ns, float* __restrict__ p, int M, int S) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  float mm = NEG_INF;
  for (int s = 0; s < S; ++s) mm = fmaxf(mm, m_part[(size_t)s * M + r]);
  float n = 0.f, pp = 0.f;
  for (int s = 0; s < S; ++s) {
    n += ns_part[(size_t)s * M + r] * expf(m_part[(size_t)s * M + r] - mm);
    pp += p_part[(size_t)s * M + r];
  }
  m[r] = mm;
  ns[r] = n;
  p[r] = pp;
}

__global__ void sum_splits(const float* __restrict__ part, float* __restrict__ out,
                           int n, int S) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * n + idx];
  out[idx] = acc;
}

constexpr int ROWS = 64;    // bank rows per tile: 4 MMA row blocks of 16
constexpr int MAX_MC = 64;  // anchors per chunk: up to 8 MMA column blocks of 8
constexpr int BWD_WARPS = 16;

// K1a's and K1b's warps for a chunk of 8 nb anchors: one per (16-row block,
// 8-anchor block) up to nb = 7, so a warp's products form few dependent
// chains; at nb = 8, 16 warps of two anchor blocks each (registers cap 1024
// threads).
__host__ __device__ constexpr int pass1_warps(int nb) { return nb <= 7 ? 4 * nb : 16; }

// One block's shared memory, in 4-byte words.
struct Plan {
  int dp;        // the products' depth: D rounded up to 16, zero padded
  int ld;        // row stride of the bank stages and the anchor tile: dp + 4
  int ldp;       // row stride of the backward's dlogit tile P: mc + 4
  size_t stage;  // one bank stage: ROWS x ld
  size_t bytes;
};

__host__ __device__ inline Plan plan(int D, int mc, bool bwd) {
  Plan p;
  p.dp = (D + 15) / 16 * 16;
  p.ld = p.dp + 4;
  p.ldp = mc + 4;
  p.stage = (size_t)ROWS * p.ld;
  size_t words = 2 * p.stage + (size_t)mc * p.ld  // two bank stages, the anchors
                 + 4 * ROWS                        // labels, validity: two slots each
                 + 5 * MAX_MC;                     // per anchor: label, m, ns, t, w
  words += bwd ? (size_t)ROWS * p.ldp : 3 * 4 * MAX_MC;  // P, or the passes' merge
  p.bytes = words * sizeof(float);
  return p;
}

// 3xTF32: d += lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b); the lo lo term
// (2^-20 of the product) is dropped.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  if (K1_PRODUCTS >= 3) {
    mma_tf32(d, al, bh[0], bh[1]);
    mma_tf32(d, ah, bl[0], bl[1]);
  }
  if (K1_PRODUCTS >= 1) mma_tf32(d, ah, bh[0], bh[1]);
}

// Streams tiles [row0, row0 + ROWS) x D of the bank into a shared-memory
// stage with cp.async: 16-byte copies when D % 4 == 0 and the bank is 16-byte
// aligned, else 4-byte copies.  Rows at or past K are zero-filled.  Each
// thread's first row and column are fixed once: no division per copy.
struct BankStream {
  const float* c;
  int K, D, ld, width, per_row, lanes, col0, r0, rstep;

  __device__ BankStream(const float* c_, int K_, int D_, int ld_, bool vec)
      : c(c_), K(K_), D(D_), ld(ld_), width(vec ? 4 : 1) {
    per_row = D / width;                           // copies per row
    lanes = min(per_row, (int)blockDim.x);         // threads along a row
    rstep = blockDim.x / lanes;                    // rows per pass of the block
    r0 = threadIdx.x / lanes;                      // >= rstep: copies nothing
    col0 = threadIdx.x - r0 * lanes;
  }

  __device__ void load(float* stage, int row0) const {
    if (r0 >= rstep) return;
    for (int r = r0; r < ROWS; r += rstep) {
      const int g = row0 + r;
      const bool ok = g < K;
      for (int v = col0; v < per_row; v += lanes) {
        const int col = v * width;
        const float* src = c + (ok ? (size_t)g * D + col : 0);
        if (width == 4) cp_async16(stage + r * ld + col, src, ok ? 16 : 0);
        else cp_async4(stage + r * ld + col, src, ok ? 4 : 0);
      }
    }
  }
};

// The anchor chunk [c0, c0 + mc) x ld into As, zero past M and past D; zeros
// in the two stages' columns [D, ld), which the copies never write.
__device__ void load_anchors(float* As, float* stages, const float* __restrict__ a, int c0,
                             int M, int D, int mc, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = warp; r < mc; r += warps) {
    const int g = c0 + r;
    for (int k = lane; k < ld; k += 32)
      As[r * ld + k] = (g < M && k < D) ? a[(size_t)g * D + k] : 0.f;
  }
  for (int r = warp; r < 2 * ROWS; r += warps)
    for (int k = D + lane; k < ld; k += 32) stages[r * ld + k] = 0.f;
}

// Thread i < ROWS: label and validity of bank row row0 + i (0 past K).
__device__ __forceinline__ void tile_labels(const int* __restrict__ c_l,
                                            const unsigned char* __restrict__ c_v, int row0,
                                            int K, int& l, int& v) {
  const int g = row0 + threadIdx.x;
  l = g < K ? c_l[g] : 0;
  v = g < K ? (int)c_v[g] : 0;
}

// acc[j] = bank rows [16 rg, 16 rg + 16) of stage Cs against anchor columns
// [8 (jb + j), 8 (jb + j) + 8) of As, for j < nj, in 3xTF32.  Row stride ld
// = 4 mod 16 makes every fragment load below conflict-free.  The three
// products accumulate apart (three independent MMA chains), summed at the end.
template <int NJ>
__device__ __forceinline__ void logits_tile(const float* Cs, const float* As, int ld, int dp,
                                            int rg, int jb, int nj, int g, int t,
                                            float (&acc)[NJ][4]) {
  float hl[NJ][4], lh[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = hl[j][q] = lh[j][q] = 0.f;
  const float* cr = Cs + (rg * 16 + g) * ld + t;
  const float* ar = As + (jb * 8 + g) * ld + t;
#pragma unroll 4
  for (int k = 0; k < dp; k += 8) {
    unsigned ah[4], al[4];
    split_tf32(cr[k], ah[0], al[0]);
    split_tf32(cr[k + 8 * ld], ah[1], al[1]);
    split_tf32(cr[k + 4], ah[2], al[2]);
    split_tf32(cr[k + 8 * ld + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        unsigned bh[2], bl[2];
        split_tf32(ar[j * 8 * ld + k], bh[0], bl[0]);
        split_tf32(ar[j * 8 * ld + k + 4], bh[1], bl[1]);
        if (K1_PRODUCTS >= 3) {
          mma_tf32(lh[j], al, bh[0], bh[1]);
          mma_tf32(hl[j], ah, bl[0], bl[1]);
        }
        if (K1_PRODUCTS >= 1) mma_tf32(acc[j], ah, bh[0], bh[1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] += hl[j][q] + lh[j][q];
}

// The bank loop of all three kernels.  Streams the block's bank tiles
// [t0, t1) through the two stages (the next tile in flight, its labels one
// tile ahead, while this one is computed), computes each tile's logits
// fragments for the warp's row block rg and anchor blocks [jb, jb + nj), and
// hands them to epi(acc, Cs, va, vb, la, lb): Cs is the tile's stage, va/la
// and vb/lb the validity and label of the lane's bank rows 16 rg + g and
// 16 rg + g + 8.  Every thread of the block calls it.
template <int NJ, class Epi>
__device__ __forceinline__ void bank_loop(float* stages, const float* As, int* cl_s, int* cv_s,
                                          const Plan& pl, const BankStream& bank,
                                          const int* __restrict__ c_l,
                                          const unsigned char* __restrict__ c_v, int K, int t0,
                                          int t1, int rg, int jb, int nj, Epi&& epi) {
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (t0 < t1) {
    bank.load(stages, t0 * ROWS);
    cp_async_commit();
    if (tid < ROWS) tile_labels(c_l, c_v, t0 * ROWS, K, cl_s[tid], cv_s[tid]);
  }
  for (int it = t0; it < t1; ++it) {
    const int b = (it - t0) & 1;
    const float* Cs = stages + b * pl.stage;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; stage and labels of tile it-1 are consumed
    const bool more = it + 1 < t1;
    int nl = 0, nv = 0;
    if (more) {  // tile it+1 streams in while this one is computed
      bank.load(stages + (b ^ 1) * pl.stage, (it + 1) * ROWS);
      cp_async_commit();
      if (tid < ROWS) tile_labels(c_l, c_v, (it + 1) * ROWS, K, nl, nv);
    }
    float acc[NJ][4];
    logits_tile<NJ>(Cs, As, pl.ld, pl.dp, rg, jb, nj, g, t, acc);
    const int ra = rg * 16 + g;
    const int* cl = cl_s + b * ROWS;
    const int* cv = cv_s + b * ROWS;
    epi(acc, Cs, (bool)cv[ra], (bool)cv[ra + 8], cl[ra], cl[ra + 8]);
    if (more && tid < ROWS) {
      cl_s[(b ^ 1) * ROWS + tid] = nl;
      cv_s[(b ^ 1) * ROWS + tid] = nv;
    }
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& ns, float& p, float om, float ons,
                                          float op) {
  const float nm = fmaxf(m, om);
  ns = ns * expf(m - nm) + ons * expf(om - nm);
  m = nm;
  p += op;
}

// K1a.  Block (chunk x, split y): the anchors [x mc, x mc + mc), mc = 8 NB,
// against the bank tiles of split y; writes (m, ns, p) partials.  Warp w
// takes bank rows [16 (w % 4), +16) of each tile and anchor column block
// w / 4 (two of them at NB = 8); each lane keeps a running (m, ns, p) for
// each of its columns over its two rows of every tile.
template <int NB>
__global__ void __launch_bounds__(pass1_warps(NB) * 32, 1)
pass1_tc(const float* __restrict__ a, const int* __restrict__ a_l,
         const float* __restrict__ c, const int* __restrict__ c_l,
         const unsigned char* __restrict__ c_v, float* __restrict__ m_part,
         float* __restrict__ ns_part, float* __restrict__ p_part, int M, int K, int D,
         int tiles_per_split, float inv_t, int vec) {
  constexpr int CG = pass1_warps(NB) / 4, MC = NB * 8, NJ = (NB + CG - 1) / CG;
  extern __shared__ float smem[];
  const Plan pl = plan(D, MC, false);
  float* stages = smem;
  float* As = stages + 2 * pl.stage;
  int* cl_s = reinterpret_cast<int*>(As + MC * pl.ld);  // [2][ROWS]
  int* cv_s = cl_s + 2 * ROWS;                           // [2][ROWS]
  int* al_s = cv_s + 2 * ROWS;                           // [MC]
  float* red = reinterpret_cast<float*>(al_s + 5 * MAX_MC);  // [3][4][MC]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, jb = (warp >> 2) * NJ, nj = min(NJ, NB - jb);
  const int c0 = blockIdx.x * MC, s = blockIdx.y;
  const int n_tiles = (K + ROWS - 1) / ROWS;
  const int t0 = s * tiles_per_split, t1 = min(t0 + tiles_per_split, n_tiles);

  load_anchors(As, stages, a, c0, M, D, MC, pl.ld);
  if (tid < MC) al_s[tid] = c0 + tid < M ? a_l[c0 + tid] : 0;

  float m_run[NJ][2], ns_run[NJ][2], p_run[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m_run[j][e] = NEG_INF;
      ns_run[j][e] = 0.f;
      p_run[j][e] = 0.f;
    }

  bank_loop<NJ>(stages, As, cl_s, cv_s, pl, BankStream(c, K, D, pl.ld, vec), c_l, c_v, K, t0,
                t1, rg, jb, nj,
                [&](const float (&acc)[NJ][4], const float*, bool va, bool vb, int la, int lb) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int al = al_s[(jb + j) * 8 + 2 * t + e];
        const float x0 = acc[j][e] * inv_t, x1 = acc[j][2 + e] * inv_t;
        float tmax = va ? x0 : NEG_INF;
        if (vb) tmax = fmaxf(tmax, x1);
        const float nm = fmaxf(m_run[j][e], tmax);
        float add = 0.f, pc = 0.f;
        if (va) {
          if (la == al) pc += 1.f;
          else add += expf(x0 - nm);
        }
        if (vb) {
          if (lb == al) pc += 1.f;
          else add += expf(x1 - nm);
        }
        ns_run[j][e] = ns_run[j][e] * expf(m_run[j][e] - nm) + add;
        m_run[j][e] = nm;
        p_run[j][e] += pc;
      }
    }
  });

  // Merge the 8 lanes (g) that share a column, then the 4 row groups in order.
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m_run[j][e], off);
        const float ons = __shfl_xor_sync(0xffffffffu, ns_run[j][e], off);
        const float op = __shfl_xor_sync(0xffffffffu, p_run[j][e], off);
        lse_merge(m_run[j][e], ns_run[j][e], p_run[j][e], om, ons, op);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = (jb + j) * 8 + 2 * t + e;
        red[rg * MC + col] = m_run[j][e];
        red[(4 + rg) * MC + col] = ns_run[j][e];
        red[(8 + rg) * MC + col] = p_run[j][e];
      }
    }
  }
  __syncthreads();
  if (tid < MC && c0 + tid < M) {
    float mm = red[tid], nn = red[4 * MC + tid], pp = red[8 * MC + tid];
    for (int q = 1; q < 4; ++q)
      lse_merge(mm, nn, pp, red[q * MC + tid], red[(4 + q) * MC + tid],
                red[(8 + q) * MC + tid]);
    m_part[(size_t)s * M + c0 + tid] = mm;
    ns_part[(size_t)s * M + c0 + tid] = nn;
    p_part[(size_t)s * M + c0 + tid] = pp;
  }
}

// K1b.  Blocks, warps and the bank loop of K1a; each lane sums s1 and t of
// its columns over the valid positives of its two rows of every tile, with
// the anchor's m and ns in registers.  Writes part[s][0][r] = s1 and
// part[s][1][r] = t of split s, so one sum_splits merges both.
template <int NB>
__global__ void __launch_bounds__(pass1_warps(NB) * 32, 1)
pass2_tc(const float* __restrict__ a, const int* __restrict__ a_l,
         const float* __restrict__ c, const int* __restrict__ c_l,
         const unsigned char* __restrict__ c_v, const float* __restrict__ m,
         const float* __restrict__ ns, float* __restrict__ part, int M, int K, int D,
         int tiles_per_split, float inv_t, int vec) {
  constexpr int CG = pass1_warps(NB) / 4, MC = NB * 8, NJ = (NB + CG - 1) / CG;
  extern __shared__ float smem[];
  const Plan pl = plan(D, MC, false);
  float* stages = smem;
  float* As = stages + 2 * pl.stage;
  int* cl_s = reinterpret_cast<int*>(As + MC * pl.ld);  // [2][ROWS]
  int* cv_s = cl_s + 2 * ROWS;                           // [2][ROWS]
  int* al_s = cv_s + 2 * ROWS;                           // [MC] each: label, m, ns
  float* m_s = reinterpret_cast<float*>(al_s + MAX_MC);
  float* ns_s = m_s + MAX_MC;
  float* red = reinterpret_cast<float*>(al_s + 5 * MAX_MC);  // [2][4][MC]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, jb = (warp >> 2) * NJ, nj = min(NJ, NB - jb);
  const int c0 = blockIdx.x * MC, s = blockIdx.y;
  const int n_tiles = (K + ROWS - 1) / ROWS;
  const int t0 = s * tiles_per_split, t1 = min(t0 + tiles_per_split, n_tiles);

  load_anchors(As, stages, a, c0, M, D, MC, pl.ld);
  if (tid < MC) {
    const bool in = c0 + tid < M;
    al_s[tid] = in ? a_l[c0 + tid] : 0;
    m_s[tid] = in ? m[c0 + tid] : 0.f;
    ns_s[tid] = in ? ns[c0 + tid] : 0.f;
  }
  __syncthreads();  // the epilogue reads the anchors' rows below before the loop's first sync
  int al[NJ][2];
  float mr[NJ][2], nsr[NJ][2], s1[NJ][2], tt[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = min(jb + j, NB - 1) * 8 + 2 * t + e;
      al[j][e] = al_s[col];
      mr[j][e] = m_s[col];
      nsr[j][e] = ns_s[col];
      s1[j][e] = tt[j][e] = 0.f;
    }

  bank_loop<NJ>(stages, As, cl_s, cv_s, pl, BankStream(c, K, D, pl.ld, vec), c_l, c_v, K, t0,
                t1, rg, jb, nj,
                [&](const float (&acc)[NJ][4], const float*, bool va, bool vb, int la, int lb) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? vb && lb == al[j][e] : va && la == al[j][e])) continue;
          const float sh = acc[j][2 * h + e] * inv_t - mr[j][e];
          const float denom = expf(sh) + nsr[j][e] + 1e-30f;
          s1[j][e] += sh - logf(denom);
          tt[j][e] += 1.f / denom;
        }
      }
    }
  });

  // Sum the 8 lanes (g) that share a column, then the 4 row groups in order.
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], off);
        tt[j][e] += __shfl_xor_sync(0xffffffffu, tt[j][e], off);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = (jb + j) * 8 + 2 * t + e;
        red[rg * MC + col] = s1[j][e];
        red[(4 + rg) * MC + col] = tt[j][e];
      }
    }
  }
  __syncthreads();
  if (tid < MC && c0 + tid < M) {
    float a1 = red[tid], a2 = red[4 * MC + tid];
    for (int q = 1; q < 4; ++q) {
      a1 += red[q * MC + tid];
      a2 += red[(4 + q) * MC + tid];
    }
    part[(size_t)(2 * s) * M + c0 + tid] = a1;
    part[(size_t)(2 * s + 1) * M + c0 + tid] = a2;
  }
}

// K1c.  Block (chunk x, split y) as in pass 1, with 16 warps (row block
// w % 4, anchor blocks from (w / 4) ceil(NB / 4)).  Per bank tile: the
// logits (as in pass 1), then dl / tau into P [ROWS][mc] in shared memory,
// then dA^T [D, mc] += C_tile^T P on the same stage, so the bank is read
// once.  Warp w owns the dA^T row block (d) w over all anchor columns, in
// registers across the block's K range; the block writes one [mc, D] partial.
template <int NB>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
bwd_tc(const float* __restrict__ a, const int* __restrict__ a_l,
       const float* __restrict__ c, const int* __restrict__ c_l,
       const unsigned char* __restrict__ c_v, const float* __restrict__ m,
       const float* __restrict__ ns, const float* __restrict__ t_in,
       const float* __restrict__ w_in, float* __restrict__ da_part, int M, int K, int D,
       int tiles_per_split, float inv_t, int vec) {
  constexpr int MC = NB * 8, NJ = (NB + 3) / 4;
  extern __shared__ float smem[];
  const Plan pl = plan(D, MC, true);
  float* stages = smem;
  float* As = stages + 2 * pl.stage;
  int* cl_s = reinterpret_cast<int*>(As + MC * pl.ld);  // [2][ROWS]
  int* cv_s = cl_s + 2 * ROWS;                           // [2][ROWS]
  int* al_s = cv_s + 2 * ROWS;                           // [MC] each, from here
  float* m_s = reinterpret_cast<float*>(al_s + MAX_MC);
  float* ns_s = m_s + MAX_MC;
  float* t_s = ns_s + MAX_MC;
  float* w_s = t_s + MAX_MC;
  float* P = w_s + MAX_MC;  // [ROWS][ldp]
  const int ld = pl.ld, ldp = pl.ldp;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, jb = (warp >> 2) * NJ, nj = min(NJ, NB - jb);
  const int c0 = blockIdx.x * MC, s = blockIdx.y;
  const int n_tiles = (K + ROWS - 1) / ROWS;
  const int t0 = s * tiles_per_split, t1 = min(t0 + tiles_per_split, n_tiles);
  const int nd = pl.dp / 16;  // dA^T row blocks of 16

  load_anchors(As, stages, a, c0, M, D, MC, ld);
  if (tid < MC) {  // anchors past M get w = 0, so dl = 0
    const int r = c0 + tid;
    const bool in = r < M;
    al_s[tid] = in ? a_l[r] : 0;
    m_s[tid] = in ? m[r] : 0.f;
    ns_s[tid] = in ? ns[r] : 0.f;
    t_s[tid] = in ? t_in[r] : 0.f;
    w_s[tid] = in ? w_in[r] : 0.f;
  }

  float dacc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) dacc[j][0] = dacc[j][1] = dacc[j][2] = dacc[j][3] = 0.f;

  bank_loop<NJ>(stages, As, cl_s, cv_s, pl, BankStream(c, K, D, ld, vec), c_l, c_v, K, t0, t1,
                rg, jb, nj,
                [&](const float (&acc)[NJ][4], const float* Cs, bool va, bool vb, int la,
                    int lb) {
    const int ra = rg * 16 + g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = ra + 8 * h;
        const bool valid = h ? vb : va;
        const int lab = h ? lb : la;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = (jb + j) * 8 + 2 * t + e;
          float dl = 0.f;
          if (valid) {
            const float ex = expf(acc[j][2 * h + e] * inv_t - m_s[col]);
            if (lab == al_s[col]) dl = w_s[col] * (1.f - ex / (ex + ns_s[col] + 1e-30f));
            else dl = -w_s[col] * t_s[col] * ex;
          }
          P[row * ldp + col] = dl * inv_t;
        }
      }
    }
    __syncthreads();  // P is complete

    // dA^T[d, j] += sum_n C[n, d] P[n, j].  The MMA's k index t runs over
    // tile row 2t and k index t+4 over row 2t+1 (a permutation of the sum):
    // with ld and ldp = 4 mod 8 these loads are conflict-free.
    if (warp >= nd) return;  // D < 256: fewer row blocks than warps
#pragma unroll 2
    for (int n0 = 0; n0 < ROWS; n0 += 8) {
      const float* pr = P + (n0 + 2 * t) * ldp + g;
      unsigned bh[NB][2], bl[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        split_tf32(pr[j * 8], bh[j][0], bl[j][0]);
        split_tf32(pr[ldp + j * 8], bh[j][1], bl[j][1]);
      }
      const float* cr = Cs + (n0 + 2 * t) * ld + warp * 16 + g;
      unsigned ah[4], al[4];
      split_tf32(cr[0], ah[0], al[0]);
      split_tf32(cr[8], ah[1], al[1]);
      split_tf32(cr[ld], ah[2], al[2]);
      split_tf32(cr[ld + 8], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_3xtf32(dacc[j], ah, al, bh[j], bl[j]);
    }
  });

  if (warp >= nd) return;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = warp * 16 + g + 8 * h, r = c0 + j * 8 + 2 * t + e;
        if (r < M && d < D) da_part[((size_t)s * M + r) * D + d] = dacc[j][2 * h + e];
      }
}

int check_args(int M, int K, int D, int S) {
  if (M <= 0 || K <= 0 || D <= 0 || D > MAX_D || S <= 0) return (int)cudaErrorInvalidValue;
  return 0;
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// The anchor chunking of all three kernels: ceil(M / MAX_MC) chunks of mc
// columns, mc a multiple of 8 (the MMA's column side).
int anchor_chunks(int M, int* mc) {
  const int n = (M + MAX_MC - 1) / MAX_MC;
  *mc = ((M + n - 1) / n + 7) / 8 * 8;
  return n;
}

// 16-byte bank copies need D % 4 == 0 and a 16-byte aligned bank.
int bank_vec(const float* c, int D) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

template <int NB>
int init_tc() {
  int err;
  if ((err = set_smem((const void*)pass1_tc<NB>, plan(MAX_D, NB * 8, false).bytes))) return err;
  if ((err = set_smem((const void*)pass2_tc<NB>, plan(MAX_D, NB * 8, false).bytes))) return err;
  return set_smem((const void*)bwd_tc<NB>, plan(MAX_D, NB * 8, true).bytes);
}

// One case per anchor chunk width mc = 8 NB.
#define K1_CHUNK_WIDTHS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

}  // namespace

extern "C" {

// Lets the tile kernels take the shared memory that D = MAX_D needs, on the
// current device.  0 on success.
int infonce_init() {
  int err;
#define K1_INIT(nb) \
  if ((err = init_tc<nb>())) return err;
  K1_CHUNK_WIDTHS(K1_INIT)
#undef K1_INIT
  return 0;
}

const char* infonce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1a.  Partials m_part/ns_part/p_part are [S, M]; outputs m/ns/p are [M].
int infonce_pass1(const float* a, const int* a_l, const float* c, const int* c_l,
                  const unsigned char* c_v, float* m_part, float* ns_part, float* p_part,
                  float* m, float* ns, float* p, int M, int K, int D, int S, float inv_t,
                  void* stream) {
  int err = check_args(M, K, D, S);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int mc;
  const dim3 grid(anchor_chunks(M, &mc), S);
  const size_t bytes = plan(D, mc, false).bytes;
  const int n_tiles = (K + ROWS - 1) / ROWS;
  const int tps = (n_tiles + S - 1) / S;
  const int vec = bank_vec(c, D);
  switch (mc / 8) {
#define K1_PASS1(nb)                                                                   \
  case nb:                                                                             \
    pass1_tc<nb><<<grid, pass1_warps(nb) * 32, bytes, st>>>(                          \
        a, a_l, c, c_l, c_v, m_part, ns_part, p_part, M, K, D, tps, inv_t, vec);        \
    break;
    K1_CHUNK_WIDTHS(K1_PASS1)
#undef K1_PASS1
  }
  if ((err = (int)cudaGetLastError())) return err;
  pass1_merge<<<(M + 255) / 256, 256, 0, st>>>(m_part, ns_part, p_part, m, ns, p, M, S);
  return (int)cudaGetLastError();
}

// K1b.  Partials part are [S, 2, M]; output out is [2, M]: s1, then t.
int infonce_pass2(const float* a, const int* a_l, const float* c, const int* c_l,
                  const unsigned char* c_v, const float* m, const float* ns, float* part,
                  float* out, int M, int K, int D, int S, float inv_t, void* stream) {
  int err = check_args(M, K, D, S);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int mc;
  const dim3 grid(anchor_chunks(M, &mc), S);
  const size_t bytes = plan(D, mc, false).bytes;
  const int n_tiles = (K + ROWS - 1) / ROWS;
  const int tps = (n_tiles + S - 1) / S;
  const int vec = bank_vec(c, D);
  switch (mc / 8) {
#define K1_PASS2(nb)                                                                   \
  case nb:                                                                             \
    pass2_tc<nb><<<grid, pass1_warps(nb) * 32, bytes, st>>>(                          \
        a, a_l, c, c_l, c_v, m, ns, part, M, K, D, tps, inv_t, vec);                   \
    break;
    K1_CHUNK_WIDTHS(K1_PASS2)
#undef K1_PASS2
  }
  if ((err = (int)cudaGetLastError())) return err;
  sum_splits<<<(2 * M + 255) / 256, 256, 0, st>>>(part, out, 2 * M, S);
  return (int)cudaGetLastError();
}

// K1c.  Partials da_part are [S, M, D]; output da is [M, D].
int infonce_bwd(const float* a, const int* a_l, const float* c, const int* c_l,
                const unsigned char* c_v, const float* m, const float* ns, const float* t,
                const float* w, float* da_part, float* da, int M, int K, int D, int S,
                float inv_t, void* stream) {
  int err = check_args(M, K, D, S);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int mc;
  const dim3 grid(anchor_chunks(M, &mc), S);
  const size_t bytes = plan(D, mc, true).bytes;
  const int n_tiles = (K + ROWS - 1) / ROWS;
  const int tps = (n_tiles + S - 1) / S;
  const int vec = bank_vec(c, D);
  switch (mc / 8) {
#define K1_BWD(nb)                                                                     \
  case nb:                                                                             \
    bwd_tc<nb><<<grid, BWD_WARPS * 32, bytes, st>>>(a, a_l, c, c_l, c_v, m, ns, t, w,   \
                                                    da_part, M, K, D, tps, inv_t, vec); \
    break;
    K1_CHUNK_WIDTHS(K1_BWD)
#undef K1_BWD
  }
  if ((err = (int)cudaGetLastError())) return err;
  const int n = M * D;
  sum_splits<<<(n + 255) / 256, 256, 0, st>>>(da_part, da, n, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
