// K1: batched candidate scoring, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_score_kernel` in
// ambigram_tpu/solver/score.py (launched by `score_batch_pallas`). For
// candidates X [B, Vp] and the prescaled row matrix H [Rows, Vp] it computes
//
//     hx[b, r]  = sum_k X[b, k] * H[r, k]
//     scores[b] = sum_r max(hx[b, r] - ub[r], 0) + max(lb[r] - hx[b, r], 0)
//
// and, when asked, stores the hx tile it has formed anyway into hx_out
// [B, Rows]: the search threads hx through its sweeps. A leading case axis
// (H [G, Rows, Vp], lb/ub [G, Rows], X [G, B, Vp]) is the grid's z dimension:
// the case-stacked batch search rescores every case of a group in one launch,
// and each case computes exactly what a single-case launch computes.
//
// Exactness decides the arithmetic. Every H entry is a small integer, a
// multiple of 0.5, or PENALTY (1024) times a small integer; every X entry is
// a small non-negative integer. Each product and each partial sum of a row
// value is therefore exact in f32, in any order, and hx is bitwise equal to
// any exact f32 product. So this kernel uses plain f32 FFMA on the CUDA cores:
// no TF32 and no bf16 tensor cores, which would round. The hinge sums are
// exact too while a candidate's score stays on the 0.5 lattice below 2^23,
// as the search's near-feasible candidates do. The open bounds are +-3e38,
// finite, so their hinges are 0 and never inf.
//
// Layout. The TPU grid walked the row tiles in order on one core and carried
// each score in VMEM across them. Here blocks run in parallel and in no
// order: each block forms one [BR rows x BB candidates] tile of hx from
// shared-memory stages of H and X, reduces its hinges per candidate, and
// writes one partial per (row tile, candidate). A second small kernel sums
// the partials over the row tiles in a fixed order. No atomics, so a result
// does not depend on scheduling. Ragged B, Rows and Vp are masked.
//
// What bounds it at the search's shape (S=48: Rows 8192, Vp 2432, B 32): one
// pass over the 80 MB of H, which is larger than the 50 MB L2, plus
// 2*B*Rows*Vp = 1.3 GFLOP of FFMA. It runs 1 + rounds times per solve (once
// at the start and once after each kick); the sweeps do the rest.

#include <cuda_runtime.h>

namespace {

constexpr int BR = 64;            // rows per block
constexpr int BB = 32;            // candidates per block
constexpr int BK = 32;            // depth of one shared-memory stage
constexpr int TR = 16;            // threads along rows
constexpr int TB = 16;            // threads along candidates
constexpr int RPT = BR / TR;      // rows per thread
constexpr int CPT = BB / TB;      // candidates per thread
constexpr int THREADS = TR * TB;  // 256

// 6 resident blocks per SM cap the kernel at 40 registers. With the thread
// count alone ptxas held it to 32, and the case axis's pointer offsets then
// spilled: 0.43 ms at S=48, B=32 against 0.22 ms with this bound (H100 80GB HBM3).
__global__ void __launch_bounds__(THREADS, 6)
score_rows_tile(const float* __restrict__ H, const float* __restrict__ lb,
                const float* __restrict__ ub, const float* __restrict__ X,
                float* __restrict__ hx_out, float* __restrict__ partial, int B,
                int rows, int vp) {
  // +1 column: the transposing stores below hit 32 different banks
  __shared__ float Hs[BK][BR + 1];
  __shared__ float Xs[BK][BB + 1];
  const int tid = threadIdx.x;
  const int tr = tid % TR;  // this thread's rows: r0 + tr + i * TR
  const int tb = tid / TR;  // this thread's candidates: b0 + tb + j * TB
  const int r0 = blockIdx.x * BR;
  const int b0 = blockIdx.y * BB;
  const size_t g = blockIdx.z;  // case
  H += g * rows * vp;
  lb += g * rows;
  ub += g * rows;
  X += g * B * vp;
  if (hx_out != nullptr) hx_out += g * B * rows;
  partial += g * gridDim.x * B;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < vp; k0 += BK) {
    // neighbouring threads read neighbouring k of one row: coalesced
    for (int e = tid; e < BR * BK; e += THREADS) {
      const int rr = e / BK, kk = e % BK;
      const int r = r0 + rr, k = k0 + kk;
      Hs[kk][rr] = (r < rows && k < vp) ? H[(size_t)r * vp + k] : 0.f;
    }
    for (int e = tid; e < BB * BK; e += THREADS) {
      const int bb = e / BK, kk = e % BK;
      const int b = b0 + bb, k = k0 + kk;
      Xs[kk][bb] = (b < B && k < vp) ? X[(size_t)b * vp + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float h[RPT], x[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) h[i] = Hs[kk][tr + i * TR];
#pragma unroll
      for (int j = 0; j < CPT; ++j) x[j] = Xs[kk][tb + j * TB];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(h[i], x[j], acc[i][j]);
    }
    __syncthreads();
  }

  float part[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) part[j] = 0.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + tr + i * TR;
    if (r >= rows) continue;
    const float lo = lb[r], hi = ub[r];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int b = b0 + tb + j * TB;
      if (b >= B) continue;
      const float v = acc[i][j];
      if (hx_out != nullptr) hx_out[(size_t)b * rows + r] = v;
      part[j] += fmaxf(v - hi, 0.f) + fmaxf(lo - v, 0.f);
    }
  }
  // the TR threads sharing a candidate lane are 16 neighbouring lanes of one
  // warp (tid = tb * TR + tr): reduce across them with shuffles
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int off = TR / 2; off > 0; off >>= 1)
      part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
  if (tr == 0) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int b = b0 + tb + j * TB;
      if (b < B) partial[(size_t)blockIdx.x * B + b] = part[j];
    }
  }
}

__global__ void score_rows_sum(const float* __restrict__ partial,
                               float* __restrict__ scores, int B, int n_tiles) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t g = blockIdx.y;  // case
  partial += g * n_tiles * B;
  scores += g * B;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(size_t)t * B + b];
  scores[b] = s;
}

}  // namespace

extern "C" {

// Row tiles of the first pass: the wrapper sizes `partial` [cases, tiles, B].
int score_rows_num_tiles(int rows) { return (rows + BR - 1) / BR; }

// All pointers are device pointers; hx_out may be null. `cases` is the
// leading case axis (1 for a single case). Returns the cudaError_t of the
// launches (0 when both were accepted).
int score_rows_launch(const float* H, const float* lb, const float* ub,
                      const float* X, float* hx_out, float* partial,
                      float* scores, int cases, int B, int rows, int vp,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(score_rows_num_tiles(rows), (B + BB - 1) / BB, cases);
  score_rows_tile<<<grid, THREADS, 0, s>>>(H, lb, ub, X, hx_out, partial, B,
                                           rows, vp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  score_rows_sum<<<dim3((B + 255) / 256, cases), 256, 0, s>>>(
      partial, scores, B, static_cast<int>(grid.x));
  return static_cast<int>(cudaGetLastError());
}

const char* score_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
