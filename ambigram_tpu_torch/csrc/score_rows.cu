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
// Two paths, chosen by the wrapper before launch from the representation:
//
// 1. The int8 path (`score_rows_i8_launch`), whenever the program's rows are
//    int8-exact. Then H = w * H8 row-wise, with w in {0, 0.5, 1, 1024} and
//    |H8| <= 2, and the kernel reads H8 (a quarter of H's bytes) and w:
//
//        hx_int[b, r] = sum_k X[b, k] * H8[r, k]     (int32, tensor cores)
//        hx[b, r]     = w[r] * float(hx_int[b, r])
//
//    X holds non-negative integers (the search's candidates); a first small
//    kernel truncates them to one u8 plane (X <= 255) or two (X = 256 hi +
//    lo, X <= 65535), and mma.sync m16n8k32 (s8 rows x u8 candidates, s32
//    accumulators) forms the products. The wrapper checks that
//    ceil(max X) * max|H8| * Vp < 2^24, so hx_int converts to f32 exactly, and
//    w is 0 or a power of two, so hx is bitwise equal to the f32 product of
//    H, whose partial sums are all w times an integer below 2^24.
//
//    What bounds it (S=48: Rows 8192, Vp 2432, B 32): reading H8, 19.9 MB
//    (6 us at 3.35 TB/s); the int8 products are 1.3 GOP (under 1 us at
//    1979 TOP/s). Each block streams its [64 rows x Vp] slice of H8 and the
//    candidates' planes through a 6-stage cp.async ring, so loads stay in
//    flight while the tensor cores run; 128 row tiles at S=48 fill 128 of the
//    132 SMs at B=32. The tile layout in shared memory is read without bank
//    conflicts: each thread's fragment is one 16-byte load, and the k order
//    inside a 64-byte stage is permuted alike for rows and candidates (the
//    integer sum does not depend on it).
//
// 2. The f32 path (`score_rows_launch`), unchanged, for programs whose rows
//    are not int8-exact (a fractional coefficient other than 0.5) or whose
//    shape or candidate box the int8 path does not take: f32 FFMA on the
//    CUDA cores. With small dyadic H entries and small non-negative integer
//    candidates each product and partial sum is exact in f32 in any order,
//    so hx is again bitwise equal to any exact f32 product. No TF32 and no
//    bf16 tensor cores, which would round.
//
// The hinge sums are exact while a candidate's score stays on the 0.5 lattice
// below 2^23, as the search's near-feasible candidates do on integer targets.
// The open bounds are +-3e38, finite, so their hinges are 0 and never inf.
//
// Layout. The TPU grid walked the row tiles in order on one core and carried
// each score in VMEM across them. Here blocks run in parallel and in no
// order: each block forms one [64 rows x 32 candidates] tile of hx, reduces
// its hinges per candidate, and writes one partial per (row tile, candidate).
// A second small kernel sums the partials over the row tiles in a fixed
// order. No atomics, so a result does not depend on scheduling. The f32 path
// masks ragged B, Rows and Vp; the int8 path takes Rows and Vp in multiples
// of 64 (as `scoring_tensors` pads them) and masks ragged B.

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

// The second pass of both paths: one warp per candidate sums its row tiles'
// partials, lane l taking tiles l, l + 32, ... in order, then a fixed
// shuffle tree. A fixed order, so the scores do not depend on scheduling.
__global__ void score_rows_sum(const float* __restrict__ partial,
                               float* __restrict__ scores, int B, int n_tiles) {
  const int b = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (b >= B) return;
  const size_t g = blockIdx.y;  // case
  partial += g * n_tiles * (size_t)B;
  float s = 0.f;
  for (int t = lane; t < n_tiles; t += 32) s += partial[(size_t)t * B + b];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) scores[g * B + b] = s;
}

// ------------------------------------------------------------ the int8 path

constexpr int I8_BM = 64;       // rows per block: 4 warps x 16
constexpr int I8_BN = 32;       // candidates per block: 4 mma n-tiles of 8
constexpr int I8_BK = 64;       // bytes of K per stage: 2 mma k-steps of 32
constexpr int I8_STAGES = 6;    // cp.async ring depth
constexpr int I8_THREADS = 128;

template <int P>
__host__ __device__ constexpr int i8_stage_bytes() { return I8_BM * I8_BK + P * I8_BN * I8_BK; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a (16 x 32, s8, row-major) * b (32 x 8, u8, column-major), s32
__device__ __forceinline__ void mma_s8u8(int (&d)[4], unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// X f32 [cases, B, vp] -> P u8 planes [cases, P, Bp, vp] (plane 0 the low
// byte, plane 1 the high byte), zero for the padding candidates b >= B.
template <int P>
__global__ void x_to_planes(const float* __restrict__ X,
                            unsigned char* __restrict__ Xq, int B, int Bp,
                            int vp) {
  const size_t g = blockIdx.y;  // case
  X += g * B * (size_t)vp;
  Xq += g * P * (size_t)Bp * vp;
  const int n4 = Bp * vp / 4;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n4;
       e += gridDim.x * blockDim.x) {
    const int b = e / (vp / 4), k = 4 * (e % (vp / 4));
    unsigned u[4] = {0u, 0u, 0u, 0u};
    if (b < B) {
      const float4 v = *reinterpret_cast<const float4*>(X + (size_t)b * vp + k);
      u[0] = static_cast<unsigned>(__float2int_rz(v.x));
      u[1] = static_cast<unsigned>(__float2int_rz(v.y));
      u[2] = static_cast<unsigned>(__float2int_rz(v.z));
      u[3] = static_cast<unsigned>(__float2int_rz(v.w));
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const unsigned word = ((u[0] >> (8 * p)) & 0xffu) |
                            (((u[1] >> (8 * p)) & 0xffu) << 8) |
                            (((u[2] >> (8 * p)) & 0xffu) << 16) |
                            (((u[3] >> (8 * p)) & 0xffu) << 24);
      *reinterpret_cast<unsigned*>(Xq + ((size_t)p * Bp + b) * vp + k) = word;
    }
  }
}

template <int P>
__global__ void __launch_bounds__(I8_THREADS)
score_rows_i8(const signed char* __restrict__ H8, const float* __restrict__ w,
              const float* __restrict__ lb, const float* __restrict__ ub,
              const unsigned char* __restrict__ Xq, float* __restrict__ hx_out,
              float* __restrict__ partial, int B, int Bp, int rows, int vp) {
  constexpr int H_BYTES = I8_BM * I8_BK;
  constexpr int STAGE = i8_stage_bytes<P>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[I8_THREADS / 32][I8_BN];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row group, column pair
  const int r0 = blockIdx.x * I8_BM;
  const int b0 = blockIdx.y * I8_BN;
  const size_t g = blockIdx.z;  // case
  H8 += g * rows * (size_t)vp;
  w += g * rows;
  lb += g * rows;
  ub += g * rows;
  Xq += g * P * (size_t)Bp * vp;
  if (hx_out != nullptr) hx_out += g * B * (size_t)rows;
  partial += g * gridDim.x * (size_t)B;
  const int nk = vp / I8_BK;

  // one stage: H8 rows [r0, r0 + 64) and the block's candidates, bytes
  // [64 kc, 64 kc + 64) of each, 16 bytes per cp.async
  auto load_stage = [&](int kc) {
    unsigned char* dst = smem + (kc % I8_STAGES) * STAGE;
    const int k0 = kc * I8_BK;
    for (int e = tid; e < H_BYTES / 16; e += I8_THREADS) {
      const int row = e >> 2, seg = e & 3;
      cp_async16(dst + row * I8_BK + seg * 16,
                 H8 + (size_t)(r0 + row) * vp + k0 + seg * 16);
    }
    for (int e = tid; e < P * I8_BN * 4; e += I8_THREADS) {
      const int pc = e >> 2, seg = e & 3;  // pc = plane * I8_BN + candidate
      const int p = pc / I8_BN, c = pc % I8_BN;
      cp_async16(dst + H_BYTES + pc * I8_BK + seg * 16,
                 Xq + ((size_t)p * Bp + b0 + c) * vp + k0 + seg * 16);
    }
  };

  int acc[P][4][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][j][q] = 0;

#pragma unroll
  for (int s = 0; s < I8_STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<I8_STAGES - 2>();  // stage kc has landed
    __syncthreads();                 // ... for every thread; stage kc-1 is free
    if (kc + I8_STAGES - 1 < nk) load_stage(kc + I8_STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (kc % I8_STAGES) * STAGE;
    // Thread (gq, tq) holds bytes [16 tq, 16 tq + 16) of rows gq and gq + 8
    // of its warp's 16 and of candidate gq of each n-tile. mma k-step 0 takes
    // words 0-1 as its k ranges [4 tq, 4 tq + 4) and [16 + 4 tq, 20 + 4 tq),
    // k-step 1 takes words 2-3: the same permutation of k for both operands.
    const uint4 ha = *reinterpret_cast<const uint4*>(st + (warp * 16 + gq) * I8_BK + tq * 16);
    const uint4 hb = *reinterpret_cast<const uint4*>(st + (warp * 16 + gq + 8) * I8_BK + tq * 16);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 xv = *reinterpret_cast<const uint4*>(
            st + H_BYTES + (p * I8_BN + j * 8 + gq) * I8_BK + tq * 16);
        mma_s8u8(acc[p][j], ha.x, hb.x, ha.y, hb.y, xv.x, xv.y);
        mma_s8u8(acc[p][j], ha.z, hb.z, ha.w, hb.w, xv.z, xv.w);
      }
  }

  // acc[p][j][q]: row gq + 8 (q >> 1) of the warp's 16, candidate
  // 8 j + 2 tq + (q & 1) of the block's 32
  float part[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) part[j][0] = part[j][1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + gq + 8 * h;
    const float wr = w[r], lo = lb[r], hi = ub[r];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = 2 * h + c;
        const int v = P == 2 ? acc[0][j][q] + 256 * acc[P - 1][j][q] : acc[0][j][q];
        const float x = wr * static_cast<float>(v);  // exact: |v| < 2^24
        const int b = b0 + j * 8 + 2 * tq + c;
        if (b < B) {
          if (hx_out != nullptr) hx_out[(size_t)b * rows + r] = x;
          part[j][c] += fmaxf(x - hi, 0.f) + fmaxf(lo - x, 0.f);
        }
      }
  }
  // the 8 lanes sharing tq hold the warp's 16 rows of the same candidates
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        part[j][c] += __shfl_xor_sync(0xffffffffu, part[j][c], off);
      if (gq == 0) red[warp][j * 8 + 2 * tq + c] = part[j][c];
    }
  __syncthreads();
  if (tid < I8_BN && b0 + tid < B)
    partial[(size_t)blockIdx.x * B + b0 + tid] =
        ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
}

template <int P>
cudaError_t launch_i8(const signed char* H8, const float* w, const float* lb,
                      const float* ub, const float* X, unsigned char* Xq,
                      float* hx_out, float* partial, float* scores, int cases,
                      int B, int Bp, int rows, int vp, cudaStream_t s) {
  const int n4 = Bp * vp / 4;
  const int blocks = (n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024;
  x_to_planes<P><<<dim3(blocks, cases), 256, 0, s>>>(X, Xq, B, Bp, vp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = I8_STAGES * i8_stage_bytes<P>();
  // the attribute outlives the launch: set it once per device
  static unsigned long long smem_set = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(smem_set >> dev & 1ull)) {
    err = cudaFuncSetAttribute(score_rows_i8<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set |= 1ull << dev;
  }
  const dim3 grid(rows / I8_BM, Bp / I8_BN, cases);
  score_rows_i8<P><<<grid, I8_THREADS, smem, s>>>(H8, w, lb, ub, Xq, hx_out, partial, B, Bp, rows, vp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  score_rows_sum<<<dim3((B + 7) / 8, cases), 256, 0, s>>>(partial, scores, B, static_cast<int>(grid.x));
  return cudaGetLastError();
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
  score_rows_sum<<<dim3((B + 7) / 8, cases), 256, 0, s>>>(
      partial, scores, B, static_cast<int>(grid.x));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch the int8 path needs: the row tiles' partials [cases,
// tiles, B] (f32), then the candidates' planes Xq [cases, planes, Bp, vp]
// (u8, B padded to whole blocks), 256-byte aligned.
long long score_rows_i8_scratch_bytes(int cases, int B, int rows, int vp, int planes) {
  const long long part = ((long long)cases * (rows / I8_BM) * B * 4 + 255) / 256 * 256;
  const long long Bp = (B + I8_BN - 1) / I8_BN * I8_BN;
  return part + (long long)cases * planes * Bp * vp;
}

// The int8 path. H8 [cases, rows, vp] int8, w/lb/ub [cases, rows] f32, X
// [cases, B, vp] f32 holding integers in [0, 256^planes); rows and vp
// multiples of 64, planes 1 or 2; scratch of score_rows_i8_scratch_bytes,
// 256-byte aligned. hx_out may be null. Returns the cudaError_t of the
// launches (0 when all were accepted).
int score_rows_i8_launch(const signed char* H8, const float* w, const float* lb,
                         const float* ub, const float* X, void* scratch,
                         float* hx_out, float* scores, int cases, int B,
                         int rows, int vp, int planes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows % I8_BM || vp % I8_BK) return static_cast<int>(cudaErrorInvalidValue);
  const int Bp = (B + I8_BN - 1) / I8_BN * I8_BN;
  float* partial = static_cast<float*>(scratch);
  unsigned char* Xq = static_cast<unsigned char*>(scratch) +
                      ((long long)cases * (rows / I8_BM) * B * 4 + 255) / 256 * 256;
  switch (planes) {
    case 1:
      return static_cast<int>(launch_i8<1>(H8, w, lb, ub, X, Xq, hx_out, partial, scores, cases, B, Bp, rows, vp, s));
    case 2:
      return static_cast<int>(launch_i8<2>(H8, w, lb, ub, X, Xq, hx_out, partial, scores, cases, B, Bp, rows, vp, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* score_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
