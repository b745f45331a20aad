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
// 2. The f32 path (`score_rows_launch`), for programs whose rows are not
//    int8-exact (a fractional coefficient other than 0.5) or whose shape or
//    candidate box the int8 path does not take: the Pallas kernel's own
//    arithmetic, hx as an f32 product of X and H, in FFMA on the CUDA cores.
//    No TF32 and no bf16 tensor cores, which would round. With small dyadic
//    H entries and small non-negative integer candidates every product and
//    partial sum is w times an integer below 2^24, exact in f32 in any order,
//    so hx is bitwise equal to any f32 product; where a row value can pass
//    2^24 (the big leg's recipe at S=120) every order rounds differently.
//
//    What bounds it: reading H, 4 * Rows * Vp bytes, and 2 B Rows Vp FFMA
//    operations (67 TFLOP/s). At B=32 the two are close (S=128: 3.80 GB of H,
//    1.14 ms at 3.35 TB/s; 60.9 GFLOP, 0.91 ms), so the kernel has to stream
//    H near the memory's rate and keep the FFMA pipes busy at once; at
//    B=1000 the FFMAs bound it. One product kernel in three shapes, chosen
//    from B by a fixed rule, each thread holding 8 rows x 16 candidates of
//    the product in registers (24 float4 reads of shared memory per 512
//    FFMAs), H and the candidates' k-slice fed through a cp.async ring:
//
//    - B <= 32: 512 rows x 32 candidates a block, 128 threads, two blocks a
//      SM, 8-deep stages in a 4-stage ring; the candidates' reads are
//      warp-wide broadcasts, and X (2.1 MB at S=128) comes from L2;
//    - B <= 64: 256 rows x 64 candidates, the same;
//    - B > 64: 128 rows x 256 candidates, 256 threads, one block a SM (the
//      8 x 16 tile takes 250 registers), 32-deep stages in a 3-stage ring.
//      Candidate tiles run fastest, so the blocks that run together share
//      their rows of H in L2 and H leaves the memory about once.
//
//    Where the tiles are too few to fill the card's resident blocks (S=48:
//    16 row tiles at B=32), k is cut into a fixed number of slices of at
//    least 128 (a function of B, Rows and Vp, never of the case count).
//    Each block writes its slice's raw row sums; a finishing pass sums the
//    slices in slice order, and only then takes the hinge, which needs the
//    whole row value.
//
//    What holds it above its bound (H100 80GB HBM3; ncu does not run where
//    it was measured): at B=1000 the FFMAs run at about 60% of their peak.
//    If a warp's float4 read of shared memory takes four wavefronts (one per
//    quarter warp), the 24 reads per 512 FFMAs use three quarters of the
//    SM's shared-memory bandwidth, and the two would have to overlap fully;
//    a register tile larger than 8 x 16 does not fit in 255 registers. At B=32 HBM (1.8 TB/s of
//    3.35) and the FFMAs (44%) are each about half used.
//
// The hinge sums are exact while a candidate's score stays on the 0.5 lattice
// below 2^23, as the search's near-feasible candidates do on integer targets.
// The open bounds are +-3e38, finite, so their hinges are 0 and never inf.
//
// Layout. The TPU grid walked the row tiles in order on one core and carried
// each score in VMEM across them. Here blocks run in parallel and in no
// order: on the int8 path each block, on the f32 path the finishing pass,
// reduces one row tile's hinges per candidate into one partial per (row
// tile, candidate). A second small kernel sums the partials over the row
// tiles in a fixed order. No atomics, so a result does not depend on
// scheduling. The f32 path masks ragged B, Rows and Vp (a Vp that is not a
// multiple of 4, or an operand that is not 16-byte aligned, takes 4-byte
// copies); the int8 path takes Rows and Vp in multiples of 64 (as
// `scoring_tensors` pads them) and masks ragged B.

#include <cuda_runtime.h>

namespace {

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

// ------------------------------------------------------------- the f32 path

constexpr int F_KALIGN = 32;        // k-slices start at multiples of every stage depth
constexpr int F_FT = 128;           // rows per tile of the finishing pass (4 per lane)
constexpr int F_MIN_SLICE = 128;    // the shortest k-slice worth a block

// 16 bytes (aligned rows) or one float per cp.async; `n` of them are real,
// the rest of the destination is zero-filled (ragged rows, k or candidates).
// A stage reads 32 bytes of each of 512 rows at B <= 32: the L2 fetches the
// whole 128-byte line on a miss, so the next three stages find it there
// (1.95 against 2.14 ms at S=128, B=32 on an H100 80GB HBM3).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int n_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, int n_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n_bytes) : "memory");
}

// One stage of an NR-row operand: rows [r0, r0 + NR) of the row-major
// M [nrows, vp], floats [k0, k0 + BK) of each, into dst [NR][BK + 4]; zero
// past nrows and past kend. AL: vp % 4 == 0 and M 16-byte aligned, so every
// 16-byte chunk of a row lies wholly inside or outside [k0, kend).
template <int NR, int NT, int BK, bool AL>
__device__ __forceinline__ void f32_load_tile(float* dst, const float* M, int r0, int nrows,
                                              int k0, int kend, int vp, int tid) {
  constexpr int LD = BK + 4;
  if (AL) {
#pragma unroll
    for (int e = tid; e < NR * (BK / 4); e += NT) {
      const int rr = e / (BK / 4), k = k0 + 4 * (e % (BK / 4));
      const bool in = r0 + rr < nrows && k < kend;
      cp_async16_zfill(dst + rr * LD + (k - k0), in ? M + (size_t)(r0 + rr) * vp + k : M, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < NR * BK; e += NT) {
      const int rr = e / BK, k = k0 + e % BK;
      const bool in = r0 + rr < nrows && k < kend;
      cp_async4_zfill(dst + rr * LD + (k - k0), in ? M + (size_t)(r0 + rr) * vp + k : M, in ? 4 : 0);
    }
  }
}

// The product kernel: a block forms a BM-row x BN-candidate tile of the raw
// row sums over one k-slice, a thread 8 rows x 16 candidates of it (rows
// tr + (BM / 8) i, candidates tc + (BN / 16) j), so every float4 of H or X
// read from shared memory feeds 32 or 64 FFMAs: 24 float4 reads per 512
// FFMAs. The shapes are in F32_SHAPES below. In the first two (B <= 64) the
// 32 lanes of a warp take 32 neighbouring rows and the same candidates
// (their X reads are broadcasts); in the third a quarter warp takes 8
// neighbouring rows and one candidate. Either way the float4
// reads of a quarter warp hit distinct banks. Block (candidate tile, row
// tile, case * slices) writes its slice's sums into P [cases * slices, B,
// rows]; candidate tiles run fastest, so the blocks that run together share
// their rows of H in L2.
template <int BM, int BN, int THREADS, int MIN_BLOCKS, int BK, int STAGES, bool AL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
score_rows_f32_product(const float* __restrict__ H, const float* __restrict__ X,
                       float* __restrict__ P, int B, int rows, int vp, int klen,
                       int slices) {
  constexpr int RT = 8, CT = 16, RS = BM / RT, CS = BN / CT;
  static_assert(RS * CS == THREADS, "one thread per 8 x 16 results");
  constexpr int LD = BK + 4;  // padded: 8 neighbouring rows start in distinct banks
  constexpr int H_FL = BM * LD, STAGE = H_FL + BN * LD;
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x;
  int tr, tc;
  if constexpr (RS >= 32) {
    tr = tid % RS;
    tc = tid / RS;
  } else {  // RS == 16: lanes 0-7 rows, lanes 8-31 candidates, then warps
    tr = (tid & 7) | ((tid >> 5) & 1) << 3;
    tc = ((tid >> 3) & 3) | (tid >> 6) << 2;
  }
  const int b0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const size_t g = blockIdx.z / slices;  // case
  const int kbeg = (blockIdx.z % slices) * klen, kend = min(vp, kbeg + klen);
  H += g * rows * (size_t)vp;
  X += (g * B + b0) * (size_t)vp;
  P += blockIdx.z * (size_t)B * rows;
  const int nk = (kend - kbeg + BK - 1) / BK;

  auto load_stage = [&](int kc) {
    float* dst = fsm + (kc % STAGES) * STAGE;
    const int k0 = kbeg + kc * BK;
    f32_load_tile<BM, THREADS, BK, AL>(dst, H, r0, rows, k0, kend, vp, tid);
    f32_load_tile<BN, THREADS, BK, AL>(dst + H_FL, X, 0, B - b0, k0, kend, vp, tid);
  };

  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();  // stage kc has landed
    __syncthreads();              // ... for every thread; stage kc-1 is free
    if (kc + STAGES - 1 < nk) load_stage(kc + STAGES - 1);
    cp_async_commit();
    const float* hs = fsm + (kc % STAGES) * STAGE + tr * LD;
    const float* xs = fsm + (kc % STAGES) * STAGE + H_FL + tc * LD;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 h[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) h[i] = *reinterpret_cast<const float4*>(hs + i * RS * LD + kq);
      // k in order for every accumulator; the 8 rows' FFMAs of one k are
      // independent, so the pipe never waits on the one before
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(xs + j * CS * LD + kq);
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][j] = fmaf(h[i].x, x.x, acc[i][j]);
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][j] = fmaf(h[i].y, x.y, acc[i][j]);
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][j] = fmaf(h[i].z, x.z, acc[i][j]);
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][j] = fmaf(h[i].w, x.w, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int b = b0 + tc + CS * j;
    if (b >= B) continue;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = r0 + tr + RS * i;
      if (r < rows) P[(size_t)b * rows + r] = acc[i][j];
    }
  }
}

// The finishing pass: warp w of block (candidate group, tile, case) takes
// candidate 8 group + w and the tile's 128 rows, lane l rows l, l + 32, ...
// For each row it sums the slices' raw sums in slice order, stores hx when
// asked and takes the hinge; the lane adds its 4 hinges in row order, and a
// fixed shuffle tree the warp's into partial [cases, tiles, B].
__global__ void __launch_bounds__(256)
score_rows_f32_finish(const float* __restrict__ P, const float* __restrict__ lb,
                      const float* __restrict__ ub, float* __restrict__ hx_out,
                      float* __restrict__ partial, int B, int rows, int slices) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const size_t g = blockIdx.z;  // case
  P += g * slices * (size_t)B * rows;
  float h = 0.f;
#pragma unroll
  for (int q = 0; q < F_FT / 32; ++q) {
    const int r = blockIdx.y * F_FT + q * 32 + lane;
    if (r < rows) {
      float v = P[(size_t)b * rows + r];
      for (int s = 1; s < slices; ++s) v += P[((size_t)s * B + b) * rows + r];
      if (hx_out != nullptr) hx_out[(g * B + b) * (size_t)rows + r] = v;
      h += fmaxf(v - ub[g * rows + r], 0.f) + fmaxf(lb[g * rows + r] - v, 0.f);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) h += __shfl_xor_sync(0xffffffffu, h, off);
  if (lane == 0) partial[(g * gridDim.y + blockIdx.y) * (size_t)B + b] = h;
}

// The product kernel's shapes: rows x candidates a block, threads, the
// blocks a SM its registers allow, stage depth, ring stages. The first
// shape that holds every candidate takes the launch, else the last.
struct F32Shape {
  int bm, bn, threads, min_blocks, bk, stages;
};
constexpr F32Shape F32_SHAPES[3] = {{512, 32, 128, 2, 8, 4}, {256, 64, 128, 2, 8, 4}, {128, 256, 256, 1, 32, 3}};

// How the f32 path cuts one launch: the product kernel's shape, and how
// many k-slices. A function of (B, rows, vp) alone, so a case-stacked launch
// sums each case in the order a single-case launch does.
struct F32Plan {
  int shape;  // an index into F32_SHAPES
  int row_tiles, col_tiles;
  int slices, klen;  // k-slices of klen (a multiple of F_KALIGN) floats each
};

F32Plan f32_plan(int B, int rows, int vp) {
  F32Plan p;
  p.shape = B <= F32_SHAPES[0].bn ? 0 : (B <= F32_SHAPES[1].bn ? 1 : 2);
  const F32Shape& sh = F32_SHAPES[p.shape];
  const long long slots = sh.min_blocks * 132LL;  // resident blocks on the H100's 132 SMs
  p.row_tiles = (rows + sh.bm - 1) / sh.bm;
  p.col_tiles = (B + sh.bn - 1) / sh.bn;
  const long long units = (long long)p.row_tiles * p.col_tiles;
  // cut k into the fewest slices (at least F_MIN_SLICE long) whose blocks
  // fill 90% of the waves they take, or else the fullest
  const int most = vp / F_MIN_SLICE > 1 ? vp / F_MIN_SLICE : 1;
  int want = 1;
  double best = 0.0;
  for (int s = 1; s <= most; ++s) {
    const long long blocks = units * s, waves = (blocks + slots - 1) / slots;
    const double fill = (double)blocks / (double)(waves * slots);
    if (fill > best + 1e-9) best = fill, want = s;
    if (fill >= 0.9) break;
  }
  const int per = (vp + want - 1) / want;
  p.klen = vp > 0 ? (per + F_KALIGN - 1) / F_KALIGN * F_KALIGN : F_KALIGN;
  p.slices = vp > 0 ? (vp + p.klen - 1) / p.klen : 1;
  return p;
}

long long f32_p_bytes(int cases, int B, int rows, const F32Plan& p) {
  return ((long long)cases * p.slices * B * rows * 4 + 255) / 256 * 256;
}

// Dynamic shared memory past 48 KB needs the attribute, once per device.
template <typename Kernel>
cudaError_t f32_allow_smem(Kernel kernel, int bytes, unsigned long long& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (set >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) set |= 1ull << dev;
  return err;
}

template <int SHAPE, bool AL>
cudaError_t launch_f32_shape(const float* H, const float* X, float* P, const F32Plan& p,
                             int cases, int B, int rows, int vp, cudaStream_t s) {
  constexpr F32Shape sh = F32_SHAPES[SHAPE];
  static_assert(F_KALIGN % sh.bk == 0, "k-slices must start on a stage boundary");
  constexpr int smem = sh.stages * (sh.bm + sh.bn) * (sh.bk + 4) * 4;
  const auto kernel = score_rows_f32_product<sh.bm, sh.bn, sh.threads, sh.min_blocks, sh.bk, sh.stages, AL>;
  static unsigned long long set = 0;
  cudaError_t err = f32_allow_smem(kernel, smem, set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.col_tiles, p.row_tiles, cases * p.slices), sh.threads, smem, s>>>(H, X, P, B, rows, vp, p.klen,
                                                                                    p.slices);
  return cudaGetLastError();
}

template <bool AL>
cudaError_t launch_f32_product(const float* H, const float* X, float* P, const F32Plan& p,
                               int cases, int B, int rows, int vp, cudaStream_t s) {
  switch (p.shape) {
    case 0:
      return launch_f32_shape<0, AL>(H, X, P, p, cases, B, rows, vp, s);
    case 1:
      return launch_f32_shape<1, AL>(H, X, P, p, cases, B, rows, vp, s);
    default:
      return launch_f32_shape<2, AL>(H, X, P, p, cases, B, rows, vp, s);
  }
}

}  // namespace

extern "C" {

// Bytes of scratch the f32 path needs: the slices' raw row sums P [cases,
// slices, B, rows], then the row tiles' partials [cases, tiles, B] (f32),
// 256-byte aligned.
long long score_rows_f32_scratch_bytes(int cases, int B, int rows, int vp) {
  const F32Plan p = f32_plan(B, rows, vp);
  return f32_p_bytes(cases, B, rows, p) + (long long)cases * ((rows + F_FT - 1) / F_FT) * B * 4;
}

// The f32 path. H [cases, rows, vp], lb/ub [cases, rows], X [cases, B, vp],
// all f32 device pointers; scratch of score_rows_f32_scratch_bytes, 256-byte
// aligned; hx_out may be null. Returns the cudaError_t of the launches (0
// when all were accepted).
int score_rows_launch(const float* H, const float* lb, const float* ub,
                      const float* X, void* scratch, float* hx_out,
                      float* scores, int cases, int B, int rows, int vp,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const F32Plan p = f32_plan(B, rows, vp);
  float* P = static_cast<float*>(scratch);
  float* partial = reinterpret_cast<float*>(static_cast<char*>(scratch) + f32_p_bytes(cases, B, rows, p));
  const bool aligned = vp % 4 == 0 && (reinterpret_cast<size_t>(H) | reinterpret_cast<size_t>(X)) % 16 == 0;
  cudaError_t err = aligned ? launch_f32_product<true>(H, X, P, p, cases, B, rows, vp, s)
                            : launch_f32_product<false>(H, X, P, p, cases, B, rows, vp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (rows + F_FT - 1) / F_FT;
  score_rows_f32_finish<<<dim3((B + 7) / 8, tiles, cases), 256, 0, s>>>(P, lb, ub, hx_out, partial, B, rows,
                                                                         p.slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  score_rows_sum<<<dim3((B + 7) / 8, cases), 256, 0, s>>>(partial, scores, B, tiles);
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
