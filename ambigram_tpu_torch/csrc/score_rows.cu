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
// (H [G, Rows, Vp], lb/ub [G, Rows], X [G, B, Vp]) scores every case of a
// group in one launch, and each case computes exactly what a single-case
// launch computes.
//
// Two paths, chosen by the wrapper before launch from the representation:
//
// 1. The int8 path (`score_rows_i8_launch`, one launch per call), whenever
//    the program's rows are int8-exact. Then H = w * H8 row-wise, with w in
//    {0, 0.5, 1, 1024} and |H8| <= 2, and the kernel reads H8 (a quarter of
//    H's bytes) and w:
//
//        hx_int[b, r] = sum_k X[b, k] * H8[r, k]     (int32, tensor cores)
//        hx[b, r]     = w[r] * float(hx_int[b, r])
//
//    X holds non-negative integers (the search's candidates), truncated
//    toward zero to one u8 plane (X <= 255) or two (X = 256 hi + lo,
//    X <= 65535). The wrapper checks that ceil(max X) * max|H8| * Vp < 2^24,
//    so hx_int converts to f32 exactly, and w is 0 or a power of two, so hx
//    is bitwise equal to the f32 product of H, whose partial sums are all w
//    times an integer below 2^24.
//
//    What bounds it: reading H8 once (S=48: 19.9 MB, 6 us at 3.35 TB/s) at
//    the search's B=32; the int8 products (2 B Rows Vp per plane) at large
//    B (a row shard of the sharded step: 73,760 candidates x 1920 rows x
//    1152, 0.165 ms at 1979 TOP/s). X in f32 is 4 bytes a value, four times
//    a plane, so where it is re-read it costs more than H8. The design:
//
//    - wgmma m64nNk32 (.s32.s8.u8): A is a 64-row tile of H8, B the
//      candidates' u8 planes, both K-major in shared memory with the
//      128-byte swizzle (H8 [Rows, Vp] and the planes [B, Vp] already are).
//      Two planes are two column groups of B on the same A tile, joined as
//      lo + 256 hi in the epilogue. A block has two consumer warpgroups and
//      one producer warp; N = planes * (candidates a warpgroup holds), 16 to
//      128.
//    - H8 by TMA: a 3D tensor map over [G][Rows][Vp], boxes of 128 bytes of
//      K by 64 or 128 rows, zero fill past Rows and Vp; one producer thread
//      feeds an mbarrier ring of 2-8 stages.
//    - The candidates converted in the kernel: X is read in f32 with 16-byte
//      loads (TMA boxes when streamed, plain loads when resident),
//      truncated as `__float2int_rz` truncates, and stored as u8 planes in the
//      swizzled layout that the B descriptor names. No pass writes planes to
//      device memory.
//    - Two loop orders, from a host rule (`k1_int8_plan` in
//      solver/score.py, which hands the launch its plan):
//      * row-streaming (small B, or a resident tile that does not fit):
//        blocks split the rows; each X box comes by TMA beside its H8 box and
//        is converted into the stage. The two warpgroups take two 64-row
//        tiles of the same candidates, or (when that leaves too few blocks
//        for the card) two halves of 32 candidates on one tile.
//      * candidate-stationary (B > 64, when the block's candidates fit in
//        shared memory as planes): a block converts its candidates once and
//        keeps them for every row tile it walks; the warpgroups take two
//        halves of them on the same H8 tile. Each candidate's f32 bytes come
//        from device memory once per call when the block walks every row
//        (the row shard); when there are too few candidate tiles to fill the
//        card, the rows are split between blocks and each split converts the
//        candidates again (from L2).
//    - The epilogue: hx = w * float(v) exactly (|v| < 2^24), stored straight
//      from the accumulators (a warp's store fills four whole 32-byte
//      sectors: 8 neighbouring rows of 4 candidates); the hinges; one partial
//      per (64-row tile, candidate) in a fixed tree (the two rows a thread
//      holds, then lanes 4, 8, 16 apart, then the four warps in order).
//      Scores sum the partials over the tiles in tile order: in registers
//      when one block walks every row of its candidates, else through
//      device memory, where the last block to finish a candidate tile (an
//      atomic ticket after __threadfence) sums them, staged through its
//      shared memory so that all its threads' loads are in flight at once.
//      No float atomics, so the scores do not depend on scheduling, on the
//      plan or on the case count. `score_rows_int8_plain` mirrors this
//      order.
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
// order. The f32 path's finishing pass reduces one row tile's hinges per
// candidate into one partial per (row tile, candidate), and a second small
// kernel sums the partials over the row tiles in a fixed order. The f32 path
// masks ragged B, Rows and Vp (a Vp that is not a multiple of 4, or an
// operand that is not 16-byte aligned, takes 4-byte copies); the int8 path
// takes Rows and Vp in multiples of 64 (as `scoring_tensors` pads them) and
// any B.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

// The f32 path's second pass: one warp per candidate sums its row tiles'
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ------------------------------------------------------------ the int8 path

constexpr int I8_KC = 128;         // bytes of K a stage holds: one 128-byte swizzle span
constexpr int I8_TILE = 64;        // rows of a tile: one wgmma M
constexpr int I8_CONSUMERS = 256;  // two consumer warpgroups
constexpr int I8_THREADS = 288;    // and one producer warp
constexpr int I8_SMEM_MAX = 232448;
// the loop orders (the plan's `order` and `split_rows`)
constexpr int I8_CANDS = 0;       // candidate-stationary: resident candidates, warpgroups split them
constexpr int I8_ROWS = 1;        // row-streaming, warpgroups on two 64-row tiles
constexpr int I8_ROWS_HALVES = 2;  // row-streaming, warpgroups on two halves of the candidates

// Shared memory of a block, in the order it is laid out (the wrapper's
// `k1_int8_smem` computes the same): 1024 bytes of alignment, the resident
// planes [Vp/128 chunks][P * bn rows][128 B], the ring's stages (A [arows][128
// B], streamed planes [P * bn][128 B], staged X [bn][128 f32]), the partial
// sums [2][4][bnw] f32, a flag, the full and empty barriers.
struct I8Layout {
  int res, a_bytes, b_bytes, x_bytes, stage, red, total;
};

__host__ __device__ inline I8Layout i8_layout(int P, int bn, int mode, int stages, int vp) {
  I8Layout L;
  const int vp_pad = (vp + I8_KC - 1) / I8_KC * I8_KC;
  const bool resident = mode == I8_CANDS, split_rows = mode == I8_ROWS;
  const int bnw = split_rows ? bn : bn / 2;
  L.res = resident ? P * bn * vp_pad : 0;
  L.a_bytes = (split_rows ? 2 : 1) * I8_TILE * I8_KC;
  L.b_bytes = resident ? 0 : P * bn * I8_KC;
  L.x_bytes = resident ? 0 : bn * I8_KC * 4;
  L.stage = L.a_bytes + L.b_bytes + L.x_bytes;
  L.red = 2 * 4 * bnw;
  L.total = 1024 + L.res + stages * L.stage + 4 * L.red + 16 + 2 * 8 * stages;
  return L;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// A wait that outlasts about 30 s of SM clocks traps, so a fault in the
// ring's protocol ends the launch with an error rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 60000000000LL) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// the box of a 3D tensor map at (x, y, z) into shared memory
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the wgmma fence, commit and wait points (the products write the registers
// asynchronously).
template <int R>
__device__ __forceinline__ void fence_operand(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle
// (8 rows x 128 B atoms, 1024 B apart); the tile starts 1024-byte aligned,
// and a k-step of 32 bytes inside the atom adds 2 to the address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);  // start address >> 4
  d |= (uint64_t)1 << 16;                                 // leading offset: unused
  d |= (uint64_t)(1024 >> 4) << 32;                       // stride offset: 8 rows
  d |= (uint64_t)1 << 62;                                 // 128-byte swizzle
  return d;
}

// d (+)= A (64 x 32, s8, K-major in shared memory) * B (32 x N, u8, K-major
// in shared memory), s32; `accumulate` 0 overwrites d. Thread (warp w, lane
// l) of the warpgroup holds d[4 j + q] = (row 16 w + l / 4 + 8 (q >> 1),
// column 8 j + 2 (l % 4) + (q & 1)).
template <int N>
__device__ __forceinline__ void wgmma_s8u8(int (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8u8<16>(int (&d)[8], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8u8<32>(int (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8u8<64>(int (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8u8<128>(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Four candidates' values of one 16-byte group q (k = 4q .. 4q + 3 of a
// 128-byte chunk) as P u8 planes: truncated toward zero (__float2int_rz),
// plane p the byte p of each; row p * rows_per_plane + n of the block `sub`
// (1024-byte aligned), granule q / 4 swizzled by the row.
template <int P>
__device__ __forceinline__ void put_planes(unsigned char* sub, int rows_per_plane, int n, int q, float4 v) {
  const unsigned u0 = static_cast<unsigned>(__float2int_rz(v.x));
  const unsigned u1 = static_cast<unsigned>(__float2int_rz(v.y));
  const unsigned u2 = static_cast<unsigned>(__float2int_rz(v.z));
  const unsigned u3 = static_cast<unsigned>(__float2int_rz(v.w));
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int row = p * rows_per_plane + n;
    const unsigned word = ((u0 >> (8 * p)) & 0xffu) | (((u1 >> (8 * p)) & 0xffu) << 8) |
                          (((u2 >> (8 * p)) & 0xffu) << 16) | (((u3 >> (8 * p)) & 0xffu) << 24);
    *reinterpret_cast<unsigned*>(sub + row * I8_KC + ((((q >> 2) ^ (row & 7))) << 4) + (q & 3) * 4) = word;
  }
}

// A tile's rows of the thread (16 w + l / 4 and + 8 of the 64) and their
// weights and bounds, read ahead of the tile's epilogue.
struct I8Rows {
  int tile;
  int r[2];
  float wr[2], lo[2], hi[2];
  __device__ __forceinline__ void load(int tile_, int T, int warp, int lane, const float* __restrict__ w,
                                       const float* __restrict__ lb, const float* __restrict__ ub) {
    tile = tile_;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      r[h] = tile * I8_TILE + warp * 16 + (lane >> 2) + 8 * h;
      wr[h] = lo[h] = hi[h] = 0.f;
      if (tile < T) {
        wr[h] = __ldg(w + r[h]);
        lo[h] = __ldg(lb + r[h]);
        hi[h] = __ldg(ub + r[h]);
      }
    }
  }
};

// A tile's epilogue: hx = w * float(v) exactly (|v| < 2^24; v = lo + 256 hi
// with two planes), stored when asked (a warp's store fills four whole
// 32-byte sectors: 8 neighbouring rows of 4 candidates), the hinges of
// the thread's two rows and their sum, then the sum over the warp's 16
// rows (lanes 4, 8, 16 apart) into part[j] for each column group j of 8
// candidates.
template <int P, int BNW>
__device__ __forceinline__ void epilogue_tile(const int (&d)[P * BNW / 2], float (&part)[BNW / 8][2],
                                              const I8Rows& rw, int bw0, int B, int rows, int g,
                                              float* __restrict__ hx_out, int lane) {
  const bool tile_ok = rw.r[0] < rows;  // the same for the whole warpgroup
#pragma unroll
  for (int j = 0; j < BNW / 8; ++j)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      float sum = 0.f;
      if (tile_ok) {
        const int b = bw0 + 8 * j + 2 * (lane & 3) + cc;
        float term[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 2 * h + cc;
          const int v = P == 2 ? d[4 * j + q] + 256 * d[4 * (j + BNW / 8) + q] : d[4 * j + q];
          const float x = rw.wr[h] * static_cast<float>(v);
          if (hx_out != nullptr && b < B) hx_out[((size_t)g * B + b) * rows + rw.r[h]] = x;
          term[h] = fmaxf(x - rw.hi[h], 0.f) + fmaxf(rw.lo[h] - x, 0.f);
        }
        sum = term[0] + term[1];
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      part[j][cc] = sum;
    }
}

// The int8 path: one block per (candidate tile of BN, case) and row split.
// Threads 0-255 are two consumer warpgroups, 256-287 the producer warp.
// MODE is I8_CANDS, I8_ROWS or I8_ROWS_HALVES; BNW the candidates each
// warpgroup holds (its wgmma N is P * BNW).
template <int P, int BNW, int MODE>
__global__ void __launch_bounds__(I8_THREADS, 1)
score_rows_i8(const __grid_constant__ CUtensorMap h8_map, const __grid_constant__ CUtensorMap x_map,
              const float* __restrict__ X, const float* __restrict__ w, const float* __restrict__ lb,
              const float* __restrict__ ub, float* __restrict__ hx_out, float* __restrict__ partial,
              int* __restrict__ tickets, float* __restrict__ scores, int B, int rows, int vp, int ctiles,
              int stages, int steps_per_split) {
  constexpr bool RESIDENT = MODE == I8_CANDS;
  constexpr bool SPLIT_ROWS = MODE == I8_ROWS;
  constexpr int BN = SPLIT_ROWS ? BNW : 2 * BNW;  // candidates of the block
  constexpr int NW = P * BNW;                     // the wgmma N of a warpgroup
  constexpr int TPS = SPLIT_ROWS ? 2 : 1;         // 64-row tiles a step
  const I8Layout L = i8_layout(P, BN, MODE, stages, vp);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* res = smem;
  unsigned char* ring = smem + L.res;
  float* red = reinterpret_cast<float*>(ring + stages * L.stage);  // [2][4][BNW]
  int* flag = reinterpret_cast<int*>(red + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(flag + 4);
  uint64_t* empty = full + stages;

  const int T = rows / I8_TILE;
  const int nk = (vp + I8_KC - 1) / I8_KC;
  const int steps = (T + TPS - 1) / TPS;
  const int step0 = blockIdx.y * steps_per_split;
  const int step1 = min(steps, step0 + steps_per_split);
  const int g = blockIdx.x / ctiles;                 // case
  const int b0 = (blockIdx.x - g * ctiles) * BN;     // first candidate of the block
  const int chunk = P * BN * I8_KC;                  // planes of one 128-byte chunk

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= I8_CONSUMERS) {
    // the producer: one thread keeps the ring full, step after step
    if (threadIdx.x == I8_CONSUMERS) {
      int stage = 0;
      unsigned phase = 0;
      for (int s = step0; s < step1; ++s)
        for (int c = 0; c < nk; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * L.stage;
          mbar_arrive_expect_tx(&full[stage], L.a_bytes + L.x_bytes);
          tma_load_3d(st, &h8_map, &full[stage], c * I8_KC, s * TPS * I8_TILE, g);
          if (!RESIDENT) tma_load_3d(st + L.a_bytes + L.b_bytes, &x_map, &full[stage], c * I8_KC, b0, g);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  const int t = threadIdx.x, wg = t >> 7, tw = t & 127, warp = tw >> 5, lane = t & 31;
  const int wg_rows = SPLIT_ROWS ? wg : 0;  // the warpgroup's tile within a step
  const int wg_cand = SPLIT_ROWS ? 0 : wg;  // the warpgroup's half of the candidates
  const int b_off = wg_cand * P * BNW * I8_KC;
  const int bw0 = b0 + wg_cand * BNW;  // the warpgroup's first candidate

  if (RESIDENT) {
    // the warpgroup's candidates, every chunk, converted once; 16 loads in
    // flight a thread (8 in the widest variants, whose registers are
    // short), neighbouring threads on neighbouring 16 bytes
    constexpr int INFLIGHT = NW >= 128 ? 8 : 16;
    const int per_row = nk * 32;  // 16-byte groups of a candidate, in whole chunks
    const int total = BNW * per_row;
    for (int e0 = tw; e0 < total; e0 += 128 * INFLIGHT) {
      float4 v[INFLIGHT];
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
        const int e = e0 + u * 128;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < total) {
          const int n = e / per_row, k = 4 * (e - n * per_row);
          const int b = bw0 + n;
          if (b < B && k < vp) v[u] = __ldg(reinterpret_cast<const float4*>(X + ((size_t)g * B + b) * vp + k));
        }
      }
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
        const int e = e0 + u * 128;
        if (e < total) {
          const int n = e / per_row, i = e - n * per_row;
          put_planes<P>(res + (i >> 5) * chunk + b_off, BNW, n, i & 31, v[u]);
        }
      }
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);
  }

  int acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
  int stage = 0, held = -1;
  unsigned phase = 0;
  const bool direct = RESIDENT && gridDim.y == 1;  // the block walks every row of its candidates
  float run = 0.f;  // thread tw < BNW: the running score of candidate bw0 + tw (direct)
  float part[BNW / 8][2];
  I8Rows cur;

  // the end of a tile's epilogue: the warps' sums in order, then the
  // tile's partial into the running score or device memory
  auto finish = [&](const I8Rows& rw) {
    if ((lane >> 2) == 0) {
#pragma unroll
      for (int j = 0; j < BNW / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) red[(wg * 4 + warp) * BNW + 8 * j + 2 * lane + cc] = part[j][cc];
    }
    named_barrier(2 + wg, 128);
    if (tw < BNW && rw.tile < T) {
      const float* rr = red + wg * 4 * BNW + tw;
      const float p = ((rr[0] + rr[BNW]) + rr[2 * BNW]) + rr[3 * BNW];
      const int b = bw0 + tw;
      if (direct)
        run += p;
      else if (b < B)
        partial[((size_t)g * T + rw.tile) * B + b] = p;
    }
    named_barrier(2 + wg, 128);  // red is free for the next tile
  };

  // the epilogue's row weights and bounds, loaded before a step's products
  // so that their latency passes under them (after them in the widest
  // variants, which have no registers to hold them that long)
  constexpr bool PREFETCH = NW < 128;
  auto load_rows = [&](int s) {
    cur.load(s * TPS + wg_rows, T, warp, lane, w + (size_t)g * rows, lb + (size_t)g * rows, ub + (size_t)g * rows);
  };
  for (int s = step0; s < step1; ++s) {
    if (PREFETCH) load_rows(s);
    for (int c = 0; c < nk; ++c) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = ring + stage * L.stage;
      const unsigned char* bsrc;
      if (RESIDENT) {
        bsrc = res + c * chunk + b_off;
      } else {
        // the staged X box [BN][128 f32] into this stage's planes
        const float* xs = reinterpret_cast<const float*>(st + L.a_bytes + L.b_bytes);
        unsigned char* planes = st + L.a_bytes;
        const int nthreads = SPLIT_ROWS ? I8_CONSUMERS : 128, me = SPLIT_ROWS ? t : tw;
        const int nconv = SPLIT_ROWS ? BN : BNW, nbase = SPLIT_ROWS ? 0 : wg * BNW;
#pragma unroll 4
        for (int e = me; e < nconv * 32; e += nthreads) {
          const int n = e >> 5, q = e & 31;
          const float4 v = *reinterpret_cast<const float4*>(xs + (nbase + n) * I8_KC + 4 * q);
          put_planes<P>(planes + b_off, BNW, n, q, v);
        }
        fence_proxy_async();
        if (SPLIT_ROWS)
          named_barrier(1, I8_CONSUMERS);
        else
          named_barrier(2 + wg, 128);
        bsrc = planes + b_off;
      }
      if (c == 0) fence_operand(acc);
      wgmma_fence();
      const uint64_t da = sw128_desc(st + wg_rows * I8_TILE * I8_KC);
      const uint64_t db = sw128_desc(bsrc);
#pragma unroll
      for (int kk = 0; kk < I8_KC / 32; ++kk) wgmma_s8u8<NW>(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products have landed: its slot is free
      if (held >= 0 && tw == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operand(acc);
    if (tw == 0) mbar_arrive(&empty[held]);
    held = -1;
    if (!PREFETCH) load_rows(s);
    epilogue_tile<P, BNW>(acc, part, cur, bw0, B, rows, g, hx_out, lane);
    finish(cur);
  }

  if (direct) {
    if (tw < BNW && bw0 + tw < B) scores[(size_t)g * B + bw0 + tw] = run;
    return;
  }
  // the last block to finish this candidate tile sums its partials in tile
  // order, through shared memory (the ring is free now) a pass of tiles at
  // a time: every thread loads, so the loads are in flight together
  __threadfence();
  named_barrier(1, I8_CONSUMERS);
  int* ticket = tickets + blockIdx.x;
  if (t == 0) flag[0] = atomicAdd(ticket, 1) == static_cast<int>(gridDim.y) - 1;
  named_barrier(1, I8_CONSUMERS);
  if (!flag[0]) return;
  __threadfence();
  float* staged = reinterpret_cast<float*>(ring);
  const int per_pass = max(1, stages * L.stage / (BN * 4));  // tiles a pass
  float sum = 0.f;  // thread t < BN: candidate b0 + t
  for (int t0 = 0; t0 < T; t0 += per_pass) {
    const int nt = min(per_pass, T - t0);
    for (int e = t; e < nt * BN; e += I8_CONSUMERS) {
      const int tt = e / BN, n = e - tt * BN;
      staged[e] = b0 + n < B ? __ldcg(partial + ((size_t)g * T + t0 + tt) * B + b0 + n) : 0.f;
    }
    named_barrier(1, I8_CONSUMERS);
    if (t < BN)
      for (int tt = 0; tt < nt; ++tt) sum += staged[tt * BN + t];
    named_barrier(1, I8_CONSUMERS);
  }
  if (t < BN && b0 + t < B) scores[(size_t)g * B + b0 + t] = sum;
  if (t == 0) *ticket = 0;  // ready for the next launch on this stream
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int ERR_ENCODE = -1;     // cuTensorMapEncodeTiled is missing
constexpr int ERR_PLAN = -2;       // a plan the kernel is not built for, or one that does not fit
constexpr int ERR_ENCODE_AT = -1000;  // cuTensorMapEncodeTiled failed: ERR_ENCODE_AT - its CUresult

EncodeTiled tensor_map_encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return nullptr;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

// A 3D tensor map over [cases][n][vp] (elements of `elem` bytes), boxes of
// 128 along vp by `box_n`; zero fill past every edge.
int encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int vp, int n,
               int cases, int box_n, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return ERR_ENCODE;
  const cuuint64_t dims[3] = {(cuuint64_t)vp, (cuuint64_t)n, (cuuint64_t)cases};
  const cuuint64_t strides[2] = {(cuuint64_t)vp * elem, (cuuint64_t)vp * elem * n};
  const cuuint32_t box[3] = {(cuuint32_t)I8_KC, (cuuint32_t)box_n, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE_AT - static_cast<int>(r);
}

template <int P, int BNW, int MODE>
int launch_i8(const CUtensorMap& h8_map, const CUtensorMap& x_map, const float* X, const float* w,
              const float* lb, const float* ub, float* hx_out, float* partial, int* tickets, float* scores,
              int cases, int B, int rows, int vp, int ctiles, int splits, int stages, int steps_per_split,
              int smem, cudaStream_t s) {
  const auto kernel = score_rows_i8<P, BNW, MODE>;
  // the attribute outlives the launch: set it once per device, to the most
  // a block may have, so that every plan fits
  static unsigned long long set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !(set >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, I8_SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) set |= 1ull << dev;
  }
  kernel<<<dim3(ctiles * cases, splits, 1), I8_THREADS, smem, s>>>(h8_map, x_map, X, w, lb, ub, hx_out, partial,
                                                                    tickets, scores, B, rows, vp, ctiles, stages,
                                                                    steps_per_split);
  return static_cast<int>(cudaGetLastError());
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

// The int8 path, one launch. H8 [cases, rows, vp] int8, w/lb/ub [cases,
// rows] f32, X [cases, B, vp] f32 holding integers in [0, 256^planes), each
// 16-byte aligned; rows and vp multiples of 64, planes 1 or 2. The plan
// (`k1_int8_plan` in solver/score.py): mode (0 candidate-stationary, 1
// row-streaming on two row tiles, 2 row-streaming on two halves of the
// candidates), bn candidates a block, stages,
// splits blocks along the rows of each candidate tile, steps_per_split row
// steps each. partial [cases, rows / 64, B] f32 (unused when one block walks
// every row of its candidates: mode 0 with one split); tickets one int per
// (case, candidate tile), zero on entry and left zero. hx_out may be null.
// Returns 0 when the launch was accepted, a cudaError_t, -1 when a tensor
// map could not be made, -2 for a plan the kernel is not built for.
int score_rows_i8_launch(const signed char* H8, const float* w, const float* lb, const float* ub,
                         const float* X, float* hx_out, float* scores, float* partial, int* tickets, int cases,
                         int B, int rows, int vp, int planes, int mode, int bn, int stages, int splits,
                         int steps_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || vp <= 0 || rows % I8_TILE || vp % 64 || B < 1 || cases < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = i8_layout(planes, bn, mode, stages, vp).total;
  if (smem > I8_SMEM_MAX || stages < 2 || splits < 1 || steps_per_split < 1) return ERR_PLAN;
  const int ctiles = (B + bn - 1) / bn;
  // the encoder needs a current context: a thread that has made no
  // runtime call yet (a search group's own thread) may have none
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap h8_map, x_map;
  const int arows = mode == I8_ROWS ? 2 * I8_TILE : I8_TILE;
  int e = encode_map(&h8_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, H8, vp, rows, cases, arows,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  if (mode == I8_CANDS) {
    x_map = h8_map;  // resident candidates are read with plain loads
  } else {
    e = encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, X, vp, B, cases, bn, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return e;
  }
  const int bnw = mode == I8_ROWS ? bn : bn / 2;
#define K1_I8_CASE(P_, BNW_, MODE_)                                                                            \
  if (planes == P_ && bnw == BNW_ && mode == MODE_)                                                            \
    return launch_i8<P_, BNW_, MODE_>(h8_map, x_map, X, w, lb, ub, hx_out, partial, tickets, scores, cases, B, \
                                      rows, vp, ctiles, splits, stages, steps_per_split, smem, s);
  K1_I8_CASE(1, 16, I8_CANDS)
  K1_I8_CASE(1, 32, I8_CANDS)
  K1_I8_CASE(1, 64, I8_CANDS)
  K1_I8_CASE(2, 16, I8_CANDS)
  K1_I8_CASE(2, 32, I8_CANDS)
  K1_I8_CASE(2, 64, I8_CANDS)
  K1_I8_CASE(1, 32, I8_ROWS)
  K1_I8_CASE(1, 64, I8_ROWS)
  K1_I8_CASE(2, 32, I8_ROWS)
  K1_I8_CASE(2, 64, I8_ROWS)
  K1_I8_CASE(1, 16, I8_ROWS_HALVES)
  K1_I8_CASE(2, 16, I8_ROWS_HALVES)
#undef K1_I8_CASE
  return ERR_PLAN;
}

const char* score_rows_error_string(int code) {
  if (code == ERR_ENCODE) return "cuTensorMapEncodeTiled is unavailable";
  if (code == ERR_PLAN) return "a plan the int8 kernel is not built for, or one that does not fit";
  if (code <= ERR_ENCODE_AT) {
    static thread_local char msg[64];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)", ERR_ENCODE_AT - code);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
