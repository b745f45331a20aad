// K2: the benchmark's fused int8 scoring chain, written by hand for Hopper
// (sm_90a) on the int8 tensor cores (wgmma).
//
// Replaces the Pallas TPU kernel `_chained_kernel` in
// ambigram_tpu/solver/score.py (launched by `chained_score_pallas`). For a
// block of candidates X [block_b, Vp] and the int8 row matrix H8 [Rows, Vp]
// it runs `iters` rounds of
//
//     hx[b, r] = sum_k int8(X[b, k]) * H8[r, k]          (exact, int32)
//     s[b]     = sum_r w[r] * (max(hx - ub[r], 0) + max(lb[r] - hx, 0))
//     X[b, j] = min(X[b, j] + (((s[b] + j) + i) mod 7 < 1), x_ub[j]), j < 128
//     acc     += sum_b s[b]
//
// and writes the block's acc; a second one-thread kernel sums the blocks in
// order into the checksum. The head lanes live in a [B, 128] f32 buffer the
// wrapper makes from X and turns back into the final candidates.
//
// Exactness. hx is an exact int32 dot product and converts to f32 exactly,
// since the wrapper checks |hx| < 2^24. Each hinge term is formed in f32 as
// the JAX kernel forms it (exact for integer targets: w in {0, 0.5, 1,
// 1024}). A candidate's score passes 2^24 at the bench shape, so an f32 sum
// over the rows would round, differently in every order, and a different
// score flips later bumps. The terms are therefore summed in f64, where the
// sum is exact, and s is that sum rounded once to f32: the same value as the
// plain version's, in any order. The mutation repeats the JAX evaluation
// order with round-to-nearest adds and an exact fmodf. The 128 head lanes are
// kept in f32 (x_ub may be fractional); the scoring copy is their truncation
// to int8, as XLA's cast does.
//
// What bounds it: the int8 products, 2 Vp Rows = 8.8 M operations per
// candidate and round at the bench shape (0.23 s for the bench's 262,144
// candidates x 200 rounds at the H100's 1979 TOP/s); H8 is 4.4 MB and stays
// in L2. The design:
//
// - wgmma m64n128k32 (s8 x s8 -> s32): the candidates are the M side, a
//   128-row tile of H8 the N side. Both operands are K-major, as int8 wgmma
//   requires; H8 [Rows, Vp] row-major already is, so no transpose is made.
// - Each consumer warpgroup keeps its 64 candidates in shared memory as int8
//   for all rounds, in wgmma's 128-byte-swizzled K-major layout ([Vp/128]
//   blocks of [64 rows x 128 B], 16-byte granule g of row r at g ^ (r % 8)).
//   The head repack after each mutation writes that same layout.
// - One producer thread streams H8 through a 4-stage ring of [128 rows x
//   128 B] tiles by TMA (a 2D tensor map with the 128-byte swizzle), with
//   full/empty mbarriers; the ring runs ahead across tiles and rounds.
// - Overlap: once a tile's products have all landed, each consumer
//   warpgroup copies its accumulators aside; while the tensor cores form
//   tile t+1, the warps run tile t's f64 hinge epilogue on the copy, an
//   eighth of it after each 128-byte K stage (wgmma.wait_group 1 keeps one
//   group in flight). The epilogue never reads a register a product in
//   flight writes, so ptxas need not serialize the products.
// - L2 traffic: a block of 128 candidates (two consumer warpgroups sharing
//   every H8 tile) reads the 4.4 MB of H8 once per round, 2 x 128 operations
//   per byte: the L2 serves H8 at 2.5 TB/s at 640 TOP/s (7.7 TB/s would be
//   needed at the tensor-core peak, against 15.5 TB/s at 64 candidates a
//   block). Holding more candidates per block (rather than TMA multicast
//   across a cluster) keeps the kernel one CTA per SM with no cluster
//   launch; 64 candidates (one warpgroup) serve widths whose candidates do
//   not fit twice in shared memory.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HEAD = 128;                    // lanes the chain mutates
constexpr int TILE_N = 128;                  // H8 rows per tile (wgmma N)
constexpr int KCHUNK = 128;                  // bytes of K per stage
constexpr int STAGES = 4;                    // TMA ring depth
constexpr int STAGE_BYTES = TILE_N * KCHUNK; // 16 KB
constexpr int CAND_WG = 64;                  // candidates per consumer warpgroup
constexpr int A_CHUNK = CAND_WG * KCHUNK;    // one [64 x 128 B] swizzled block
constexpr int PARTS = 8;                     // epilogue slices per tile
constexpr int BAR_CONSUMERS = 1;             // named barrier of all consumers
constexpr int BAR_WG = 2;                    // + warpgroup: its own named barrier

size_t smem_bytes(int bb, int vp) {
  return 1024                                  // alignment of the swizzled tiles
         + (size_t)bb * vp                     // candidates, int8
         + (size_t)STAGES * STAGE_BYTES        // H8 ring
         + sizeof(double) * 2 * (size_t)bb     // s, exact, by round parity
         + sizeof(uint64_t) * 2 * STAGES;      // full and empty barriers
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

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// box (x: KCHUNK bytes of K, y: TILE_N rows) of the tensor map at (x, y)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
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

// Keeps the compiler from moving reads or writes of an accumulator set
// across the wgmma fence, commit and wait points (the products write the
// registers asynchronously).
__device__ __forceinline__ void fence_operand(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// d (+)= A (64 x 32, s8, K-major in shared memory) * B (32 x 128, s8, K-major
// in shared memory), s32; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
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

__device__ __forceinline__ int trunc_i8(float v) {
  return static_cast<int>(static_cast<signed char>(__float2int_rz(v))) & 0xff;
}

__device__ __forceinline__ int pack4(float a, float b, float c, float d) {
  return trunc_i8(a) | (trunc_i8(b) << 8) | (trunc_i8(c) << 16) | (trunc_i8(d) << 24);
}

// byte offset of 16-byte granule g (of 8) of candidate row r in a swizzled
// [64 x 128 B] block
__device__ __forceinline__ int sw128(int r, int g) { return r * KCHUNK + ((g ^ (r & 7)) << 4); }

// One weighted hinge term in f32, as the JAX kernel forms it, widened to f64.
__device__ __forceinline__ double hinge_term(int hx, float4 bnd) {
  const float v = static_cast<float>(hx);  // exact: |hx| < 2^24
  const float over = fmaxf(__fsub_rn(v, bnd.y), 0.f);
  const float under = fmaxf(__fsub_rn(bnd.x, v), 0.f);
  return static_cast<double>(__fmul_rn(bnd.z, __fadd_rn(over, under)));
}

// Slice `part` of a finished tile's epilogue: accumulator columns [16 part,
// 16 part + 16), i.e. H8 rows tile*128 + 16 part + ... Thread (warp, lane)
// holds candidates m = 16 warp + lane/4 and m + 8 and, per column group j,
// rows 8 j + 2 (lane % 4) and the next: d[4j + q] = (m + 8 (q >> 1), 8 j + 2
// (lane % 4) + (q & 1)).
__device__ __forceinline__ void epilogue_part(const int (&d)[64], int part, int tile, int colq,
                                              const float4* __restrict__ bounds, double& s0, double& s1) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if ((j >> 1) != part) continue;
    const int n = tile * TILE_N + 8 * j + colq;
    const float4 b0 = __ldg(bounds + n), b1 = __ldg(bounds + n + 1);
    s0 += hinge_term(d[4 * j + 0], b0);
    s0 += hinge_term(d[4 * j + 1], b1);
    s1 += hinge_term(d[4 * j + 2], b0);
    s1 += hinge_term(d[4 * j + 3], b1);
  }
}

struct Ring {
  unsigned char* tiles;
  uint64_t* full;
  uint64_t* empty;
  int stage;
  unsigned phase;
  int held;  // stage whose wgmma group is still in flight, -1 for none
};

// The products of one tile into `acc` (K stage by K stage from the ring),
// with the epilogue of the previous tile (copied to `done`) in slices
// between them. On return every product of the tile has landed in `acc`.
__device__ __forceinline__ void mma_tile(int (&acc)[64], const int (&done)[64], bool has_prev, int prev_tile,
                                         const unsigned char* A, Ring& ring, int nch, int colq,
                                         const float4* __restrict__ bounds, double& s0, double& s1) {
  // at least one K stage (vp >= 128), so the loop body always runs
  int c = 0;
  do {
    mbar_wait(&ring.full[ring.stage], ring.phase);
    if (c == 0) fence_operand(acc);
    wgmma_fence();
    const uint64_t da = sw128_desc(A + c * A_CHUNK);
    const uint64_t db = sw128_desc(ring.tiles + ring.stage * STAGE_BYTES);
#pragma unroll
    for (int k = 0; k < KCHUNK / 32; ++k) wgmma_m64n128k32(acc, da + 2 * k, db + 2 * k, (c | k) != 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products have landed: its ring slot is free
    if (ring.held >= 0) mbar_arrive(&ring.empty[ring.held]);
    ring.held = ring.stage;
    if (++ring.stage == STAGES) {
      ring.stage = 0;
      ring.phase ^= 1;
    }
    if (has_prev && c < PARTS) epilogue_part(done, c, prev_tile, colq, bounds, s0, s1);
  } while (++c < nch);
  if (has_prev)
    for (int p = nch; p < PARTS; ++p) epilogue_part(done, p, prev_tile, colq, bounds, s0, s1);
  wgmma_wait<0>();
  fence_operand(acc);
  mbar_arrive(&ring.empty[ring.held]);
  ring.held = -1;
}

template <int NC>  // consumer warpgroups: block_b = 64 NC
__global__ void __launch_bounds__(128 * (NC + 1), 1)
chained_block(const __grid_constant__ CUtensorMap h8_map, const float4* __restrict__ bounds,
              const float* __restrict__ x_ub, const float* __restrict__ X, float* __restrict__ head,
              float* __restrict__ acc_out, int rows, int vp, int iters) {
  constexpr int BB = CAND_WG * NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* cand = smem;                                   // [NC][Vp/128][64][128 B]
  unsigned char* tiles = cand + (size_t)BB * vp;                // [STAGES][128][128 B]
  double* s_arr = reinterpret_cast<double*>(tiles + STAGES * STAGE_BYTES);  // [2][BB]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_arr + 2 * BB);
  uint64_t* empty = full + STAGES;
  const int nch = vp / KCHUNK;
  const int ntiles = rows / TILE_N;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // producer warpgroup: one thread keeps the ring full, round after round
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * NC) {
      int stage = 0;
      unsigned phase = 0;
      for (int it = 0; it < iters; ++it)
        for (int tile = 0; tile < ntiles; ++tile)
          for (int c = 0; c < nch; ++c) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
            tma_load_2d(tiles + stage * STAGE_BYTES, &h8_map, &full[stage], c * KCHUNK, tile * TILE_N);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int m = warp * 16 + (lane >> 2);  // this thread's candidates m, m + 8
    const int colq = 2 * (lane & 3);
    unsigned char* A = cand + (size_t)wg * CAND_WG * vp;
    const size_t b_wg = (size_t)blockIdx.x * BB + wg * CAND_WG;

    // the warpgroup's candidates as int8, in the swizzled K-major layout
    const int gpr = vp / 16;  // 16-byte granules per candidate row
    for (int e = t; e < CAND_WG * gpr; e += 128) {
      const int r = e / gpr, gk = e % gpr;
      const float4* src = reinterpret_cast<const float4*>(X + (b_wg + r) * vp + 16 * gk);
      const float4 v0 = src[0], v1 = src[1], v2 = src[2], v3 = src[3];
      *reinterpret_cast<int4*>(A + (gk >> 3) * A_CHUNK + sw128(r, gk & 7)) =
          make_int4(pack4(v0.x, v0.y, v0.z, v0.w), pack4(v1.x, v1.y, v1.z, v1.w),
                    pack4(v2.x, v2.y, v2.z, v2.w), pack4(v3.x, v3.y, v3.z, v3.w));
    }
    fence_proxy_async();
    named_barrier(BAR_WG + wg, 128);

    // `acc` receives a tile's products; `done` holds the previous tile's,
    // copied out once they have all landed, for its epilogue: the
    // epilogue never reads registers a product in flight writes
    int acc[64], done[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = done[i] = 0;
    Ring ring{tiles, full, empty, 0, 0u, -1};
    float blk_acc = 0.f;  // the block's running checksum (thread 0)

    for (int it = 0; it < iters; ++it) {
      double s0 = 0.0, s1 = 0.0;  // exact hinge sums of candidates m, m + 8
      for (int tile = 0; tile < ntiles; ++tile) {
        mma_tile(acc, done, tile > 0, tile - 1, A, ring, nch, colq, bounds, s0, s1);
#pragma unroll
        for (int i = 0; i < 64; ++i) done[i] = acc[i];
      }
      for (int p = 0; p < PARTS; ++p) epilogue_part(done, p, ntiles - 1, colq, bounds, s0, s1);
      // the 4 lanes of a candidate hold its terms over disjoint rows
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      double* s_it = s_arr + (it & 1) * BB;
      if ((lane & 3) == 0) {
        s_it[wg * CAND_WG + m] = s0;
        s_it[wg * CAND_WG + m + 8] = s1;
      }
      named_barrier(BAR_CONSUMERS, 128 * NC);
      if (threadIdx.x == 0) {
        float blk = 0.f;
        for (int bb = 0; bb < BB; ++bb) blk = __fadd_rn(blk, __double2float_rn(s_it[bb]));
        blk_acc = __fadd_rn(blk_acc, blk);
      }

      // chained_mutate on the head lanes, in the JAX order of the adds; the
      // int8 copy goes into the first 128-byte block of the candidate's row
      const int r = t >> 1;  // candidate of the warpgroup; lanes 64 (t & 1) ...
      const float sb = __double2float_rn(s_it[wg * CAND_WG + r]);
      float* hrow = head + (b_wg + r) * HEAD;
      for (int g = 4 * (t & 1); g < 4 * (t & 1) + 4; ++g) {
        int words[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 v = *reinterpret_cast<float4*>(hrow + 16 * g + 4 * q);
          float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 16 * g + 4 * q + u;
            const float tt = __fadd_rn(__fadd_rn(sb, static_cast<float>(j)), static_cast<float>(it));
            const float bump = fmodf(tt, 7.f) < 1.f ? 1.f : 0.f;
            e[u] = fminf(__fadd_rn(e[u], bump), __ldg(x_ub + j));
          }
          v = make_float4(e[0], e[1], e[2], e[3]);
          *reinterpret_cast<float4*>(hrow + 16 * g + 4 * q) = v;
          words[q] = pack4(e[0], e[1], e[2], e[3]);
        }
        *reinterpret_cast<int4*>(A + sw128(r, g)) = make_int4(words[0], words[1], words[2], words[3]);
      }
      fence_proxy_async();
      named_barrier(BAR_WG + wg, 128);
    }
    if (threadIdx.x == 0) acc_out[blockIdx.x] = blk_acc;
  }
}

__global__ void chained_sum(const float* __restrict__ blocks, int n, float* __restrict__ checksum) {
  float s = 0.f;
  for (int i = 0; i < n; ++i) s = __fadd_rn(s, blocks[i]);
  *checksum = s;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int ERR_ENCODE = -1;  // cuTensorMapEncodeTiled failed or is missing

int encode_h8_map(CUtensorMap* map, const signed char* H8, int rows, int vp) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return ERR_ENCODE;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)vp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)vp};
  const cuuint32_t box[2] = {KCHUNK, TILE_N};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<signed char*>(H8), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int NC>
int launch(const CUtensorMap& map, const float4* bounds, const float* x_ub, const float* X, float* head,
           float* blocks, float* checksum, int B, int rows, int vp, int iters, cudaStream_t s) {
  constexpr int BB = CAND_WG * NC;
  const size_t smem = smem_bytes(BB, vp);
  cudaError_t err = cudaFuncSetAttribute(chained_block<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chained_block<NC><<<B / BB, 128 * (NC + 1), smem, s>>>(map, bounds, x_ub, X, head, blocks, rows, vp, iters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chained_sum<<<1, 1, 0, s>>>(blocks, B / BB, checksum);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `block_b` candidates needs at width vp.
int chained_score_smem_bytes(int block_b, int vp) { return static_cast<int>(smem_bytes(block_b, vp)); }

// All pointers are device pointers. H8 [rows, vp] int8 row-major; bounds
// [rows] of (lb, ub, w, 0); x_ub the 128 head lanes' bounds; X [B, vp] f32;
// head [B, 128] f32, X's head lanes on entry, the final ones on return.
// B must be a multiple of block_b (64 or 128), vp of 128 and rows of 256
// (the wrapper checks). Returns 0 when every launch was accepted, a
// cudaError_t, or -1 when the tensor map could not be made.
int chained_score_launch(const signed char* H8, const float* bounds, const float* x_ub, const float* X,
                         float* head, float* blocks, float* checksum, int B, int rows, int vp, int iters,
                         int block_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vp % KCHUNK || rows % TILE_N) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int enc = encode_h8_map(&map, H8, rows, vp);
  if (enc != 0) return enc;
  const float4* b4 = reinterpret_cast<const float4*>(bounds);
  switch (block_b) {
    case 64:
      return launch<1>(map, b4, x_ub, X, head, blocks, checksum, B, rows, vp, iters, s);
    case 128:
      return launch<2>(map, b4, x_ub, X, head, blocks, checksum, B, rows, vp, iters, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* chained_score_error_string(int code) {
  if (code == ERR_ENCODE) return "cuTensorMapEncodeTiled failed or is unavailable";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
