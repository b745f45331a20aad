// The search's three incremental sweeps, one hand-written kernel for sm_90a.
//
// Replaces the XLA loops `_sweep_delta`, `_sweep_moves` and `_sweep_moves3`
// of ambigram_tpu/solver/search.py (with the vmapped case axis of
// `_batch_search`) and the `lax.cond` tier gates of `_descend_loop` /
// `_batch_search`. For every case g, member b and move m of one sweep's
// catalogue it computes
//
//     s(g, b, m) = sum_r max(v - ub[r], 0) + max(lb[r] - v, 0),
//     v = hx[g, b, r] + D_m[r],
//
// where the column delta D_m is built from HT = H.T (f32, [G, Vp, Rows])
// with the JAX package's f32 expression: +-H[:, v] (delta), H[:, plus] -
// H[:, minus] (paired), (H[:, b] + H[:, c] - H[:, a]) * s (triple). The
// [G, B, chunk, Rows] temporary of the plain version never reaches device
// memory: a block stages a tile of hx rows and of column deltas in shared
// memory and keeps each (member, move) sum in a register.
//
// Move selection is JAX's, bit for bit. Within a chunk the first minimum
// wins (over [+chunk | -chunk] for the delta sweep); across chunks only a
// strict improvement replaces the running best. Together that is the
// lexicographic minimum of (score, position in that order) over the valid
// moves, so each block folds its (member, move) scores into one 64-bit key
// per member, (score bits << 32) | position (scores are sums of hinges,
// never negative, so their bits order as the floats do), and atomicMin
// merges the blocks in any order with the same result. An invalid move
// (one that would leave [0, x_ub], or padding) scores as the current score
// in JAX and so can never be strictly better than it: it is left out.
//
// Each sweep is two launches, `sweep_score_kernel` (all moves) and
// `sweep_apply_kernel` (one block per member: the improvement test
// best < score - 1e-6, then X, hx and the score), and `sweep_state_kernel`
// folds the members' flags into the descent's state words on the device.
// Every launch reads a gate from the state words and returns at once when
// it is off, so the host can queue whole blocks of descent iterations and
// read one flag per block: the state is JAX's while_loop carry (improved,
// it < max_sweeps, the sweep counts) and its lax.cond predicates.
//
// What bounds it: per hinge about 7 FP32 instructions on the CUDA cores
// (two of them max, at half rate), so at the S=48 triple sweep's 2.85e10
// hinges a case it is bound by operations; the column reads (up to three
// 128-byte lines per move and 32 rows) mostly hit the L2. The adds use the
// _rn intrinsics so that nvcc contracts nothing into an FMA: every value
// is the f32 expression of the plain version, and on integer targets
// (every sum exact) the scores, X and hx are bitwise equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTR = 32;  // rows staged per step
constexpr int kWideBlocks = 264;  // two blocks a SM on 132 SMs: below it, the narrow tile

// the descent's state words (solver/sweeps.py mirrors them)
enum : int {
  S_IMPROVED = 0,
  S_IT = 1,
  S_N_MV = 2,
  S_N_M3 = 3,
  S_ANY1 = 4,
  S_ALL1 = 5,
  S_ANY2 = 6,
  S_ANY3 = 7,
  S_MAX_SWEEPS = 8,
};

enum : int { K_DELTA = 0, K_MOVES = 1, K_MOVES3 = 2 };

struct Catalogue {
  const int* a;          // paired: minus; triple: a
  const int* b;          // paired: plus; triple: b
  const int* c;          // triple: c
  const float* s;        // triple: sign
  const uint8_t* valid;  // triple: padding mask
  int M;                 // moves (delta: 2 * Vp)
  int chunk;             // the delta sweep's [+chunk | -chunk] order
};

struct Move {
  int i0, i1, i2;  // delta: var; paired: minus, plus; triple: a, b, c
  float sg;        // delta and triple: the sign
  bool pad_ok;     // triple: the padding mask
};

// The lax.cond predicates of `_batch_search` (one case: of `_descend_loop`):
// every tier needs the loop to be active; tier 2 runs unless every case
// improved at tier 1, tier 3 only when no case improved at tiers 1 and 2.
__device__ __forceinline__ bool sweep_gate(const int* st, int kind) {
  if (!(st[S_IMPROVED] != 0 && st[S_IT] < st[S_MAX_SWEEPS])) return false;
  if (kind == K_DELTA) return true;
  if (kind == K_MOVES) return st[S_ALL1] == 0;
  return st[S_ANY1] == 0 && st[S_ANY2] == 0;
}

__device__ __forceinline__ Move decode(int kind, const Catalogue& cat, int m) {
  Move mv;
  if (kind == K_DELTA) {
    const int c2 = 2 * cat.chunk;
    const int w = m % c2;
    mv.i0 = (m / c2) * cat.chunk + w % cat.chunk;
    mv.i1 = mv.i2 = 0;
    mv.sg = w < cat.chunk ? 1.0f : -1.0f;
    mv.pad_ok = true;
  } else if (kind == K_MOVES) {
    mv.i0 = cat.a[m];
    mv.i1 = cat.b[m];
    mv.i2 = 0;
    mv.sg = 1.0f;
    mv.pad_ok = true;
  } else {
    mv.i0 = cat.a[m];
    mv.i1 = cat.b[m];
    mv.i2 = cat.c[m];
    mv.sg = cat.s[m];
    mv.pad_ok = cat.valid[m] != 0;
  }
  return mv;
}

// D_m[r] with the plain version's f32 expression (no contraction)
__device__ __forceinline__ float column_delta(int kind, const float* __restrict__ HT, size_t rows, int i0, int i1,
                                              int i2, float sg, int r) {
  if (kind == K_DELTA) {
    const float h = HT[(size_t)i0 * rows + r];
    return sg > 0.0f ? h : -h;
  }
  if (kind == K_MOVES) return __fsub_rn(HT[(size_t)i1 * rows + r], HT[(size_t)i0 * rows + r]);
  const float bc = __fadd_rn(HT[(size_t)i1 * rows + r], HT[(size_t)i2 * rows + r]);
  return __fmul_rn(__fsub_rn(bc, HT[(size_t)i0 * rows + r]), sg);
}

// JAX's validity rules; x and xu are the member's candidate and the box
__device__ __forceinline__ bool move_valid(int kind, const Move& mv, const float* __restrict__ x,
                                           const float* __restrict__ xu) {
  if (kind == K_DELTA) {
    const float xv = x[mv.i0];
    return mv.sg > 0.0f ? !(xv + 1.0f > xu[mv.i0]) : !(xv - 1.0f < 0.0f);
  }
  if (kind == K_MOVES) return x[mv.i0] >= 1.0f && x[mv.i1] + 1.0f <= xu[mv.i1];
  if (!mv.pad_ok) return false;
  const float need_bc = mv.i1 == mv.i2 ? 2.0f : 1.0f;
  if (mv.sg > 0.0f)
    return x[mv.i0] >= 1.0f && x[mv.i1] + need_bc <= xu[mv.i1] && x[mv.i2] + 1.0f <= xu[mv.i2];
  return x[mv.i1] >= need_bc && x[mv.i2] >= 1.0f && x[mv.i0] + 1.0f <= xu[mv.i0];
}

// One block scores TB members x TM moves of case blockIdx.z over all rows;
// each thread holds RB x RM sums. Lanes of a warp share their members and
// take consecutive moves, so hx reads are broadcasts and column-delta reads
// hit 32 banks.
template <int TB, int TM, int RB, int RM>
__global__ void __launch_bounds__(kThreads) sweep_score_kernel(int kind, Catalogue cat, const float* __restrict__ HT,
                                                                const float* __restrict__ lb,
                                                                const float* __restrict__ ub,
                                                                const float* __restrict__ x_ub,
                                                                const float* __restrict__ X,
                                                                const float* __restrict__ hx, int B, int rows, int vp,
                                                                const int* __restrict__ state,
                                                                unsigned long long* __restrict__ best,
                                                                float* __restrict__ move_scores) {
  constexpr int TX = TM / RM;
  constexpr int TY = TB / RB;
  static_assert(TX == 32 && TX * TY == kThreads, "a warp takes one row of the thread grid");
  if (!sweep_gate(state, kind)) return;
  __shared__ float d_s[kTR][TM + 1];
  __shared__ float h_s[TB][kTR + 1];
  __shared__ float lb_s[kTR], ub_s[kTR];
  __shared__ int i0_s[TM], i1_s[TM], i2_s[TM];
  __shared__ float sg_s[TM];

  const int g = blockIdx.z;
  const int m0 = blockIdx.x * TM;
  const int b0 = blockIdx.y * TB;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const size_t R = (size_t)rows;
  const float* HTg = HT + (size_t)g * vp * R;
  const float* lbg = lb + (size_t)g * R;
  const float* ubg = ub + (size_t)g * R;
  const float* hxg = hx + (size_t)g * B * R;

  for (int j = tid; j < TM; j += kThreads) {
    const Move mv = decode(kind, cat, min(m0 + j, cat.M - 1));
    i0_s[j] = mv.i0;
    i1_s[j] = mv.i1;
    i2_s[j] = mv.i2;
    sg_s[j] = mv.sg;
  }
  __syncthreads();

  float acc[RB][RM];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < RM; ++j) acc[i][j] = 0.0f;

  for (int r0 = 0; r0 < rows; r0 += kTR) {
    // rows past the end stage zeros with zero bounds: their hinge is +0
    for (int e = tid; e < kTR * TM; e += kThreads) {
      const int j = e / kTR, r = e % kTR, row = r0 + r;
      d_s[r][j] = row < rows ? column_delta(kind, HTg, R, i0_s[j], i1_s[j], i2_s[j], sg_s[j], row) : 0.0f;
    }
    for (int e = tid; e < kTR * TB; e += kThreads) {
      const int bb = e / kTR, r = e % kTR, row = r0 + r, b = b0 + bb;
      h_s[bb][r] = (row < rows && b < B) ? hxg[(size_t)b * R + row] : 0.0f;
    }
    if (tid < kTR) {
      const int row = r0 + tid;
      lb_s[tid] = row < rows ? lbg[row] : 0.0f;
      ub_s[tid] = row < rows ? ubg[row] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTR; ++r) {
      const float l = lb_s[r], u = ub_s[r];
      float h[RB], d[RM];
#pragma unroll
      for (int i = 0; i < RB; ++i) h[i] = h_s[ty + TY * i][r];
#pragma unroll
      for (int j = 0; j < RM; ++j) d[j] = d_s[r][tx + TX * j];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          const float v = __fadd_rn(h[i], d[j]);
          const float t = __fadd_rn(fmaxf(__fsub_rn(v, u), 0.0f), fmaxf(__fsub_rn(l, v), 0.0f));
          acc[i][j] = __fadd_rn(acc[i][j], t);
        }
    }
    __syncthreads();
  }

  if (move_scores != nullptr) {
    // every move's hinge sum, before the validity mask (for checks only)
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int b = b0 + ty + TY * i, m = m0 + tx + TX * j;
        if (b < B && m < cat.M) move_scores[((size_t)g * B + b) * cat.M + m] = acc[i][j];
      }
  }

#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int b = b0 + ty + TY * i;
    unsigned long long key = ~0ull;
    if (b < B) {
      const float* x = X + ((size_t)g * B + b) * vp;
      const float* xu = x_ub + (size_t)g * vp;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int jl = tx + TX * j, m = m0 + jl;
        if (m >= cat.M) continue;
        Move mv;
        mv.i0 = i0_s[jl];
        mv.i1 = i1_s[jl];
        mv.i2 = i2_s[jl];
        mv.sg = sg_s[jl];
        mv.pad_ok = kind != K_MOVES3 || cat.valid[m] != 0;
        if (!move_valid(kind, mv, x, xu)) continue;
        const unsigned long long k = ((unsigned long long)__float_as_uint(acc[i][j]) << 32) | (unsigned)m;
        key = k < key ? k : key;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
      key = o < key ? o : key;
    }
    if (tx == 0 && b < B && key != ~0ull) atomicMin(&best[(size_t)g * B + b], key);
  }
}

// One block per member: apply its best move when it is strictly better
// than its score by 1e-6 (JAX's rule), and reset its key for the next sweep.
__global__ void __launch_bounds__(kThreads) sweep_apply_kernel(int kind, Catalogue cat, const float* __restrict__ HT,
                                                                const float* __restrict__ x_ub, float* __restrict__ X,
                                                                float* __restrict__ hx, float* __restrict__ scores,
                                                                int B, int rows, int vp, const int* __restrict__ state,
                                                                unsigned long long* __restrict__ best,
                                                                int* __restrict__ imp) {
  if (!sweep_gate(state, kind)) return;
  const int g = blockIdx.y, b = blockIdx.x;
  const size_t gb = (size_t)g * B + b;
  __shared__ int s_ok, s_i0, s_i1, s_i2;
  __shared__ float s_sg;
  if (threadIdx.x == 0) {
    const unsigned long long key = best[gb];
    best[gb] = ~0ull;
    const float val = __uint_as_float((unsigned)(key >> 32));
    const bool ok = key != ~0ull && val < __fsub_rn(scores[gb], 1e-6f);
    imp[gb] = ok ? 1 : 0;
    s_ok = ok;
    if (ok) {
      const Move mv = decode(kind, cat, (int)(key & 0xffffffffull));
      float* x = X + gb * vp;
      const float* xu = x_ub + (size_t)g * vp;
      if (kind == K_DELTA) {
        x[mv.i0] = fminf(fmaxf(__fadd_rn(x[mv.i0], mv.sg), 0.0f), xu[mv.i0]);
      } else {
        // X + one-hot sums, read before any write (indices may coincide)
        const int idx[3] = {mv.i0, mv.i1, mv.i2};
        const int n = kind == K_MOVES ? 2 : 3;
        float nx[3];
        for (int k = 0; k < n; ++k) {
          const int e = idx[k];
          float d;
          if (kind == K_MOVES) {
            d = __fsub_rn(e == mv.i1 ? 1.0f : 0.0f, e == mv.i0 ? 1.0f : 0.0f);
          } else {
            const float bc = __fadd_rn(e == mv.i1 ? 1.0f : 0.0f, e == mv.i2 ? 1.0f : 0.0f);
            d = __fmul_rn(__fsub_rn(bc, e == mv.i0 ? 1.0f : 0.0f), mv.sg);
          }
          nx[k] = __fadd_rn(x[e], d);
        }
        for (int k = 0; k < n; ++k) x[idx[k]] = nx[k];
      }
      scores[gb] = val;
      s_i0 = mv.i0;
      s_i1 = mv.i1;
      s_i2 = mv.i2;
      s_sg = mv.sg;
    }
  }
  __syncthreads();
  if (!s_ok) return;
  const size_t R = (size_t)rows;
  const float* HTg = HT + (size_t)g * vp * R;
  float* h = hx + gb * R;
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    h[r] = __fadd_rn(h[r], column_delta(kind, HTg, R, s_i0, s_i1, s_i2, s_sg, r));
}

// Fold the members' improved flags of one sweep into the state words: per
// case any, then any and all over the cases; count the tier's sweep; and
// after the last tier of an iteration, JAX's loop carry (improved, it).
__global__ void __launch_bounds__(kThreads) sweep_state_kernel(int kind, int last, int G, int B,
                                                                const int* __restrict__ imp,
                                                                int* __restrict__ state) {
  const bool active = state[S_IMPROVED] != 0 && state[S_IT] < state[S_MAX_SWEEPS];
  const bool gate = sweep_gate(state, kind);
  int any_case = 0, all_cases = 1;
  if (gate) {
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      int a = 0;
      for (int b = 0; b < B; ++b) a |= imp[(size_t)g * B + b];
      any_case |= a;
      all_cases &= a;
    }
  }
  const int any = __syncthreads_or(any_case);
  const int all = __syncthreads_and(all_cases);
  if (threadIdx.x != 0 || !active) return;
  if (gate) {
    if (kind == K_DELTA) {
      state[S_ANY1] = any != 0;
      state[S_ALL1] = all != 0;
    } else if (kind == K_MOVES) {
      state[S_ANY2] = any != 0;
      state[S_N_MV] += 1;
    } else {
      state[S_ANY3] = any != 0;
      state[S_N_M3] += 1;
    }
  }
  if (last) {
    state[S_IMPROVED] = (state[S_ANY1] | state[S_ANY2] | state[S_ANY3]) != 0;
    state[S_IT] += 1;
    state[S_ANY1] = state[S_ALL1] = state[S_ANY2] = state[S_ANY3] = 0;
  }
}

template <int TB, int TM, int RB, int RM>
void launch_score(int kind, const Catalogue& cat, const float* HT, const float* lb, const float* ub,
                  const float* x_ub, const float* X, const float* hx, int G, int B, int rows, int vp,
                  const int* state, unsigned long long* best, float* move_scores, cudaStream_t stream) {
  const dim3 grid((cat.M + TM - 1) / TM, (B + TB - 1) / TB, G);
  sweep_score_kernel<TB, TM, RB, RM>
      <<<grid, kThreads, 0, stream>>>(kind, cat, HT, lb, ub, x_ub, X, hx, B, rows, vp, state, best, move_scores);
}

}  // namespace

extern "C" {

// One sweep of kind 0 (delta), 1 (paired) or 2 (triple) over G cases of B
// members, in place on X [G, B, vp], hx [G, B, rows] and scores [G, B];
// imp [G, B] receives each member's improved flag, best [G, B] must hold
// all ones (the apply kernel leaves it so). HT is [G, vp, rows], lb and ub
// [G, rows], x_ub [G, vp]. move_scores, when not null, receives every
// move's hinge sum [G, B, M] (moves in the kernel's order). Returns
// cudaGetLastError() after the launches.
int sweeps_launch(int kind, const int* a, const int* b, const int* c, const float* s, const uint8_t* valid, int M,
                  int chunk, const float* HT, const float* lb, const float* ub, const float* x_ub, float* X, float* hx,
                  float* scores, int G, int B, int rows, int vp, const int* state, unsigned long long* best, int* imp,
                  float* move_scores, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 0 || B <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  Catalogue cat{a, b, c, s, valid, M, chunk};
  const long wide = (long)G * ((B + 31) / 32) * ((M + 127) / 128);
  if (wide >= kWideBlocks)
    launch_score<32, 128, 4, 4>(kind, cat, HT, lb, ub, x_ub, X, hx, G, B, rows, vp, state, best, move_scores, st);
  else
    launch_score<16, 64, 2, 2>(kind, cat, HT, lb, ub, x_ub, X, hx, G, B, rows, vp, state, best, move_scores, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_apply_kernel<<<dim3(B, G), kThreads, 0, st>>>(kind, cat, HT, x_ub, X, hx, scores, B, rows, vp, state, best,
                                                      imp);
  return (int)cudaGetLastError();
}

// Fold one sweep's flags into the state words (one block).
int sweeps_state_launch(int kind, int last, int G, int B, const int* imp, int* state, void* stream) {
  sweep_state_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(kind, last, G, B, imp, state);
  return (int)cudaGetLastError();
}

const char* sweeps_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
