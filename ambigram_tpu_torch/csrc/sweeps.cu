// The search's three incremental sweeps, one hand-written kernel for sm_90a.
//
// Replaces the XLA loops `_sweep_delta`, `_sweep_moves` and `_sweep_moves3`
// of ambigram_tpu/solver/search.py (with the vmapped case axis of
// `_batch_search`) and the `lax.cond` tier gates of `_descend_loop` /
// `_batch_search`. For every case g, member b and move m of one sweep's
// catalogue the function is
//
//     s(g, b, m) = sum_r hinge(hx[g, b, r] + D_m[r]),
//     hinge(v) = max(v - ub[r], 0) + max(lb[r] - v, 0),
//
// with the column delta D_m of the JAX package's f32 expression: +-H[:, v]
// (delta), H[:, plus] - H[:, minus] (paired), (H[:, b] + H[:, c] - H[:, a])
// * s (triple).
//
// H is sparse (1-3% of its entries are not zero; a column holds 90-480 of
// 3840-57600 rows), and D_m is zero outside U_m, the union of the supports
// of the move's distinct columns, where the hinge does not change. So the
// kernel computes
//
//     s(g, b, m) = base(g, b) + sum_{r in U_m} hinge(hx + D_m[r]) - hinge(hx),
//
// with base(g, b) the member's dense hinge sum over every row, and visits
// only the rows of U_m. On integer targets every term is a multiple of 0.5
// and every partial sum is exact, so this equals the dense sum bit for bit
// in any order; on noisy targets it rounds differently (within 1e-5).
// Since lb <= ub on every row (the wrapper checks it once per program), at
// most one of the hinge's two terms is not zero, and the hinge is
// max(max(v - ub, lb - v), 0), bit for bit.
//
// Operands (built once per program by solver/sweeps.py, `sparse_columns`):
// the columns of H as sorted (row, value bits) entries, each column ended
// by a sentinel entry of row kEnd, with the offsets ptr [G, vp + 1]; the
// bounds as (lb, ub) pairs [G, rows]; and a member-major copy of hx,
// hxT [G, rows, B], which the apply kernel keeps in step with hx.
//
// `sweep_score_kernel`: one warp (the whole block) takes one move (the
// delta sweep: one column, both its +1 and -1 moves) for 32 members of one
// case, a member on each lane. A move that is invalid for every lane ends
// at once, and the card's block scheduler spreads the few moves that some
// member may take over the SMs (in the S=48 triple catalogue 3.1% of the
// moves at B=32). The warp merges the sorted lists of the move's columns,
// kStage rows of U_m at a time, into shared memory, then sums the hinge
// over those rows: a row is one coalesced 128-byte line of hxT and
// broadcasts of the (lb, ub) pair.
//
// Move selection is JAX's, bit for bit. Within a chunk the first minimum
// wins (over [+chunk | -chunk] for the delta sweep); across chunks only a
// strict improvement replaces the running best. Together that is the
// lexicographic minimum of (score, position in that order) over the valid
// moves, so each lane makes its move one 64-bit key, (score bits << 32) |
// position (scores are sums of hinges, never negative, so their bits order
// as the floats do), and atomicMin merges the warps in any order with the
// same result. An invalid move (one that would leave [0, x_ub], or
// padding) scores as the current score in JAX and so can never be strictly
// better than it: it is left out.
//
// `sweep_apply_kernel` (one block per member): the improvement test, then
// X, the score, hx and hxT over U_m only, and the member's new base. JAX
// tests best < score - 1e-6; the kernel tests best < base - 1e-6, against
// the sum its own best was formed from. On integer targets the two are
// the same number. On noisy ones the score (K1's, or the last move's
// base + change) and the recomputed base round apart by more than 1e-6,
// and a test against the score would take a move that changes no hinge
// (base + 0) as an improvement whenever the score rounded above the base:
// accepts must be strictly improving, since the tier gates read them.
//
// `sweep_state_kernel` folds the members' flags into the descent's state
// words on the device. Every launch reads a gate from the state words and
// returns at once when it is off, so the host can queue whole blocks of
// descent iterations and read one flag per block: the state is JAX's
// while_loop carry (improved, it < max_sweeps, the sweep counts) and its
// lax.cond predicates.
//
// What bounds it: not the bytes nor the operations of the visited rows (a
// few microseconds at S=48) but latency: a warp walks U_m a row at a time
// (the merge's compare-and-step, then the row's reads), and the block
// scheduler passes over every move's block, most of which end at the
// validity test. The adds use the _rn intrinsics so that nvcc contracts
// nothing into an FMA: every value is the f32 expression of the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the apply, base and state kernels (the score kernel: one warp)
constexpr int kStage = 32;  // rows of U_m a warp merges before it sums their hinges
constexpr int kEnd = 0x7fffffff;  // the row of a column's sentinel entry

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
  int M;                 // moves (delta: 2 * vp)
  int chunk;             // the delta sweep's [+chunk | -chunk] order
};

// The sparse columns of one group: column v of case g is the entries
// ent[g * E + ptr[g * (vp + 1) + v] ...], sorted by row, then a sentinel.
struct Columns {
  const int* ptr;   // [G, vp + 1]
  const int2* ent;  // [G, E]: (row, value bits)
  long long E;
  int vp;
  __device__ __forceinline__ const int2* col(int g, int v) const {
    return ent + (size_t)g * E + ptr[(size_t)g * (vp + 1) + v];
  }
  __device__ __forceinline__ int count(int g, int v) const {
    const int* p = ptr + (size_t)g * (vp + 1) + v;
    return p[1] - p[0] - 1;
  }
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

// move m at its position in the kernel's order
__device__ __forceinline__ Move decode(int kind, const Catalogue& cat, int m) {
  Move mv;
  if (kind == K_DELTA) {
    const int c2 = 2 * cat.chunk;
    const int w = m % c2;
    mv.i0 = (m / c2) * cat.chunk + w % cat.chunk;
    mv.i1 = mv.i2 = mv.i0;
    mv.sg = w < cat.chunk ? 1.0f : -1.0f;
    mv.pad_ok = true;
  } else if (kind == K_MOVES) {
    mv.i0 = cat.a[m];
    mv.i1 = cat.b[m];
    mv.i2 = mv.i1;
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

// JAX's validity rules for a paired or triple move; x and xu are the
// member's candidate and the box
__device__ __forceinline__ bool move_valid(int kind, const Move& mv, const float* __restrict__ x,
                                           const float* __restrict__ xu) {
  if (kind == K_MOVES) return x[mv.i0] >= 1.0f && x[mv.i1] + 1.0f <= xu[mv.i1];
  if (!mv.pad_ok) return false;
  const float need_bc = mv.i1 == mv.i2 ? 2.0f : 1.0f;
  if (mv.sg > 0.0f)
    return x[mv.i0] >= 1.0f && x[mv.i1] + need_bc <= xu[mv.i1] && x[mv.i2] + 1.0f <= xu[mv.i2];
  return x[mv.i1] >= need_bc && x[mv.i2] >= 1.0f && x[mv.i0] + 1.0f <= xu[mv.i0];
}

// max(v - ub, 0) + max(lb - v, 0), bit for bit while lb <= ub
__device__ __forceinline__ float hinge(float v, float2 lu) {
  return fmaxf(fmaxf(__fsub_rn(v, lu.y), __fsub_rn(lu.x, v)), 0.0f);
}

// D_m[r] from the values of the move's columns i0, i1, i2 at row r, with
// the plain version's f32 expression (no contraction)
template <int KIND>
__device__ __forceinline__ float column_delta(float h0, float h1, float h2, float sg) {
  if (KIND == K_DELTA) return sg > 0.0f ? h0 : -h0;
  if (KIND == K_MOVES) return __fsub_rn(h1, h0);
  return __fmul_rn(__fsub_rn(__fadd_rn(h1, h2), h0), sg);
}

// A read position in one sorted column list.
struct Cursor {
  const int2* e;
  int row;
  float val;
  __device__ __forceinline__ void init(const int2* p) {
    e = p;
    const int2 v = __ldg(e);
    row = v.x;
    val = __int_as_float(v.y);
  }
  // the column's value at row r (0 when absent); steps past it
  __device__ __forceinline__ float take(int r) {
    if (row != r) return 0.0f;
    const float v = val;
    const int2 n = __ldg(++e);
    row = n.x;
    val = __int_as_float(n.y);
    return v;
  }
};

// sum over U_m of hinge(h + D_m[r]) - hinge(h) for one lane's member of a
// paired (two lists) or triple (three lists) move; `hb` is the member's
// column of hxT (row r at hb[r * B]). The warp merges the sorted lists
// kStage rows of U_m at a time (identical lists step together) into its
// `stage` as (row, D_m[row]) pairs, then sums their hinges, whose reads
// do not depend on each other. `n` receives |U_m|.
template <int KIND>
__device__ __forceinline__ float union_sum(const Columns& cols, int g, const Move& mv, const float* __restrict__ hb,
                                           int B, const float2* __restrict__ bnd, int2* stage, int lane, int& n) {
  constexpr bool kThree = KIND == K_MOVES3;
  Cursor c0, c1, c2;
  c0.init(cols.col(g, mv.i0));
  c1.init(cols.col(g, mv.i1));
  if (kThree) c2.init(cols.col(g, mv.i2));
  float acc = 0.0f;
  int visited = 0;
  for (;;) {
    int k = 0;
    for (; k < kStage; ++k) {
      const int r = kThree ? min(c0.row, min(c1.row, c2.row)) : min(c0.row, c1.row);
      if (r == kEnd) break;
      const float v0 = c0.take(r), v1 = c1.take(r), v2 = kThree ? c2.take(r) : 0.0f;
      if (lane == 0) stage[k] = make_int2(r, __float_as_int(column_delta<KIND>(v0, v1, v2, mv.sg)));
    }
    __syncwarp();
#pragma unroll 8
    for (int i = 0; i < k; ++i) {
      const int2 e = stage[i];
      const float h = hb[(size_t)e.x * B];
      const float2 lu = bnd[e.x];
      acc = __fadd_rn(acc, __fsub_rn(hinge(__fadd_rn(h, __int_as_float(e.y)), lu), hinge(h, lu)));
    }
    __syncwarp();
    visited += k;
    if (k < kStage) break;
  }
  n = visited;
  return acc;
}

// base + the union's sum as a score (a -0 becomes +0, so its bits order)
__device__ __forceinline__ float move_score(float base, float acc) {
  return __fadd_rn(fmaxf(__fadd_rn(base, acc), 0.0f), 0.0f);
}

__device__ __forceinline__ unsigned long long key_of(float s, int pos) {
  return ((unsigned long long)__float_as_uint(s) << 32) | (unsigned)pos;
}

// One warp (the block) scores move (delta: column) blockIdx.x of case
// blockIdx.z for the 32 members blockIdx.y * 32 + lane.
template <int KIND>
__global__ void __launch_bounds__(32) sweep_score_kernel(
    Catalogue cat, Columns cols, const float2* __restrict__ bnd_all, const float* __restrict__ x_ub,
    const float* __restrict__ X, const float* __restrict__ hxT, const float* __restrict__ base, int B, int rows,
    int vp, const int* __restrict__ state, unsigned long long* __restrict__ best, float* __restrict__ move_scores,
    int* __restrict__ visits) {
  if (!sweep_gate(state, KIND)) return;
  __shared__ int2 stage[kStage];
  const int g = blockIdx.z, u = blockIdx.x;
  const int lane = threadIdx.x;
  const int b = blockIdx.y * 32 + lane;
  const bool live = b < B;
  const int bl = live ? b : B - 1;  // idle lanes read a live member's values
  const float* x = X + ((size_t)g * B + bl) * vp;
  const float* xu = x_ub + (size_t)g * vp;
  const float* hb = hxT + (size_t)g * rows * B + bl;
  const float2* bnd = bnd_all + (size_t)g * rows;
  const float my_base = base[(size_t)g * B + bl];
  const bool all_moves = move_scores != nullptr;
  unsigned long long key = ~0ull;

  if (KIND == K_DELTA) {
    // column u: its +1 and -1 moves in one pass
    const float xv = x[u];
    const bool ok_p = live && !(xv + 1.0f > xu[u]);
    const bool ok_m = live && !(xv - 1.0f < 0.0f);
    if (!all_moves && !__any_sync(0xffffffffu, ok_p || ok_m)) return;
    const int2* e = cols.col(g, u);
    const int n = cols.count(g, u);
    float ap = 0.0f, am = 0.0f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const int2 en = __ldg(e + i);
      const float d = __int_as_float(en.y);
      const float h = hb[(size_t)en.x * B];
      const float2 lu = bnd[en.x];
      const float h0 = hinge(h, lu);
      ap = __fadd_rn(ap, __fsub_rn(hinge(__fadd_rn(h, d), lu), h0));
      am = __fadd_rn(am, __fsub_rn(hinge(__fadd_rn(h, -d), lu), h0));
    }
    const int pos = (u / cat.chunk) * 2 * cat.chunk + u % cat.chunk;
    const float sp = move_score(my_base, ap), sm = move_score(my_base, am);
    if (all_moves && live) {
      float* out = move_scores + ((size_t)g * B + b) * cat.M;
      out[pos] = sp;
      out[pos + cat.chunk] = sm;
    }
    if (visits != nullptr && lane == 0 && blockIdx.y == 0) {
      visits[(size_t)g * cat.M + pos] = n;
      visits[(size_t)g * cat.M + pos + cat.chunk] = n;
    }
    if (ok_p) key = key_of(sp, pos);
    if (ok_m) key = min(key, key_of(sm, pos + cat.chunk));
  } else {
    const Move mv = decode(KIND, cat, u);
    const bool ok = live && move_valid(KIND, mv, x, xu);
    if (!all_moves && !__any_sync(0xffffffffu, ok)) return;
    int n;
    const float acc = union_sum<KIND>(cols, g, mv, hb, B, bnd, stage, lane, n);
    const float s = move_score(my_base, acc);
    if (all_moves && live) move_scores[((size_t)g * B + b) * cat.M + u] = s;
    if (visits != nullptr && lane == 0 && blockIdx.y == 0) visits[(size_t)g * cat.M + u] = n;
    if (ok) key = key_of(s, u);
  }
  if (key != ~0ull) atomicMin(&best[(size_t)g * B + b], key);
}

// The dense hinge sum of one member's hx row, in a fixed order (a strided
// sum per thread, then a tree over the block); every thread gets it.
__device__ float block_hinge_sum(const float* __restrict__ h, const float2* __restrict__ bnd, int rows) {
  __shared__ float part[kThreads / 32];
  float s = 0.0f;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) s = __fadd_rn(s, hinge(h[r], bnd[r]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) total = __fadd_rn(total, part[w]);
  __syncthreads();
  return total;
}

// One block per member (b, g): its dense base.
__global__ void __launch_bounds__(kThreads) sweep_base_kernel(const float* __restrict__ hx,
                                                               const float2* __restrict__ bnd, float* __restrict__ base,
                                                               int B, int rows) {
  const int g = blockIdx.y, b = blockIdx.x;
  const size_t gb = (size_t)g * B + b;
  const float s = block_hinge_sum(hx + gb * rows, bnd + (size_t)g * rows, rows);
  if (threadIdx.x == 0) base[gb] = s;
}

// The value of a column at row r (0 when absent): a binary search of its n
// sorted entries.
__device__ __forceinline__ float lookup(const int2* __restrict__ e, int n, int r, bool& found) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (e[mid].x < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  found = lo < n && e[lo].x == r;
  return found ? __int_as_float(e[lo].y) : 0.0f;
}

// One block per member: apply its best move when it is better than the
// member's base by 1e-6 (so a move whose change is not negative never
// passes), and reset its key for the next sweep.
// hx and hxT change on U_m only (D_m is zero elsewhere); a row of U_m is
// the first distinct column's that holds it, so each is written once.
__global__ void __launch_bounds__(kThreads) sweep_apply_kernel(
    int kind, Catalogue cat, Columns cols, const float2* __restrict__ bnd_all, const float* __restrict__ x_ub,
    float* __restrict__ X, float* __restrict__ hx, float* __restrict__ hxT, float* __restrict__ scores,
    float* __restrict__ base, int B, int rows, int vp, const int* __restrict__ state,
    unsigned long long* __restrict__ best, int* __restrict__ imp) {
  if (!sweep_gate(state, kind)) return;
  const int g = blockIdx.y, b = blockIdx.x;
  const size_t gb = (size_t)g * B + b;
  __shared__ int s_ok;
  __shared__ Move s_mv;
  if (threadIdx.x == 0) {
    const unsigned long long key = best[gb];
    best[gb] = ~0ull;
    const float val = __uint_as_float((unsigned)(key >> 32));
    const bool ok = key != ~0ull && val < __fsub_rn(base[gb], 1e-6f);
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
      s_mv = mv;
    }
  }
  __syncthreads();
  if (!s_ok) return;
  const Move mv = s_mv;
  const int idx[3] = {mv.i0, mv.i1, mv.i2};
  const int2* lists[3];
  int counts[3];
  for (int k = 0; k < 3; ++k) {
    lists[k] = cols.col(g, idx[k]);
    counts[k] = cols.count(g, idx[k]);
  }
  const int n_cols = kind == K_DELTA ? 1 : (kind == K_MOVES ? 2 : 3);
  float* h = hx + gb * rows;
  float* ht = hxT + (size_t)g * rows * B + b;
  for (int k = 0; k < n_cols; ++k) {
    bool repeat = false;  // the same column as an earlier one: its rows are done
    for (int j = 0; j < k; ++j) repeat |= idx[j] == idx[k];
    if (repeat) continue;
    for (int i = threadIdx.x; i < counts[k]; i += blockDim.x) {
      const int2 en = lists[k][i];
      const int r = en.x;
      bool earlier = false;
      float v[3] = {0.0f, 0.0f, 0.0f};
      for (int j = 0; j < n_cols; ++j) {
        bool found = false;
        v[j] = idx[j] == idx[k] ? __int_as_float(en.y) : lookup(lists[j], counts[j], r, found);
        if (j < k && idx[j] != idx[k] && found) earlier = true;
      }
      if (earlier) continue;  // row r belongs to an earlier column's list
      float d;
      if (kind == K_DELTA)
        d = column_delta<K_DELTA>(v[0], 0.0f, 0.0f, mv.sg);
      else if (kind == K_MOVES)
        d = column_delta<K_MOVES>(v[0], v[1], 0.0f, mv.sg);
      else
        d = column_delta<K_MOVES3>(v[0], v[1], v[2], mv.sg);
      h[r] = __fadd_rn(h[r], d);
      ht[(size_t)r * B] = __fadd_rn(ht[(size_t)r * B], d);
    }
  }
  __syncthreads();
  const float s = block_hinge_sum(h, bnd_all + (size_t)g * rows, rows);
  if (threadIdx.x == 0) base[gb] = s;
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

}  // namespace

extern "C" {

// One sweep of kind 0 (delta), 1 (paired) or 2 (triple) over G cases of B
// members, in place on X [G, B, vp], hx [G, B, rows], its member-major copy
// hxT [G, rows, B], scores [G, B] and the members' dense hinge sums base
// [G, B] (`sweeps_base_launch`); imp [G, B] receives each member's improved
// flag, best [G, B] must hold all ones (the apply kernel leaves it so). The
// columns are ptr [G, vp + 1] and ent [G, E] (int2 (row, value bits)), bnd
// the (lb, ub) pairs [G, rows], x_ub [G, vp]. move_scores, when not null,
// receives every move's score [G, B, M] (moves in the kernel's order, none
// skipped) and visits, when not null, every move's |U_m| [G, M]. Returns
// cudaGetLastError() after the launches.
int sweeps_launch(int kind, const int* a, const int* b, const int* c, const float* s, const uint8_t* valid, int M,
                  int chunk, const int* col_ptr, const void* col_ent, long long E, const void* bnd,
                  const float* x_ub, float* X, float* hx, float* hxT, float* scores, float* base, int G, int B,
                  int rows, int vp, const int* state, unsigned long long* best, int* imp, float* move_scores,
                  int* visits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 0 || B <= 0 || M <= 0 || kind < K_DELTA || kind > K_MOVES3) return (int)cudaErrorInvalidValue;
  Catalogue cat{a, b, c, s, valid, M, chunk};
  Columns cols{col_ptr, (const int2*)col_ent, E, vp};
  const float2* bd = (const float2*)bnd;
  // a warp per move (delta: per column) and 32 members
  const dim3 grid(kind == K_DELTA ? vp : M, (B + 31) / 32, G);
  if (kind == K_DELTA)
    sweep_score_kernel<K_DELTA><<<grid, 32, 0, st>>>(cat, cols, bd, x_ub, X, hxT, base, B, rows, vp, state,
                                                           best, move_scores, visits);
  else if (kind == K_MOVES)
    sweep_score_kernel<K_MOVES><<<grid, 32, 0, st>>>(cat, cols, bd, x_ub, X, hxT, base, B, rows, vp, state,
                                                           best, move_scores, visits);
  else
    sweep_score_kernel<K_MOVES3><<<grid, 32, 0, st>>>(cat, cols, bd, x_ub, X, hxT, base, B, rows, vp, state,
                                                            best, move_scores, visits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_apply_kernel<<<dim3(B, G), kThreads, 0, st>>>(kind, cat, cols, bd, x_ub, X, hx, hxT, scores, base, B, rows,
                                                      vp, state, best, imp);
  return (int)cudaGetLastError();
}

// The members' dense hinge sums base [G, B] of hx [G, B, rows] (ungated).
int sweeps_base_launch(const float* hx, const void* bnd, float* base, int G, int B, int rows, void* stream) {
  if (G <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  sweep_base_kernel<<<dim3(B, G), kThreads, 0, (cudaStream_t)stream>>>(hx, (const float2*)bnd, base, B, rows);
  return (int)cudaGetLastError();
}

// Fold one sweep's flags into the state words (one block).
int sweeps_state_launch(int kind, int last, int G, int B, const int* imp, int* state, void* stream) {
  sweep_state_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(kind, last, G, B, imp, state);
  return (int)cudaGetLastError();
}

const char* sweeps_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
