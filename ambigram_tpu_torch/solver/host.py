"""The device search's host-side helpers, without JAX.

Copied with no change of meaning from ambigram_tpu/solver/search.py,
whose module imports jax: the epsilon lattice and the LP certificate,
population seeding, and the paired and triple move catalogues. The
tests hold every function here equal to its original. `_lp_solve`
takes G's CSR from the program (engine/ilp.py `g_csr`) where the
original converts the dense G on every call; the LP it hands HiGHS is
the same.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ambigram_tpu_torch.engine.enumerate import pair_index
from ambigram_tpu_torch.engine.ilp import BfbProgram, g_csr


def half_ceil(x: float, eps: float = 1e-6) -> float:
    """Round a bound up to the next multiple of 0.5."""
    return math.ceil((x - eps) * 2.0) / 2.0


def eps_quantum(prog: BfbProgram) -> float:
    """Lattice spacing of achievable epsilon sums: 0.5 when every
    residual target AND every residual coefficient is a half-integer
    (row values A.x are then half-integer multiples for integer x, so
    each |row - c| and their sum land on the 0.5 lattice); 0.0
    otherwise: fractional (noise-derived) targets put epsilon
    off-lattice, and rounding the LP bound up would then be UNSOUND."""
    q = getattr(prog, "_eps_quantum_cache", None)
    if q is not None:
        return q
    c = np.concatenate([prog.c_seg, prog.c_fbi])
    q = 0.0
    if np.all(np.abs(c * 2.0 - np.round(c * 2.0)) < 1e-9):
        A = np.concatenate([prog.A_seg, prog.A_fbi], axis=0)
        if np.all(np.abs(A * 2.0 - np.round(A * 2.0)) < 1e-9):
            # coupling rows (targets 0, coefficients +-1) are always on
            # the lattice, so they never demote the quantum
            q = 0.5
    # cache on the program object: the A scan is O(rows*V) and
    # certification asks repeatedly during LNS screening
    object.__setattr__(prog, "_eps_quantum_cache", q)
    return q


def certified_bound(prog: BfbProgram, lb: float) -> float:
    """The sharpest sound optimality threshold from an LP bound: the
    bound rounded up to the epsilon lattice when one exists, the raw
    bound otherwise."""
    return half_ceil(lb) if eps_quantum(prog) > 0.0 else lb


def lp_relaxation(prog: BfbProgram):
    """Solve the LP relaxation; returns (bound, x_fractional) or
    (None, None)."""
    res = _lp_solve(prog)
    if res is None or not res.success:
        return None, None
    return float(res.fun), res.x[: prog.num_vars]


def lp_lower_bound(prog: BfbProgram) -> Optional[float]:
    bound, _ = lp_relaxation(prog)
    return bound


def _lp_solve(prog: BfbProgram):
    """LP-relaxation lower bound on the integer epsilon sum (sparse
    block assembly so large programs stay fast). None if scipy is
    unavailable."""
    try:
        from scipy.optimize import linprog
        from scipy.sparse import coo_matrix, csr_matrix, eye, hstack, vstack
    except ImportError:  # pragma: no cover
        return None
    V = prog.num_vars
    A_dense = np.concatenate([prog.A_seg, prog.A_fbi], axis=0)
    c_res = np.concatenate([prog.c_seg, prog.c_fbi, np.zeros(prog.num_coupling)])
    A_sp = csr_matrix(A_dense)
    if prog.num_coupling:
        # coupling rows assembled sparsely (2 nonzeros each): the dense
        # materialization is gigabytes at single-cell scale
        P = prog.num_coupling
        r = np.arange(P)
        coup = coo_matrix(
            (
                np.concatenate([np.ones(P), -np.ones(P)]),
                (
                    np.concatenate([r, r]),
                    np.concatenate([prog.coupling[:, 0], prog.coupling[:, 1]]),
                ),
            ),
            shape=(P, V),
        ).tocsr()
        A_sp = vstack([A_sp, coup], format="csr")
    E = A_sp.shape[0]
    c = np.zeros(V + E)
    c[V:] = 1.0
    I = eye(E, format="csr")
    blocks = [hstack([-A_sp, -I]), hstack([A_sp, -I])]
    b_parts = [-c_res, c_res]
    if prog.G.shape[0]:
        G_sp = g_csr(prog)
        fin_ub = np.isfinite(prog.g_ub)
        if fin_ub.any():
            blocks.append(hstack([G_sp[fin_ub], csr_matrix((int(fin_ub.sum()), E))]))
            b_parts.append(prog.g_ub[fin_ub])
        fin_lb = np.isfinite(prog.g_lb)
        if fin_lb.any():
            blocks.append(hstack([-G_sp[fin_lb], csr_matrix((int(fin_lb.sum()), E))]))
            b_parts.append(-prog.g_lb[fin_lb])
    A_ub = vstack(blocks, format="csr")
    b_ub = np.concatenate(b_parts)
    bounds = [(0, ub) for ub in prog.x_ub] + [(0, None)] * E
    return linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")


def _pair_idx(prog: BfbProgram, i: int, j: int) -> int:
    return pair_index(prog.start, prog.end, i, j)


def _seed_population(
    prog: BfbProgram, Vp: int, x_ub: np.ndarray, pop: int, seed: int
) -> np.ndarray:
    T = len(prog.pairs)
    K = prog.num_vars // (2 * T) if T else 1  # clone blocks (engine/sc.py)
    X = np.zeros((pop, Vp), dtype=np.float32)
    rng = np.random.default_rng(seed)
    root = _pair_idx(prog, prog.start, prog.end)
    for blk in range(K):
        off = blk * 2 * T
        # member 0: all-zero (pure constructive descent)
        # member 1: the reference pattern p(start, end) = 1, every clone
        if pop > 1:
            X[1, off + root] = 1
        # member 2: the top loop l(start, end) = 1, every clone
        if pop > 2:
            X[2, off + T + root] = 1
        # rest: sparse random loop starts per clone
        for b in range(3, pop):
            k = rng.integers(1, 4)
            idx = rng.integers(0, T, size=k)
            X[b, off + T + idx] = rng.integers(1, 3, size=k)
    return np.minimum(X, np.asarray(x_ub, dtype=np.float32))


def greedy_peel_seed(prog: BfbProgram) -> np.ndarray:
    """Water-level decomposition of the CN profile into loops and
    patterns, the natural constructive BFB start: repeatedly take the
    longest run of residual CN >= 2 and subtract a loop, then cover the
    remaining runs of 1 with patterns. Ignores the nesting constraints
    (descent repairs those). Single-cell block programs peel each
    clone's profile into its own block."""
    n = prog.n
    T = len(prog.pairs)
    K = prog.num_vars // (2 * T) if T else 1
    if K > 1:
        x = np.zeros(prog.num_vars, dtype=np.float32)
        for blk in range(K):
            sub = BfbProgram(
                start=prog.start,
                end=prog.end,
                pairs=prog.pairs,
                A_seg=prog.A_seg[blk * n : (blk + 1) * n, blk * 2 * T : (blk + 1) * 2 * T],
                c_seg=prog.c_seg[blk * n : (blk + 1) * n],
                A_fbi=np.zeros((0, 2 * T)),
                c_fbi=np.zeros(0),
                G=np.zeros((0, 2 * T)),
                g_lb=np.zeros(0),
                g_ub=np.zeros(0),
                x_ub=prog.x_ub[blk * 2 * T : (blk + 1) * 2 * T],
                bias=0,
            )
            x[blk * 2 * T : (blk + 1) * 2 * T] = greedy_peel_seed(sub)
        return x
    c = prog.c_seg.astype(np.float64).copy()
    x = np.zeros(prog.num_vars, dtype=np.float32)

    def longest_run(mask: np.ndarray):
        best = (0, -1, -1)  # (len, i, j)
        i = 0
        while i < n:
            if mask[i]:
                j = i
                while j + 1 < n and mask[j + 1]:
                    j += 1
                if j - i + 1 > best[0]:
                    best = (j - i + 1, i, j)
                i = j + 1
            else:
                i += 1
        return best

    for _ in range(4 * n):  # bounded; each step strictly reduces sum(c)
        ln, i, j = longest_run(c >= 2.0)
        if ln == 0:
            break
        amount = max(1.0, float(np.floor(c[i : j + 1].min() / 2.0)))
        t = T + _pair_idx(prog, prog.start + i, prog.start + j)
        amount = min(amount, float(prog.x_ub[t]) - float(x[t]))
        if amount < 1.0:
            break
        x[t] += amount
        c[i : j + 1] -= 2.0 * amount
    for _ in range(2 * n):
        ln, i, j = longest_run(c >= 1.0)
        if ln == 0:
            break
        t = _pair_idx(prog, prog.start + i, prog.start + j)
        if x[t] >= prog.x_ub[t]:
            c[i : j + 1] -= 1.0  # can't cover again; stop revisiting
            continue
        x[t] += 1.0
        c[i : j + 1] -= 1.0
    return x


def _seed_case(prog: BfbProgram, Vp: int, x_ub_np: np.ndarray, pop: int, seed: int):
    """Full population seeding for one case: the fixed constructive
    seeds (zero / root pattern / top loop / greedy peel), the LP
    relaxation's roundings, and sparse random starts. Returns
    (X0 [pop, Vp] float32, lp_lower_bound-or-None)."""
    X0 = np.array(_seed_population(prog, Vp, x_ub_np, pop, seed))

    def place(slot: int, member: np.ndarray) -> None:
        xi = np.zeros(Vp, dtype=np.float32)
        xi[: prog.num_vars] = np.clip(member, 0, prog.x_ub)
        X0[slot] = xi

    # constructive seed: greedy loop/pattern peel of the CN profile
    if pop > 3:
        place(3, greedy_peel_seed(prog))
    # LP-rounding seeds: the relaxation is cheap on host and its
    # roundings cluster around the integer optimum
    lb, x_frac = lp_relaxation(prog)
    if x_frac is not None and pop > 5:
        place(4, np.round(x_frac))
        place(5, np.floor(x_frac))
        # a few randomized roundings populate the LP basin; the rest of
        # the population stays random for basin diversity
        rr = np.random.default_rng(seed + 1)
        frac = x_frac - np.floor(x_frac)
        for slot in range(6, min(pop, 10)):
            place(slot, np.floor(x_frac) + (rr.random(len(x_frac)) < frac))
    return X0, lb


def split_merge_moves(
    prog: BfbProgram, pad_to: int = 512, max_moves: int = 262144
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The triple-move catalogue for `sweep_moves3`, three families per
    (i, j, k):

    - contiguous loop split/merge   l(i,j) <-> l(i,k) + l(k+1,j)
    - overlapping loop split/merge  l(i,j) <-> l(i,k) + l(k,j)
    - pattern split/merge           p(i,j) <-> p(i,k) + p(k+1,j)

    O(n^3) triples; above `max_moves` the split point k is strided so
    the set stays bounded. For single-cell block programs the set
    replicates per clone block. Returns (a, b, c, sign, valid) padded to
    a multiple of `pad_to`."""
    T = len(prog.pairs)
    n = prog.n

    def pidx(a: int, b: int) -> int:
        return pair_index(prog.start, prog.end, a, b)

    # triple count before striding: ~3 * n^3 / 6 per sign
    est = n * n * n // 2
    stride = max(1, int(np.ceil(est / max(max_moves // 2, 1))))
    triples = []  # (a, b, c) variable-index triples, sign applied later
    for t, (i, j) in enumerate(prog.pairs):
        if j <= i:
            continue
        for k in range(int(i), int(j), stride):
            # contiguous: l(i,j) <-> l(i,k) + l(k+1,j)
            triples.append((T + t, T + pidx(int(i), k), T + pidx(k + 1, int(j))))
            # pattern: p(i,j) <-> p(i,k) + p(k+1,j)
            triples.append((t, pidx(int(i), k), pidx(k + 1, int(j))))
            if k > int(i):
                # overlapping: l(i,j) <-> l(i,k) + l(k,j)
                triples.append((T + t, T + pidx(int(i), k), T + pidx(k, int(j))))
    base = np.asarray(triples, dtype=np.int32) if triples else np.zeros((0, 3), np.int32)
    K = prog.num_vars // (2 * T) if T else 1
    if K > 1 and len(base):
        base = np.concatenate([base + k * 2 * T for k in range(K)], axis=0)
    # both signs per triple
    n_t = len(base)
    M = ((2 * n_t + pad_to - 1) // pad_to) * pad_to if n_t else pad_to
    a = np.zeros(M, dtype=np.int32)
    b = np.zeros(M, dtype=np.int32)
    c = np.zeros(M, dtype=np.int32)
    s = np.ones(M, dtype=np.float32)
    valid = np.zeros(M, dtype=bool)
    if n_t:
        a[: 2 * n_t] = np.concatenate([base[:, 0], base[:, 0]])
        b[: 2 * n_t] = np.concatenate([base[:, 1], base[:, 1]])
        c[: 2 * n_t] = np.concatenate([base[:, 2], base[:, 2]])
        s[n_t : 2 * n_t] = -1.0
        valid[: 2 * n_t] = True
    return a, b, c, s, valid


def slide_transfer_moves(prog: BfbProgram, pad_to: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """The paired-move set for `sweep_moves`: endpoint slides for every
    pattern and loop, plus loop<->pattern transfers at the same (i,j).
    For single-cell block programs the set is replicated per clone
    block. Padded with null (0,0) moves (zero delta, never strictly
    better)."""
    T = len(prog.pairs)
    moves = []
    for t, (i, j) in enumerate(prog.pairs):
        for off in (0, T):
            v = off + t
            for ni, nj in ((i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)):
                if prog.start <= ni <= nj <= prog.end:
                    nb = off + pair_index(prog.start, prog.end, ni, nj)
                    moves.append((v, nb))
        moves.append((T + t, t))
        moves.append((t, T + t))
    base = np.asarray(moves, dtype=np.int32) if moves else np.zeros((0, 2), np.int32)
    K = prog.num_vars // (2 * T) if T else 1
    if K > 1 and len(base):
        base = np.concatenate([base + k * 2 * T for k in range(K)], axis=0)
    M = ((len(base) + pad_to - 1) // pad_to) * pad_to if len(base) else pad_to
    mv = np.zeros((M, 2), dtype=np.int32)
    if len(base):
        mv[: len(base)] = base
    return mv[:, 0], mv[:, 1]
