"""The BFB copy-number fitting program as dense constraint tensors.

Parity target: LocalGenomicMap::BFB_ILP
(src/LocalGenomicMap.cpp:4397-4752).

The reference builds a COIN-OR matrix with variables
[patterns | loops | 2 epsilons per segment | bias] and ships it to the
external `cbc` binary. Each epsilon appears in exactly one +/- row
pair, so its optimal value given the integer variables x is exactly
|c - a.x| — the program is really a least-absolute-deviations integer
program over x alone:

    minimize  sum_i |A_seg[i] . x - c_seg[i]| + sum_i |A_fbi[i] . x - c_fbi[i]|
              - bias
    s.t.      g_lb <= G x <= g_ub          (hard combinatorial rows)
              0 <= p_t <= 1,  0 <= l_t <= max_cn,  x integer

This module emits those tensors. The residual evaluation is a pair of
matmuls, which is what the TPU scoring kernel
(ambigram_tpu/solver/score.py) batches over thousands of candidates.

Variable order matches the reference's `variableIdx`: pattern t
(enumeration order of `enumerate_pairs`) is variable t, loop t is
variable T + t.

Copy of ambigram_tpu/engine/ilp.py. Where it differs: the builders
attach G's CSR, made from the triplets they assemble, and every host
reader of the hard rows takes it from `g_csr`; `hard_violation` is
that CSR's product in float64, so the original's float lift of the
dense G (`_g_lift`) is gone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ambigram_tpu_torch.engine.enumerate import enumerate_pairs, pair_index
from ambigram_tpu_torch.utils.profiling import GLOBAL


@dataclass
class BfbProgram:
    start: int  # first segment id of the chromosome interval
    end: int  # last segment id
    pairs: np.ndarray  # [T, 2] (i, j) pairs, enumeration order
    A_seg: np.ndarray  # [n, 2T] float64: segment-CN residual rows
    c_seg: np.ndarray  # [n]
    A_fbi: np.ndarray  # [n, 2T] float64: FBI-CN residual rows
    c_fbi: np.ndarray  # [n]
    G: np.ndarray  # [m, 2T] int8: hard constraint rows (small-integer
    #   coefficients by construction; consumers upcast — this matrix is
    #   the program's memory giant at large S). Host readers take its
    #   CSR from `g_csr`
    g_lb: np.ndarray  # [m]
    g_ub: np.ndarray  # [m]
    x_ub: np.ndarray  # [2T] variable upper bounds (p: 1, l: max_cn)
    bias: int
    # structured coupling residuals |x[a] - x[b]| with target 0 (the
    # single-cell evolution-edge terms, LGM.cpp:5033-5071). Stored as
    # [P, 2] int32 index pairs, NOT dense rows: each row has exactly two
    # nonzeros, and the all-pairs default at K clones is |edges| * 2T
    # rows — dense f64 would be gigabytes at K=4 / S=64 while the pairs
    # are kilobytes. Consumers materialize (`coupling_rows_dense`) only
    # where a dense row system is genuinely needed.
    coupling: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return self.end - self.start + 1

    @property
    def num_vars(self) -> int:
        # column count of the residual rows — for a single-graph program
        # this is 2 * len(pairs); the single-cell block program has
        # num_graphs * 2 * len(pairs) columns (engine/sc.py)
        return self.A_seg.shape[1]

    @property
    def num_coupling(self) -> int:
        return 0 if self.coupling is None else len(self.coupling)

    def coupling_rows_dense(self, dtype=np.float64) -> np.ndarray:
        """Materialize the coupling pairs as dense residual rows
        (+1 on a, -1 on b, target 0)."""
        P = self.num_coupling
        out = np.zeros((P, self.num_vars), dtype=dtype)
        if P:
            r = np.arange(P)
            out[r, self.coupling[:, 0]] = 1
            out[r, self.coupling[:, 1]] = -1
        return out

    def residual_system(self, dtype=np.float64):
        """(A_res, c_res) as one dense system in row order
        [seg | fbi | coupling] — for host solvers that need explicit
        rows (exact MILP, native B&B, LNS windows, LP/MPS writers)."""
        parts = [
            self.A_seg.astype(dtype, copy=False),
            self.A_fbi.astype(dtype, copy=False),
        ]
        c_parts = [self.c_seg, self.c_fbi]
        if self.num_coupling:
            parts.append(self.coupling_rows_dense(dtype))
            c_parts.append(np.zeros(self.num_coupling))
        return np.concatenate(parts, axis=0), np.concatenate(c_parts)

    def residual_objective(self, x: np.ndarray) -> np.ndarray:
        """Sum of absolute residuals (the epsilon sum), before -bias.
        Accepts [..., 2T] batches."""
        seg_res = np.abs(x @ self.A_seg.T - self.c_seg)
        fbi_res = np.abs(x @ self.A_fbi.T - self.c_fbi)
        total = seg_res.sum(axis=-1) + fbi_res.sum(axis=-1)
        if self.num_coupling:
            diff = x[..., self.coupling[:, 0]] - x[..., self.coupling[:, 1]]
            total = total + np.abs(diff).sum(axis=-1)
        return total

    def hard_violation(self, x: np.ndarray) -> np.ndarray:
        """Total constraint violation; 0 means feasible. Accepts
        [..., 2T] batches. G x is the sparse product in float64: exact
        for integer x, whose products with G are sums of small
        integers."""
        x = np.asarray(x, dtype=np.float64)
        G = g_csr(self)
        gx = (G @ x.reshape(-1, x.shape[-1]).T).T.reshape(x.shape[:-1] + G.shape[:1])
        return np.maximum(gx - self.g_ub, 0).sum(axis=-1) + np.maximum(
            self.g_lb - gx, 0
        ).sum(axis=-1)


def attach_g_csr(prog, G_sp):
    """Keep `G_sp`, the CSR of `prog.G`, on the program for `g_csr`."""
    object.__setattr__(prog, "_g_csr", (prog.G, G_sp))
    return prog


def g_csr(prog):
    """The program's hard rows G as a CSR of G's exact values in G's row
    order, with sorted columns and no stored zeros: what every host
    reader of G takes (the seeding LP, `hard_violation`, the LNS
    windows). The builders attach it as they assemble G; a program made
    any other way, or whose G was replaced, converts its
    dense G once here, counted as `program.g_csr_dense`, and keeps the
    result."""
    kept = getattr(prog, "_g_csr", None)
    if kept is not None and kept[0] is prog.G:
        return kept[1]
    from scipy.sparse import csr_matrix

    GLOBAL.count("program.g_csr_dense")
    G_sp = csr_matrix(prog.G)
    attach_g_csr(prog, G_sp)
    return G_sp


def _build_bfb_program_loops(
    start: int,
    end: int,
    seg_cn: np.ndarray,
    fbi_cn: np.ndarray,
    max_cn: float,
    bias: int,
    components: Optional[List[List[int]]] = None,
    juncs_info: bool = False,
) -> BfbProgram:
    """Straight-loop construction kept as the differential-testing anchor for
    the vectorized `build_bfb_program` (same tensors, same row order);
    O(n^4) time, impractical beyond ~50 segments."""
    pairs = enumerate_pairs(start, end)
    T = len(pairs)
    n = end - start + 1
    V = 2 * T
    i_arr = pairs[:, 0]
    j_arr = pairs[:, 1]
    span = np.abs(i_arr - j_arr)

    def pidx(a: int, b: int) -> int:
        return pair_index(start, end, a, b)

    def lidx(a: int, b: int) -> int:
        return T + pair_index(start, end, a, b)

    # ---- segment-CN rows: sum p + 2 sum l over pairs covering segment s
    #      (LGM.cpp:4423-4451)
    seg_ids = np.arange(start, end + 1)
    covers = (i_arr[None, :] <= seg_ids[:, None]) & (seg_ids[:, None] <= j_arr[None, :])
    A_seg = np.zeros((n, V), dtype=np.float64)
    A_seg[:, :T] = covers.astype(np.float64)
    A_seg[:, T:] = 2.0 * covers.astype(np.float64)
    c_seg = np.asarray(seg_cn, dtype=np.float64).copy()

    # ---- FBI-CN rows (LGM.cpp:4453-4494):
    # loops with endpoint s contribute 1 (+= semantics);
    # patterns participating in any nested same-endpoint pair get 0.5.
    A_fbi = np.zeros((n, V), dtype=np.float64)
    endpoint = (i_arr[None, :] == seg_ids[:, None]) | (j_arr[None, :] == seg_ids[:, None])
    A_fbi[:, T:] = endpoint.astype(np.float64)
    # pattern pairs: for segment s, pattern t gets coefficient 0.5 if
    # there exists another pattern u with the same start (== s) or the
    # same end (== s) and a strictly different span (either parent or
    # child in such a pair gets marked).
    for s_idx, s in enumerate(seg_ids):
        share_start = np.where(i_arr == s)[0]
        share_end = np.where(j_arr == s)[0]
        for grp in (share_start, share_end):
            if len(grp) < 2:
                continue
            spans = span[grp]
            # pattern j in a (parent, child) ordered pair with |span_j| > |span_k|
            marked = np.zeros(len(grp), dtype=bool)
            for a in range(len(grp)):
                for b in range(len(grp)):
                    if spans[a] > spans[b]:
                        marked[a] = True
                        marked[b] = True
            A_fbi[s_idx, grp[marked]] = 0.5
    c_fbi = np.asarray(fbi_cn, dtype=np.float64).copy()

    # ---- hard constraint rows
    G_rows: List[np.ndarray] = []
    g_lb: List[float] = []
    g_ub: List[float] = []
    INF = np.inf

    def add_row(row: np.ndarray, lb: float, ub: float) -> None:
        G_rows.append(row)
        g_lb.append(lb)
        g_ub.append(ub)

    # pattern hierarchy (LGM.cpp:4543-4583):
    # sum(parent patterns) - p >= 0 ; p + sum(child patterns) <= 2
    for t in range(T):
        a, b = int(i_arr[t]), int(j_arr[t])
        row8 = np.zeros(V)
        row9 = np.zeros(V)
        flag1 = flag2 = False
        for j in range(start, a):
            flag1 = True
            row8[pidx(j, b)] += 1
        for j in range(b + 1, end + 1):
            flag1 = True
            row8[pidx(a, j)] += 1
        for j in range(a, b):
            flag2 = True
            row9[pidx(a, j)] += 1
        for j in range(a + 1, b + 1):
            flag2 = True
            row9[pidx(j, b)] += 1
        if flag1:
            row8[pidx(a, b)] -= 1
            add_row(row8, 0, INF)
        if flag2:
            row9[pidx(a, b)] += 1
            add_row(row9, 0, 2)

    # loop parent (LGM.cpp:4585-4612): sum(p_parent) + sum(l_parent) - l >= 0
    for t in range(T):
        a, b = int(i_arr[t]), int(j_arr[t])
        row = np.zeros(V)
        flag = False
        for j in range(start, a):
            flag = True
            row[pidx(j, b)] += 1
            row[lidx(j, b)] += 1
        for j in range(b + 1, end + 1):
            flag = True
            row[pidx(a, j)] += 1
            row[lidx(a, j)] += 1
        if flag:
            row[lidx(a, b)] -= 1
            add_row(row, 0, INF)

    # loop children (LGM.cpp:4614-4646):
    # l + sum(child loops) <= 2 ; p + sum(child loops) <= 2
    for t in range(T):
        a, b = int(i_arr[t]), int(j_arr[t])
        row10 = np.zeros(V)
        flag = False
        for j in range(a, b):
            flag = True
            row10[lidx(a, j)] += 1
        for j in range(a + 1, b + 1):
            flag = True
            row10[lidx(j, b)] += 1
        if flag:
            row11 = row10.copy()
            row10[lidx(a, b)] += 1
            add_row(row10, 0, 2)
            row11[pidx(a, b)] += 1
            add_row(row11, 0, 2)

    # pattern-loop nesting (LGM.cpp:4648-4681):
    # p + sum l(a, j<b) + sum p(j>a, b) <= 2 ; p + sum p(a, j<b) + sum l(j>a, b) <= 2
    for t in range(T):
        a, b = int(i_arr[t]), int(j_arr[t])
        row10 = np.zeros(V)
        row11 = np.zeros(V)
        flag = False
        for j in range(a, b):
            flag = True
            row10[lidx(a, j)] += 1
            row11[pidx(a, j)] += 1
        for j in range(a + 1, b + 1):
            flag = True
            row10[pidx(j, b)] += 1
            row11[lidx(j, b)] += 1
        if flag:
            row10[pidx(a, b)] += 1
            add_row(row10, 0, 2)
            row11[pidx(a, b)] += 1
            add_row(row11, 0, 2)

    # third-generation evidence (LGM.cpp:4684-4703): one row,
    # sum over unique component spans of (l + p) <= 5
    if components and juncs_info:
        row = np.zeros(V)
        seen = set()
        nonempty = False
        for comp in components:
            s = min(comp[0], comp[-1])
            e = max(comp[0], comp[-1])
            if s == start and e == end:
                continue
            key = (s, e)
            if key in seen:
                continue
            seen.add(key)
            row[lidx(s, e)] += 1
            row[pidx(s, e)] += 1
            nonempty = True
        # the reference appends this row even when every component was
        # skipped (LGM.cpp:4699-4702)
        del nonempty
        add_row(row, 0, 5)

    if G_rows:
        G64 = np.array(G_rows, dtype=np.float64)
        G = G64.astype(np.int8)
        assert np.array_equal(G, G64), "hard-row coefficient outside int8"
    else:
        G = np.zeros((0, V), dtype=np.int8)
    x_ub = np.concatenate(
        [np.ones(T, dtype=np.float64), np.full(T, float(max_cn), dtype=np.float64)]
    )
    from scipy.sparse import csr_matrix

    prog = BfbProgram(
        start=start,
        end=end,
        pairs=pairs,
        A_seg=A_seg,
        c_seg=c_seg,
        A_fbi=A_fbi,
        c_fbi=c_fbi,
        G=G,
        g_lb=np.array(g_lb, dtype=np.float64),
        g_ub=np.array(g_ub, dtype=np.float64),
        x_ub=x_ub,
        bias=bias,
    )
    return attach_g_csr(prog, csr_matrix(G))


def _ragged(reps: np.ndarray) -> tuple:
    """(owner, offset) for concatenated ranges of lengths reps[t]:
    owner[k] = t of entry k, offset[k] = position within its range."""
    total = int(reps.sum())
    owner = np.repeat(np.arange(len(reps)), reps)
    starts = np.cumsum(reps) - reps
    offset = np.arange(total) - np.repeat(starts, reps)
    return owner, offset


def _g_from_triplets(rows, cols, vals, shape):
    """G as dense int8 and as its CSR (`g_csr`) from COO triplets, the
    duplicates summed and a sum of 0 left out, as the dense G leaves it
    out."""
    from scipy.sparse import coo_matrix

    # not an assert: this guard protects the int8 narrowing below
    # and must survive `python -O`
    if not np.array_equal(vals, np.round(vals)):
        raise ValueError("fractional hard-row coefficient")
    G_sp = coo_matrix((vals.astype(np.int16), (rows, cols)), shape=shape).tocsr()
    G_sp.sum_duplicates()
    G_sp.eliminate_zeros()
    G16 = G_sp.toarray()
    G = G16.astype(np.int8)
    if not np.array_equal(G, G16):
        raise ValueError("hard-row coefficient outside int8")
    return G, G_sp.astype(np.int8)


def build_bfb_program(
    start: int,
    end: int,
    seg_cn: np.ndarray,
    fbi_cn: np.ndarray,
    max_cn: float,
    bias: int,
    components: Optional[List[List[int]]] = None,
    juncs_info: bool = False,
) -> BfbProgram:
    """Build the fitting program for segment interval [start, end].

    seg_cn[k] is the CN of segment (start + k); fbi_cn likewise (the
    juncCN[i][1] column). max_cn is the loop upper bound — the
    reference uses the CN sum over *all* graph segments, not just this
    interval (LGM.cpp:4708-4711).

    Fully vectorized (COO assembly, no per-row Python loops): tensors
    and row order are bit-identical to `_build_bfb_program_loops`,
    verified differentially in tests; ~1000x faster at n = 96.
    """
    from scipy.sparse import csr_matrix

    pairs = enumerate_pairs(start, end)
    T = len(pairs)
    n = end - start + 1
    V = 2 * T
    a = pairs[:, 0].astype(np.int64)
    b = pairs[:, 1].astype(np.int64)
    seg_ids = np.arange(start, end + 1)

    def pidx(i, j):
        ai = i - start
        return ai * n - ai * (ai - 1) // 2 + (j - i)

    # ---- segment-CN rows (LGM.cpp:4423-4451)
    covers = (a[None, :] <= seg_ids[:, None]) & (seg_ids[:, None] <= b[None, :])
    A_seg = np.zeros((n, V), dtype=np.float64)
    A_seg[:, :T] = covers
    A_seg[:, T:] = 2.0 * covers
    c_seg = np.asarray(seg_cn, dtype=np.float64).copy()

    # ---- FBI-CN rows (LGM.cpp:4453-4494). Loop part: endpoint match.
    # Pattern part: within the group of patterns sharing a start (or an
    # end) the spans are all distinct, so every member of a group of
    # size >= 2 is marked with coefficient 0.5.
    A_fbi = np.zeros((n, V), dtype=np.float64)
    endpoint = (a[None, :] == seg_ids[:, None]) | (b[None, :] == seg_ids[:, None])
    A_fbi[:, T:] = endpoint
    for s_idx, s in enumerate(seg_ids):
        if s < end:  # patterns (s, j), j in [s, end] — contiguous block
            base = pidx(s, s)
            A_fbi[s_idx, base : base + (end - s) + 1] = 0.5
        if s > start:  # patterns (i, s), i in [start, s]
            A_fbi[s_idx, pidx(np.arange(start, s + 1), s)] = 0.5
    c_fbi = np.asarray(fbi_cn, dtype=np.float64).copy()

    # ---- hard rows, assembled in the reference's emission order.
    # Parent set P1 of (a, b): (j, b) j<a and (a, j) j>b.
    # Child sets C1: (a, j) a<=j<b ; C2: (j, b) a<j<=b.
    cnt_l = a - start  # |{j < a}|
    cnt_r = end - b  # |{j > b}|
    flag1 = (cnt_l + cnt_r) > 0
    span_f = b > a  # flag2 and the loop-children / nesting flag
    diag_p = pidx(a, b)
    diag_l = T + diag_p

    oL, kL = _ragged(cnt_l)  # (j, b[t]) with j = start + kL
    colL = pidx(start + kL, b[oL])
    oR, kR = _ragged(cnt_r)  # (a[t], j) with j = b[t] + 1 + kR
    colR = pidx(a[oR], b[oR] + 1 + kR)
    cnt_c = b - a
    oC1, kC1 = _ragged(cnt_c)  # (a, a + kC1), kC1 < b - a
    colC1 = pidx(a[oC1], a[oC1] + kC1)
    oC2, kC2 = _ragged(cnt_c)  # (a + 1 + kC2, b)
    colC2 = pidx(a[oC2] + 1 + kC2, b[oC2])

    rows_list: List[np.ndarray] = []
    cols_list: List[np.ndarray] = []
    vals_list: List[np.ndarray] = []
    lb_parts: List[np.ndarray] = []
    ub_parts: List[np.ndarray] = []
    INF = np.inf

    # Block A: per t, row8 (if flag1) then row9 (if span_f), interleaved
    interleaved = np.stack([flag1, span_f], axis=1).reshape(-1)
    posA = np.cumsum(interleaved) - 1
    row8_id = np.where(flag1, posA[0::2], -1)
    row9_id = np.where(span_f, posA[1::2], -1)
    nA = int(interleaved.sum())
    # row8: +1 on parent patterns, -1 on own pattern, [0, inf)
    for owner, col in ((oL, colL), (oR, colR)):
        keep = row8_id[owner] >= 0
        rows_list.append(row8_id[owner][keep])
        cols_list.append(col[keep])
        vals_list.append(np.ones(int(keep.sum())))
    keep = flag1
    rows_list.append(row8_id[keep])
    cols_list.append(diag_p[keep])
    vals_list.append(np.full(int(keep.sum()), -1.0))
    # row9: +1 on child patterns and own pattern, [0, 2]
    for owner, col in ((oC1, colC1), (oC2, colC2)):
        keep = row9_id[owner] >= 0
        rows_list.append(row9_id[owner][keep])
        cols_list.append(col[keep])
        vals_list.append(np.ones(int(keep.sum())))
    keep = span_f
    rows_list.append(row9_id[keep])
    cols_list.append(diag_p[keep])
    vals_list.append(np.ones(int(keep.sum())))
    # bounds for block A in interleaved order
    # even interleave slots are row8 ([0, inf)), odd are row9 ([0, 2])
    is_row8_slot = np.tile(np.array([True, False]), T)[interleaved]
    lb_parts.append(np.zeros(nA))
    ub_parts.append(np.where(is_row8_slot, INF, 2.0))

    # Block B (loop parent, LGM.cpp:4585-4612): +p and +l on parents,
    # -1 on own loop, [0, inf)
    rowB_id = np.where(flag1, np.cumsum(flag1) - 1 + nA, -1)
    nB = int(flag1.sum())
    for owner, col in ((oL, colL), (oR, colR)):
        keep = rowB_id[owner] >= 0
        r = rowB_id[owner][keep]
        rows_list += [r, r]
        cols_list += [col[keep], T + col[keep]]
        vals_list += [np.ones(len(r)), np.ones(len(r))]
    rows_list.append(rowB_id[flag1])
    cols_list.append(diag_l[flag1])
    vals_list.append(np.full(nB, -1.0))
    lb_parts.append(np.zeros(nB))
    ub_parts.append(np.full(nB, INF))

    # Block C (loop children, LGM.cpp:4614-4646): per t two rows
    # row10 = l(C1)+l(C2)+l(a,b), row11 = l(C1)+l(C2)+p(a,b), both [0,2]
    nC_each = int(span_f.sum())
    baseC = nA + nB
    rowC = np.cumsum(span_f) - 1
    row10C = np.where(span_f, baseC + 2 * rowC, -1)
    row11C = np.where(span_f, baseC + 2 * rowC + 1, -1)
    for rids, diag_col in ((row10C, diag_l), (row11C, diag_p)):
        for owner, col in ((oC1, colC1), (oC2, colC2)):
            keep = rids[owner] >= 0
            rows_list.append(rids[owner][keep])
            cols_list.append(T + col[keep])
            vals_list.append(np.ones(int(keep.sum())))
        rows_list.append(rids[span_f])
        cols_list.append(diag_col[span_f])
        vals_list.append(np.ones(nC_each))
    lb_parts.append(np.zeros(2 * nC_each))
    ub_parts.append(np.full(2 * nC_each, 2.0))

    # Block D (pattern-loop nesting, LGM.cpp:4648-4681): per t two rows
    # row10 = l(C1)+p(C2)+p(a,b), row11 = p(C1)+l(C2)+p(a,b), both [0,2]
    baseD = baseC + 2 * nC_each
    row10D = np.where(span_f, baseD + 2 * rowC, -1)
    row11D = np.where(span_f, baseD + 2 * rowC + 1, -1)
    for rids, c1_shift, c2_shift in ((row10D, T, 0), (row11D, 0, T)):
        for owner, col, shift in ((oC1, colC1, c1_shift), (oC2, colC2, c2_shift)):
            keep = rids[owner] >= 0
            rows_list.append(rids[owner][keep])
            cols_list.append(shift + col[keep])
            vals_list.append(np.ones(int(keep.sum())))
        rows_list.append(rids[span_f])
        cols_list.append(diag_p[span_f])
        vals_list.append(np.ones(nC_each))
    lb_parts.append(np.zeros(2 * nC_each))
    ub_parts.append(np.full(2 * nC_each, 2.0))

    M = baseD + 2 * nC_each

    # Block E: third-generation evidence row (LGM.cpp:4684-4703)
    if components and juncs_info:
        ecols = []
        seen = set()
        for comp in components:
            s = min(comp[0], comp[-1])
            e = max(comp[0], comp[-1])
            if (s == start and e == end) or (s, e) in seen:
                continue
            seen.add((s, e))
            p = int(pidx(s, e))
            ecols += [p, T + p]
        rows_list.append(np.full(len(ecols), M))
        cols_list.append(np.array(ecols, dtype=np.int64))
        vals_list.append(np.ones(len(ecols)))
        lb_parts.append(np.zeros(1))
        ub_parts.append(np.full(1, 5.0))
        M += 1

    if M:
        rows_c = np.concatenate(rows_list) if rows_list else np.zeros(0, dtype=np.int64)
        cols_c = np.concatenate(cols_list) if cols_list else np.zeros(0, dtype=np.int64)
        vals_c = np.concatenate(vals_list) if vals_list else np.zeros(0)
        # dense G in int8: every hard-row coefficient is a small integer
        # by construction, and G is the memory giant of the program —
        # O(S^2) rows x O(S^2) cols (S=96: 23k x 9312 = 1.7 GB as f64,
        # 213 MB as int8; S=128 would not fit as f64). Host products
        # read its CSR (`g_csr`), PENALTY * G promotes to f64, and
        # scoring_tensors' int8 path takes it as-is. Assembled via int16
        # so COO duplicate-summing cannot wrap before the final check;
        # the integrality check runs against the FLOAT values first (an
        # astype would silently truncate a fractional coefficient before
        # the int8 range check could see it — the straight-loop anchor
        # at line ~261 checks against f64 and this path must be as safe).
        G, G_sp = _g_from_triplets(rows_c, cols_c, vals_c, (M, V))
        g_lb = np.concatenate(lb_parts)
        g_ub = np.concatenate(ub_parts)
    else:
        G = np.zeros((0, V), dtype=np.int8)
        G_sp = csr_matrix((0, V), dtype=np.int8)
        g_lb = np.zeros(0)
        g_ub = np.zeros(0)

    x_ub = np.concatenate(
        [np.ones(T, dtype=np.float64), np.full(T, float(max_cn), dtype=np.float64)]
    )
    prog = BfbProgram(
        start=start,
        end=end,
        pairs=pairs,
        A_seg=A_seg,
        c_seg=c_seg,
        A_fbi=A_fbi,
        c_fbi=c_fbi,
        G=G,
        g_lb=g_lb,
        g_ub=g_ub,
        x_ub=x_ub,
        bias=bias,
    )
    return attach_g_csr(prog, G_sp)
