"""The plain reference that judges the program's answers.

It works out again, from the LH files the benchmark generated, the
copy-number fitting program that BFB reconstruction solves (Ambigram's
`BFB_ILP`, and `BFB_ILP_SC` for the clones of one sample), with NumPy
and SciPy only, and judges an answer by it:

- the answer's element counts x (patterns p_t in {0, 1}, loops l_t,
  t over the pairs i <= j of the interval) satisfy every hard row;
- the copy numbers the program reports are those of x, and the path
  it replayed walks each segment that often, by reference adjacencies
  and fold-backs only;
- the epsilon the program reports is the fit of x, in float64: the
  sum of |segment CN - observed| and |fold-back CN - observed| (and,
  for a sample, |x_a - x_b| over every pair of clones), less the bias.

It also gives the LP relaxation's bound of each case, which no integer
answer can beat; the answer's epsilon over it (`lp_ratio`) is the
benchmark's measure of answer quality.

A bulk LH file of the TRX-BFB concatenation mode (`PROP C1:<chrA>:<chrB>`)
holds two intervals joined by one translocation junction; BFB runs on
the arm they fuse into (`fuse_c1`), and a path in the original ids is
judged on that arm (`Fusion.fused_path`). Which reading a case takes is
its configuration's generator kind's (`kinds/<kind>.py`), not this
module's.

It imports nothing of the program.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Observed:
    """One clone's observed copy numbers over its single interval."""

    n: int
    seg_cn: np.ndarray  # [n]
    fbi_cn: np.ndarray  # [n]
    max_cn: float
    bias: int


def parse_lh(text: str) -> Observed:
    """Observed copy numbers of an LH file of the generator's dialect:
    one interval SOURCE 1 .. SINK n, purity and tumour ploidy given. A
    segment's CN of -1 is derived from its depth over the haploid depth;
    a fold-back junction counts at its segment once (the first record
    there wins, as in the original's `getJuncCN`), and a CN in (0.5, 1)
    counts as 1."""
    head: Dict[str, str] = {}
    segs: List[Tuple[int, float, float]] = []
    juncs: List[Tuple[int, str, int, str, float, float]] = []
    for line in text.splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "SEG":
            segs.append((int(tok[1].split(":")[1]), max(float(tok[2]), 0.0), float(tok[3])))
        elif tok[0] == "JUNC":
            a, b = tok[1].split(":"), tok[2].split(":")
            juncs.append((int(a[1]), a[2], int(b[1]), b[2], float(tok[3]), float(tok[4])))
        else:
            head[tok[0]] = " ".join(tok[1:])
    if head.get("SOURCE") != "1" or "," in head.get("SINK", ","):
        raise ValueError("the reference reads one interval SOURCE 1 .. SINK n")
    n = int(head["SINK"])
    if [s for s, _, _ in segs] != list(range(1, n + 1)):
        raise ValueError("segments are not 1..%d in order" % n)
    purity = float(head["PURITY"])
    ploidy = purity * float(head["AVG_TUMOR_PLOIDY"]) + (1.0 - purity) * 2.0
    if "AVG_PLOIDY" in head:
        raise ValueError("the reference reads LH files without AVG_PLOIDY")
    hdp = float(head["AVG_WHOLE_HOST_DP"]) * purity / ploidy
    seg_cn = np.array([cn if cn > 0 else max(depth / hdp, 0.0) for _, depth, cn in segs])
    fbi_cn = np.zeros(n)
    owner: Dict[int, Tuple[int, int]] = {}
    for s1, d1, s2, d2, depth, cn in juncs:
        if d1 == d2 or abs(s1 - s2) > 2:
            continue
        cn = cn if cn > 0 else max(depth / hdp, 0.0)
        if 0.5 < cn < 1:
            cn = 1.0
        for s in (s1, s2):
            if s not in owner:
                owner[s] = (s1, s2)
                fbi_cn[s - 1] += cn
                break
    bias = 1
    for s, (s1, s2) in owner.items():
        if fbi_cn[s - 1] > 0 and s1 != s2:
            bias += int(fbi_cn[s - 1]) % 2
    return Observed(n=n, seg_cn=seg_cn, fbi_cn=fbi_cn, max_cn=float(sum(seg_cn.tolist())), bias=bias)


class Program:
    """The fitting program of K clones over the interval 1..n (K = 1 for
    a bulk case), with the all-pairs coupling of the clones' variables.

    Variables: clone k's block holds p_t then l_t for the pairs t = (i,
    j), 1 <= i <= j <= n, in lexicographic order."""

    def __init__(self, clones: Sequence[Observed]):
        import scipy.sparse as sp

        n = clones[0].n
        if any(c.n != n for c in clones):
            raise ValueError("clones differ in their intervals")
        self.clones = list(clones)
        self.n = n
        self.pairs = [(i, j) for i in range(1, n + 1) for j in range(i, n + 1)]
        T = self.T = len(self.pairs)
        self.block = 2 * T
        self.K = len(clones)
        self.V = self.K * self.block
        index = {pair: t for t, pair in enumerate(self.pairs)}

        def p(i, j):
            return index[(i, j)]

        def l(i, j):
            return T + index[(i, j)]

        # residual rows of one clone: segment CN, then fold-back CN
        rows, cols, vals = [], [], []
        for t, (i, j) in enumerate(self.pairs):
            for s in range(i, j + 1):
                rows += [s - 1, s - 1]
                cols += [t, T + t]
                vals += [1.0, 2.0]
        for t, (i, j) in enumerate(self.pairs):
            for s in {i, j}:
                rows.append(n + s - 1)
                cols.append(T + t)
                vals.append(1.0)
            # a pattern counts half at its start (end) where another
            # pattern starts (ends) there too
            for s in {i, j}:
                if (s == i and i < n) or (s == j and j > 1):
                    rows.append(n + s - 1)
                    cols.append(t)
                    vals.append(0.5)
        res1 = sp.csr_matrix((vals, (rows, cols)), shape=(2 * n, self.block))

        # hard rows of one clone: (coefficients, lower, upper)
        hr, hc, hv, lo, hi = [], [], [], [], []

        def row(terms, lb, ub):
            r = len(lo)
            for col, v in terms:
                hr.append(r)
                hc.append(col)
                hv.append(v)
            lo.append(lb)
            hi.append(ub)

        for a, b in self.pairs:
            outer = [(j, b) for j in range(1, a)] + [(a, j) for j in range(b + 1, n + 1)]
            inner_l = [(a, j) for j in range(a, b)]
            inner_r = [(j, b) for j in range(a + 1, b + 1)]
            if outer:
                # a pattern lies inside a parent pattern
                row([(p(*q), 1) for q in outer] + [(p(a, b), -1)], 0, np.inf)
                # a loop lies inside a parent pattern or loop
                row([(p(*q), 1) for q in outer] + [(l(*q), 1) for q in outer] + [(l(a, b), -1)], 0, np.inf)
            if inner_l or inner_r:
                inner = inner_l + inner_r
                row([(p(*q), 1) for q in inner] + [(p(a, b), 1)], 0, 2)
                row([(l(*q), 1) for q in inner] + [(l(a, b), 1)], 0, 2)
                row([(l(*q), 1) for q in inner] + [(p(a, b), 1)], 0, 2)
                row([(l(*q), 1) for q in inner_l] + [(p(*q), 1) for q in inner_r] + [(p(a, b), 1)], 0, 2)
                row([(p(*q), 1) for q in inner_l] + [(l(*q), 1) for q in inner_r] + [(p(a, b), 1)], 0, 2)
        hard1 = sp.csr_matrix((hv, (hr, hc)), shape=(len(lo), self.block))

        self.residual = sp.block_diag([res1] * self.K, format="csr")
        self.target = np.concatenate([np.concatenate([c.seg_cn, c.fbi_cn]) for c in clones])
        self.hard = sp.block_diag([hard1] * self.K, format="csr")
        self.hard_lo = np.tile(np.array(lo, dtype=float), self.K)
        self.hard_hi = np.tile(np.array(hi, dtype=float), self.K)
        self.x_ub = np.concatenate(
            [np.concatenate([np.ones(T), np.full(T, c.max_cn)]) for c in clones]
        )
        pairs = [(a * self.block + v, b * self.block + v)
                 for a in range(self.K) for b in range(a + 1, self.K) for v in range(self.block)]
        self.coupling = np.array(pairs, dtype=np.int64).reshape(-1, 2)
        # bulk cases carry the fold-back bias; a sample's block program none
        self.bias = clones[0].bias if self.K == 1 else 0

    def eps(self, x: np.ndarray) -> float:
        """The epsilon sum of x, before the bias."""
        x = np.asarray(x, dtype=np.float64)
        total = float(np.abs(self.residual @ x - self.target).sum())
        if len(self.coupling):
            total += float(np.abs(x[self.coupling[:, 0]] - x[self.coupling[:, 1]]).sum())
        return total

    def eps32(self, x: np.ndarray) -> float:
        """The epsilon sum of x in float32, the precision below the
        configuration's: the control's reading."""
        x = np.asarray(x, dtype=np.float32)
        res = self.residual.astype(np.float32) @ x - self.target.astype(np.float32)
        total = np.abs(res).sum(dtype=np.float32)
        if len(self.coupling):
            total += np.abs(x[self.coupling[:, 0]] - x[self.coupling[:, 1]]).sum(dtype=np.float32)
        return float(total)

    def violation(self, x: np.ndarray) -> float:
        """Total violation of the hard rows and the variable bounds."""
        x = np.asarray(x, dtype=np.float64)
        gx = self.hard @ x
        bounds = np.maximum(x - self.x_ub, 0).sum() + np.maximum(-x, 0).sum()
        frac = np.abs(x - np.round(x)).sum()
        return float(np.maximum(gx - self.hard_hi, 0).sum() + np.maximum(self.hard_lo - gx, 0).sum() + bounds + frac)

    def seg_counts(self, x: np.ndarray) -> np.ndarray:
        """[K, n] segment copy numbers of x: a pattern counts once over
        its pairs' span, a loop twice."""
        res = self.residual @ np.asarray(x, dtype=np.float64)
        return res.reshape(self.K, 2 * self.n)[:, : self.n]

    def lp_bound(self) -> float:
        """The LP relaxation's optimum: no integer answer fits better."""
        import scipy.sparse as sp
        from scipy.optimize import linprog

        R = self.residual.shape[0]
        P = len(self.coupling)
        V = self.V
        # variables [x (V) | e (R) | d (P)]: e >= |A x - c|, d >= |x_a - x_b|
        eye_r = sp.identity(R, format="csr")
        parts = [
            sp.hstack([self.residual, -eye_r, sp.csr_matrix((R, P))]),
            sp.hstack([-self.residual, -eye_r, sp.csr_matrix((R, P))]),
        ]
        b_ub = [self.target, -self.target]
        if P:
            r = np.arange(P)
            diff = sp.csr_matrix(
                (np.concatenate([np.ones(P), -np.ones(P)]), (np.concatenate([r, r]), np.concatenate([self.coupling[:, 0], self.coupling[:, 1]]))),
                shape=(P, V),
            )
            eye_p = sp.identity(P, format="csr")
            parts += [sp.hstack([diff, sp.csr_matrix((P, R)), -eye_p]), sp.hstack([-diff, sp.csr_matrix((P, R)), -eye_p])]
            b_ub += [np.zeros(P), np.zeros(P)]
        fin_hi = np.isfinite(self.hard_hi)
        fin_lo = np.isfinite(self.hard_lo)
        zeros = sp.csr_matrix((self.hard.shape[0], R + P))
        parts += [sp.hstack([self.hard, zeros])[fin_hi], sp.hstack([-self.hard, zeros])[fin_lo]]
        b_ub += [self.hard_hi[fin_hi], -self.hard_lo[fin_lo]]
        cost = np.concatenate([np.zeros(V), np.ones(R + P)])
        bounds = np.concatenate([np.stack([np.zeros(V), self.x_ub], 1), np.tile([0.0, np.inf], (R + P, 1))])
        out = linprog(cost, A_ub=sp.vstack(parts, format="csr"), b_ub=np.concatenate(b_ub), bounds=bounds, method="highs")
        if not out.success:
            raise RuntimeError("the reference's LP failed: %s" % out.message)
        return float(out.fun)


def parse_path(path_string: str) -> List[Tuple[int, str]]:
    """`1+2+|2-1-` as [(1, '+'), (2, '+'), (2, '-'), (1, '-')]."""
    steps = []
    for tok in path_string.replace("|", " ").replace("+", "+ ").replace("-", "- ").split():
        steps.append((int(tok[:-1]), tok[-1]))
    return steps


def path_fault(steps: List[Tuple[int, str]], n: int) -> str:
    """Why the path is no BFB walk over 1..n, or "" if it is one: each
    step moves to the next segment in its direction or folds back on the
    same segment."""
    if not steps:
        return "empty path"
    for s, d in steps:
        if not 1 <= s <= n or d not in "+-":
            return "step %d%s outside 1..%d" % (s, d, n)
    for (s1, d1), (s2, d2) in zip(steps, steps[1:]):
        if d1 == d2:
            if s2 != s1 + (1 if d1 == "+" else -1):
                return "%d%s -> %d%s is no adjacency" % (s1, d1, s2, d2)
        elif s1 != s2:
            return "%d%s -> %d%s is no fold-back" % (s1, d1, s2, d2)
    return ""


def path_counts(steps: List[Tuple[int, str]], n: int) -> np.ndarray:
    counts = np.zeros(n)
    for s, _ in steps:
        counts[s - 1] += 1
    return counts


@dataclass
class Verdict:
    violation: float
    cn_mismatch: float
    path_faults: int
    eps_gap: float
    lp_ratio: float
    eps: float


def judge(prog: Program, lp: float, x: np.ndarray, reported_eps: float, reported_cn: Optional[np.ndarray],
          path_strings: Sequence[str]) -> Verdict:
    """Judge one answer: x (the program's element counts, all clones),
    the epsilon it reports (before the bias), the copy numbers it reports
    (bulk; None for a sample, which reports none) and one path per clone."""
    x = np.asarray(x, dtype=np.float64)
    if x.shape != (prog.V,):
        return Verdict(np.inf, np.inf, len(path_strings) or 1, np.inf, np.inf, np.inf)
    eps = prog.eps(x)
    counts = prog.seg_counts(x)
    mismatch = 0.0
    faults = 0 if len(path_strings) == prog.K else prog.K
    for k, ps in enumerate(path_strings[: prog.K]):
        steps = parse_path(ps)
        if path_fault(steps, prog.n):
            faults += 1
            continue
        mismatch = max(mismatch, float(np.abs(path_counts(steps, prog.n) - counts[k]).max()))
    if reported_cn is not None:
        mismatch = max(mismatch, float(np.abs(np.asarray(reported_cn, dtype=float) - counts.sum(0)).max()))
    return Verdict(
        violation=prog.violation(x),
        cn_mismatch=mismatch,
        path_faults=faults,
        eps_gap=abs(float(reported_eps) - eps),
        lp_ratio=eps / lp if lp > 0 else (1.0 if eps == 0 else np.inf),
        eps=eps,
    )


# ------------------------------------------------- TRX-BFB concatenation


def _flip(strand: str) -> str:
    return "-" if strand == "+" else "+"


@dataclass
class Fusion:
    """How the two intervals of a C1 file fuse into one arm: each
    original segment's fused id and whether its arm runs reversed there,
    and the translocation junction's two ends (original ids)."""

    fused_of: Dict[int, Tuple[int, bool]]
    arm_of: Dict[int, int]  # 0: the arm the junction leaves, 1: the one it enters
    ends: Tuple[int, int]

    def fused_path(self, path_string: str) -> Tuple[List[Tuple[int, str]], str]:
        """The steps of a path in original ids, `||` where it changes arm,
        as steps of the fused arm; with why it is no such path ("" if it
        is one). A `||` is accepted only between the translocation's two
        ends, and the path changes arm only there and only with one."""
        steps: List[Tuple[int, str]] = []
        seps: List[str] = []
        at = 0
        for m in re.finditer(r"(\|{0,2})(\d+)([+-])", path_string):
            if m.start() != at or (not steps and m.group(1)):
                return [], "unreadable at %d" % at
            at = m.end()
            seg, strand = int(m.group(2)), m.group(3)
            if seg not in self.fused_of:
                return [], "step %d%s is no segment of the two arms" % (seg, strand)
            if steps:
                seps.append(m.group(1))
            steps.append((seg, strand))
        if at != len(path_string) or not steps:
            return [], "unreadable at %d" % at
        for (s1, d1), (s2, d2), sep in zip(steps, steps[1:], seps):
            crosses = self.arm_of[s1] != self.arm_of[s2]
            if crosses != (sep == "||"):
                return [], "%d%s %s %d%s: '||' marks a change of arm and nothing else" % (s1, d1, sep, s2, d2)
            if crosses and {s1, s2} != set(self.ends):
                return [], "%d%s -> %d%s is not the translocation %d|%d" % (s1, d1, s2, d2, *self.ends)
        fused = []
        for seg, strand in steps:
            f, rev = self.fused_of[seg]
            fused.append((f, _flip(strand) if rev else strand))
        return fused, ""

    def fused_strings(self, path_strings: Sequence[str]) -> List[str]:
        """Each path as a path string of the fused arm; "" (no walk)
        where it is no path of the two arms."""
        out = []
        for ps in path_strings:
            steps, fault = self.fused_path(ps)
            out.append("" if fault else "".join("%d%s" % s for s in steps))
        return out


def c1_chromosomes(text: str) -> Optional[Tuple[str, str]]:
    """The two chromosomes of a file's `PROP C1:<chrA>:<chrB>`, or None."""
    for line in text.splitlines():
        tok = line.split()
        if tok and tok[0] == "PROP":
            for prop in tok[1:]:
                parts = prop.split(":")
                if parts[0] == "C1" and len(parts) == 3:
                    return parts[1], parts[2]
    return None


def fuse_c1(text: str) -> Tuple[str, Fusion]:
    """A C1 LH file as the single-interval LH file of its fused arm, and
    the map between them. As upstream's concatBeforeBFB reads such a
    file: the first junction between the two chromosomes (either way)
    is the translocation; the arm of its first end runs from its source
    to that end (strand "+"), or from its sink down to it ("-"); then the
    arm of its second end, from that end to its sink ("+") or down to
    its source ("-"). A reversed arm's segments change strand in the
    fused ids. The fold-back junctions go over in fused ids; the
    translocation becomes the adjacency it is there and is left out. The
    reference reads files whose fused arm holds every segment."""
    chroms = c1_chromosomes(text)
    if chroms is None:
        raise ValueError("no PROP C1:<chrA>:<chrB> line")
    head: List[str] = []
    sources: List[int] = []
    sinks: List[int] = []
    segs: Dict[int, Tuple[str, List[str]]] = {}  # id -> (chromosome, the SEG line's tokens)
    juncs: List[List[str]] = []
    for line in text.splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "SEG":
            segs[int(tok[1].split(":")[1])] = (tok[1].split(":")[2], tok)
        elif tok[0] == "JUNC":
            juncs.append(tok)
        elif tok[0] == "SOURCE":
            sources = [int(v) for v in tok[1].split(",")]
        elif tok[0] == "SINK":
            sinks = [int(v) for v in tok[1].split(",")]
        elif tok[0] != "PROP":
            head.append(line)

    def end(field: str) -> Tuple[int, str]:
        parts = field.split(":")
        return int(parts[1]), parts[2]

    trx = None
    for k, tok in enumerate(juncs):
        (s1, _), (s2, _) = end(tok[1]), end(tok[2])
        if {segs[s1][0], segs[s2][0]} == set(chroms) and chroms[0] != chroms[1]:
            trx = k
            break
    if trx is None:
        raise ValueError("no junction joins %s and %s" % chroms)
    (s_id, s_dir), (e_id, e_dir) = end(juncs[trx][1]), end(juncs[trx][2])

    def interval(seg: int) -> Tuple[int, int]:
        for lo, hi in zip(sources, sinks):
            if lo <= seg <= hi:
                return lo, hi
        raise ValueError("segment %d lies in no interval" % seg)

    (a_lo, a_hi), (b_lo, b_hi) = interval(s_id), interval(e_id)
    order: List[Tuple[int, bool]] = []
    order += [(i, False) for i in range(a_lo, s_id + 1)] if s_dir == "+" else [(i, True) for i in range(a_hi, s_id - 1, -1)]
    order += [(i, False) for i in range(e_id, b_hi + 1)] if e_dir == "+" else [(i, True) for i in range(e_id, b_lo - 1, -1)]
    if sorted(i for i, _ in order) != sorted(segs):
        raise ValueError("the fused arm leaves segments out: the reference reads arms joined end to end")
    fused_of = {seg: (f + 1, rev) for f, (seg, rev) in enumerate(order)}
    arm_of = {seg: int(not (a_lo <= seg <= a_hi)) for seg in segs}

    def fused_end(field: str) -> str:
        seg, strand = end(field)
        f, rev = fused_of[seg]
        return "H:%d:%s" % (f, _flip(strand) if rev else strand)

    lines = head + ["SOURCE 1", "SINK %d" % len(order)]
    for f, (seg, _) in enumerate(order):
        tok = segs[seg][1]
        lines.append(" ".join(["SEG", "H:%d:%s" % (f + 1, ":".join(tok[1].split(":")[2:]))] + tok[2:]))
    for k, tok in enumerate(juncs):
        if k != trx:
            lines.append(" ".join(["JUNC", fused_end(tok[1]), fused_end(tok[2])] + tok[3:]))
    return "\n".join(lines) + "\n", Fusion(fused_of, arm_of, (s_id, e_id))
