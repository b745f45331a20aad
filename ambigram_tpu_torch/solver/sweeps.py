"""The search's three incremental sweeps, in plain PyTorch.

Port of `_score_from_hx`, `_sweep_delta`, `_sweep_moves` and
`_sweep_moves3` (ambigram_tpu/solver/search.py), which are XLA loops in
the JAX package, not Pallas kernels. Each sweep scores every move of its
neighborhood for every population member from the threaded row values
hx = X @ H.T and one column delta per move, then applies each member's
best move if it strictly improves. The semantics are the JAX ones, to
the bit:

- moves are scored in chunks of `chunk` (128); within a chunk the argmin
  takes the first minimum (for `sweep_delta` over [+chunk | -chunk]);
  across chunks a chunk replaces the running best only on a strict
  improvement;
- a move that would leave the box [0, x_ub] scores as the current score,
  so it never wins;
- a member applies its move only when best < score - 1e-6.

Column deltas are gathered from H.T (`ScoringTensors.columns()`), so a
chunk's temporary is [B, chunk, Rows] with the row sum over the
contiguous last axis; the sums are exact (see score.py), so the layout
does not change a bit. Each chunk's temporaries are freed before the
next chunk: at S=48 one is 32 x 128 x 8192 f32 = 134 MB.

Every sweep also takes a leading case axis G: `st` a case-stacked set
(`parallel.mesh.stack_cases`), X [G, B, Vp], hx [G, B, Rows], scores
[G, B], and then returns `improved_any` per case ([G]). That is the
`jax.vmap` of the batch search (ambigram_tpu/solver/search.py
`_batch_search`); the move catalogues are shared by the group, and each
case keeps the first-minimum argmin and the strict-improvement rule. A
chunk's temporary grows to [G, B, chunk, Rows]: at S=48 and G=8 that is
8 x 32 x 128 x 8192 f32 = 1.07 GB, which fits on an 80 GB card.

These plain sweeps serve CPU tensors, the tests and the comparisons on
the card. On a card the search runs the hand-written kernel
csrc/sweeps.cu instead (`SweepOps`, `sweep_kernel`): it reads the
sparse columns of H (`sparse_columns`), visits for each move only the
rows its columns touch, keeps no temporary, and its launches read their
tier gates from state words on the device (`new_state`), so the host
can queue a block of descent iterations and read one flag per block.
It applies a move when best < base - 1e-6, base being the member's dense
hinge sum that the move's score was formed from, where JAX compares
with the score: the same number on integer targets, and on noisy ones
a move that changes no hinge never passes. `move_scores_sparse_plain`
mirrors its formulation on the CPU for the checks.
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.nn.functional as F

from ambigram_tpu_torch.solver.score import _COUNT_LOCK, ScoringTensors


def _operands(st: ScoringTensors, X, hx, scores):
    """The sweep's operands with a leading case axis: a single case
    (X [B, Vp]) becomes a group of one. Returns (single, HT, lb, ub,
    x_ub, X, hx, scores)."""
    HT, lb, ub, x_ub = st.columns(), st.lb, st.ub, st.x_ub
    if X.dim() == 2:
        return True, HT[None], lb[None], ub[None], x_ub[None], X[None], hx[None], scores[None]
    return False, HT, lb, ub, x_ub, X, hx, scores


def _result(single: bool, X, hx, scores, improved):
    """(X', hx', scores', improved_any): per case ([G]), or a 0-d bool
    tensor for a single case."""
    improved_any = improved.any(dim=-1)
    if single:
        return X[0], hx[0], scores[0], improved_any[0]
    return X, hx, scores, improved_any


def _hinge_sum(lb, ub, hx: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """sum_r max(v - ub, 0) + max(lb - v, 0) with v = hx[:, :, None, :]
    + D[:, None, :, :], for hx [G, B, Rows] and column deltas
    D [G, chunk, Rows] -> [G, B, chunk]."""
    v = hx[:, :, None, :] + D[:, None, :, :]
    under = lb[:, None, None, :] - v
    v.sub_(ub[:, None, None, :]).clamp_(min=0.0)
    under.clamp_(min=0.0)
    v.add_(under)
    del under
    return v.sum(dim=-1)


def _first_min(s: torch.Tensor):
    """(value, index) of the first minimum along the last axis."""
    idx = torch.argmin(s, dim=-1)
    return s.gather(-1, idx[..., None])[..., 0], idx


def sweep_delta(
    st: ScoringTensors,
    X: torch.Tensor,
    hx: torch.Tensor,
    scores: torch.Tensor,
    chunk: int = 128,
):
    """Best single-variable +-1 move per member. Returns
    (X', hx', scores', improved_any) with improved_any a 0-d bool
    tensor ([G] with a case axis)."""
    single, HT, lb, ub, x_ub, X, hx, scores = _operands(st, X, hx, scores)
    G, B, Vp = X.shape
    best_score = scores
    best_var = torch.zeros((G, B), dtype=torch.int64, device=X.device)
    best_sign = torch.zeros((G, B), dtype=X.dtype, device=X.device)
    for c0 in range(0, (Vp // chunk) * chunk, chunk):
        Hc = HT[:, c0 : c0 + chunk]  # [G, chunk, Rows]
        s_plus = _hinge_sum(lb, ub, hx, Hc)
        s_minus = _hinge_sum(lb, ub, hx, -Hc)
        # moves that clip back to X score exactly the current score
        xv = X[..., c0 : c0 + chunk]
        ub_v = x_ub[:, None, c0 : c0 + chunk]
        s_plus = torch.where(xv + 1.0 > ub_v, scores[..., None], s_plus)
        s_minus = torch.where(xv - 1.0 < 0.0, scores[..., None], s_minus)
        val, idx = _first_min(torch.cat([s_plus, s_minus], dim=-1))
        var = c0 + idx % chunk
        sign = torch.where(idx < chunk, 1.0, -1.0)
        better = val < best_score
        best_score = torch.where(better, val, best_score)
        best_var = torch.where(better, var, best_var)
        best_sign = torch.where(better, sign, best_sign)
    improved = best_score < scores - 1e-6
    delta = F.one_hot(best_var, Vp).to(X.dtype) * best_sign[..., None]
    X_new = torch.minimum(torch.clamp(X + delta, min=0.0), x_ub[:, None, :])
    X_out = torch.where(improved[..., None], X_new, X)
    gi = torch.arange(G, device=X.device)[:, None]
    col = HT[gi, best_var]  # [G, B, Rows] = H[:, best_var].T per case
    hx_out = torch.where(improved[..., None], hx + best_sign[..., None] * col, hx)
    s_out = torch.where(improved, best_score, scores)
    return _result(single, X_out, hx_out, s_out, improved)


def sweep_moves(
    st: ScoringTensors,
    X: torch.Tensor,
    hx: torch.Tensor,
    scores: torch.Tensor,
    mv_minus: torch.Tensor,
    mv_plus: torch.Tensor,
    chunk: int = 128,
):
    """Paired-move sweep: move m transfers one unit from variable
    mv_minus[m] to mv_plus[m] (endpoint slides, loop<->pattern
    transfers), scored via the column delta H[:, plus] - H[:, minus]."""
    single, HT, lb, ub, x_ub, X, hx, scores = _operands(st, X, hx, scores)
    G, B, Vp = X.shape
    M = mv_minus.shape[0]
    best_score = scores
    best_move = torch.zeros((G, B), dtype=torch.int64, device=X.device)
    for c0 in range(0, (M // chunk) * chunk, chunk):
        mm = mv_minus[c0 : c0 + chunk]
        mp = mv_plus[c0 : c0 + chunk]
        s = _hinge_sum(lb, ub, hx, HT[:, mp] - HT[:, mm])
        valid = (X[..., mm] >= 1.0) & (X[..., mp] + 1.0 <= x_ub[:, mp][:, None, :])
        s = torch.where(valid, s, scores[..., None])
        val, idx = _first_min(s)
        better = val < best_score
        best_score = torch.where(better, val, best_score)
        best_move = torch.where(better, c0 + idx, best_move)
    improved = best_score < scores - 1e-6
    bm_minus = mv_minus[best_move]
    bm_plus = mv_plus[best_move]
    delta = F.one_hot(bm_plus, Vp).to(X.dtype) - F.one_hot(bm_minus, Vp).to(X.dtype)
    X_out = torch.where(improved[..., None], X + delta, X)
    gi = torch.arange(G, device=X.device)[:, None]
    col = HT[gi, bm_plus] - HT[gi, bm_minus]
    hx_out = torch.where(improved[..., None], hx + col, hx)
    s_out = torch.where(improved, best_score, scores)
    return _result(single, X_out, hx_out, s_out, improved)


def sweep_moves3(
    st: ScoringTensors,
    X: torch.Tensor,
    hx: torch.Tensor,
    scores: torch.Tensor,
    mv_a: torch.Tensor,
    mv_b: torch.Tensor,
    mv_c: torch.Tensor,
    mv_s: torch.Tensor,
    mv_valid: torch.Tensor,
    chunk: int = 128,
):
    """Triple-move sweep: move m applies x[a] -= s, x[b] += s, x[c] += s
    with s in {+1, -1} (loop/pattern split and merge), scored via the
    column delta s * (H[:, b] + H[:, c] - H[:, a]). `mv_valid` masks
    padding entries."""
    single, HT, lb, ub, x_ub, X, hx, scores = _operands(st, X, hx, scores)
    G, B, Vp = X.shape
    M = mv_a.shape[0]
    best_score = scores
    best_move = torch.zeros((G, B), dtype=torch.int64, device=X.device)
    for c0 in range(0, (M // chunk) * chunk, chunk):
        a = mv_a[c0 : c0 + chunk]
        b = mv_b[c0 : c0 + chunk]
        c = mv_c[c0 : c0 + chunk]
        s_sign = mv_s[c0 : c0 + chunk]
        Dc = (HT[:, b] + HT[:, c] - HT[:, a]) * s_sign[:, None]
        s = _hinge_sum(lb, ub, hx, Dc)
        del Dc
        pos = s_sign > 0
        # a split needs x[a] >= 1 and headroom in both halves; b may
        # equal c, and then the move needs 2 units of headroom
        need_bc = torch.where(b == c, 2.0, 1.0)
        ok_split = (
            (X[..., a] >= 1.0)
            & (X[..., b] + need_bc <= x_ub[:, b][:, None, :])
            & (X[..., c] + 1.0 <= x_ub[:, c][:, None, :])
        )
        ok_merge = (
            (X[..., b] >= need_bc)
            & (X[..., c] >= 1.0)
            & (X[..., a] + 1.0 <= x_ub[:, a][:, None, :])
        )
        valid = torch.where(pos, ok_split, ok_merge) & mv_valid[c0 : c0 + chunk]
        s = torch.where(valid, s, scores[..., None])
        val, idx = _first_min(s)
        better = val < best_score
        best_score = torch.where(better, val, best_score)
        best_move = torch.where(better, c0 + idx, best_move)
    improved = best_score < scores - 1e-6
    ba = mv_a[best_move]
    bb = mv_b[best_move]
    bc = mv_c[best_move]
    bs = mv_s[best_move]
    delta = (
        F.one_hot(bb, Vp).to(X.dtype)
        + F.one_hot(bc, Vp).to(X.dtype)
        - F.one_hot(ba, Vp).to(X.dtype)
    ) * bs[..., None]
    X_out = torch.where(improved[..., None], X + delta, X)
    gi = torch.arange(G, device=X.device)[:, None]
    col = (HT[gi, bb] + HT[gi, bc] - HT[gi, ba]) * bs[..., None]
    hx_out = torch.where(improved[..., None], hx + col, hx)
    s_out = torch.where(improved, best_score, scores)
    return _result(single, X_out, hx_out, s_out, improved)


# ------------------------------------------- the sweep kernel (csrc/sweeps.cu)

KINDS = ("delta", "moves", "moves3")  # the kernel's sweep kinds 0, 1, 2
PLAIN_SWEEPS = {"delta": sweep_delta, "moves": sweep_moves, "moves3": sweep_moves3}  # by kind

# The descent's state words on the device, mirrored by csrc/sweeps.cu: JAX's
# while_loop carry (improved, it, the paired and triple sweep counts; the
# delta sweeps are `it`), the current iteration's per-tier flags (any case
# improved at tier 1, every case did, any at tier 2, any at tier 3) and the
# sweep budget.
S_IMPROVED, S_IT, S_N_MV, S_N_M3, S_ANY1, S_ALL1, S_ANY2, S_ANY3, S_MAX_SWEEPS = range(9)
STATE_WORDS = 16


def new_state(max_sweeps: int, device) -> torch.Tensor:
    """The state words of a fresh descent on `device` (int32): improved,
    no sweep taken yet, budget `max_sweeps`. Filled on the device, so it
    makes no host sync."""
    state = torch.zeros(STATE_WORDS, dtype=torch.int32, device=device)
    state[S_IMPROVED] = 1
    state[S_MAX_SWEEPS] = int(max_sweeps)
    return state


def sweep_gate(words: List[int], kind: int) -> bool:
    """The tier gate of a sweep of `kind` on the state words (the kernel's
    `sweep_gate`): JAX's lax.cond predicates. Every tier needs the loop
    active (improved and it < max_sweeps); tier 2 runs unless every case
    improved at tier 1, tier 3 only when no case improved at tiers 1 and
    2. For one case both are the single-case rules."""
    if not (words[S_IMPROVED] and words[S_IT] < words[S_MAX_SWEEPS]):
        return False
    if kind == 0:
        return True
    if kind == 1:
        return not words[S_ALL1]
    return not (words[S_ANY1] or words[S_ANY2])


def settle_state(words: List[int], kind: int, case_improved: List[bool], last: bool) -> None:
    """The kernel's `sweep_state_kernel` on host words, in place: fold the
    per-case improved flags of a sweep of `kind` into the tier's flags and
    count the sweep; after the `last` tier of an iteration, set improved
    and advance it. Nothing changes once the loop is inactive."""
    if not (words[S_IMPROVED] and words[S_IT] < words[S_MAX_SWEEPS]):
        return
    if sweep_gate(words, kind):
        any_, all_ = int(any(case_improved)), int(all(case_improved))
        if kind == 0:
            words[S_ANY1], words[S_ALL1] = any_, all_
        elif kind == 1:
            words[S_ANY2] = any_
            words[S_N_MV] += 1
        else:
            words[S_ANY3] = any_
            words[S_N_M3] += 1
    if last:
        words[S_IMPROVED] = int(bool(words[S_ANY1] or words[S_ANY2] or words[S_ANY3]))
        words[S_IT] += 1
        words[S_ANY1] = words[S_ALL1] = words[S_ANY2] = words[S_ANY3] = 0


_SWEEPS_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
    + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
)


def _library() -> ctypes.CDLL:
    from ambigram_tpu_torch import kernels

    lib = kernels.load("sweeps")
    if lib.sweeps_launch.argtypes is None:
        lib.sweeps_launch.argtypes = _SWEEPS_ARGTYPES
        lib.sweeps_launch.restype = ctypes.c_int
        lib.sweeps_base_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.sweeps_base_launch.restype = ctypes.c_int
        lib.sweeps_state_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        lib.sweeps_state_launch.restype = ctypes.c_int
        lib.sweeps_error_string.argtypes = [ctypes.c_int]
        lib.sweeps_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError("%s failed: %s (cudaError %d)" % (what, lib.sweeps_error_string(err).decode(), err))


# ------------------------------------------------- the sparse columns of H

END = 2**31 - 1  # the row of a column's sentinel entry (the kernel's kEnd)


@dataclass
class SparseColumns:
    """The columns of H of one program or case-stacked group, in the
    layout of the sweep kernel: column v of case g is the entries
    ent[g, ptr[g, v] : ptr[g, v + 1] - 1], (row, value bits) pairs sorted
    by row, then one sentinel entry (row END, value 0). The values are
    the f32 entries of `st.H`. `bnd` holds the (lb, ub) pair of every
    row. A case-stacked group pads every case to the largest case's
    entries, and a padding column is empty. `catalogues` caches the move
    catalogues' device copies (`_catalogue`)."""

    ptr: torch.Tensor  # int32 [G, Vp + 1]
    ent: torch.Tensor  # int32 [G, E, 2]
    bnd: torch.Tensor  # float32 [G, Rows, 2]
    max_count: int  # the most entries in one column
    nnz: int  # entries in all columns, sentinels not counted
    catalogues: dict = field(default_factory=dict, repr=False)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.ptr, self.ent, self.bnd))

    def dense(self):
        """(H.T [G, Vp, Rows] f32, its support [G, Vp, Rows] bool) rebuilt
        from the entries, for checks and the plain mirror."""
        G, Vp1 = self.ptr.shape
        rows = self.bnd.shape[1]
        idx = torch.arange(self.ent.shape[1], device=self.ent.device)
        col = torch.searchsorted(self.ptr.to(torch.int64), idx.expand(G, -1).contiguous(), right=True) - 1
        real = self.ent[..., 0] != END
        g = torch.arange(G, device=self.ent.device)[:, None].expand_as(real)[real]
        r = self.ent[..., 0][real].to(torch.int64)
        HT = torch.zeros((G, Vp1 - 1, rows), dtype=torch.float32, device=self.ent.device)
        HT[g, col[real], r] = self.ent[..., 1].contiguous().view(torch.float32)[real]
        support = torch.zeros(HT.shape, dtype=torch.bool, device=HT.device)
        support[g, col[real], r] = True
        return HT, support


def sparse_columns(st: ScoringTensors) -> SparseColumns:
    """The sparse columns of `st` (one case, or a case-stacked group),
    built with torch ops on its device once and cached on it. Raises if a
    row has lb > ub: the kernel's hinge max(max(v - ub, lb - v), 0)
    equals max(v - ub, 0) + max(lb - v, 0) only while lb <= ub."""
    if st._sparse is not None:
        return st._sparse
    H = st.H if st.H.dim() == 3 else st.H[None]
    lb = st.lb if st.lb.dim() == 2 else st.lb[None]
    ub = st.ub if st.ub.dim() == 2 else st.ub[None]
    if not bool((lb <= ub).all()):
        raise ValueError("a row has lb > ub: the sweep kernel's one-max hinge needs lb <= ub on every row")
    G, rows, Vp = H.shape
    dev = H.device
    nz = torch.nonzero(H)  # (g, r, v), sorted so: r ascends within each column
    g, r, v = nz.unbind(1)
    vals = H[g, r, v]
    col = g * Vp + v
    col, order = torch.sort(col, stable=True)
    g, r, v, vals = g[order], r[order], v[order], vals[order]
    counts = torch.bincount(col, minlength=G * Vp)
    ptr = torch.zeros((G, Vp + 1), dtype=torch.int64, device=dev)
    ptr[:, 1:] = torch.cumsum(counts.view(G, Vp) + 1, dim=1)  # + 1: the sentinel
    E = int(ptr[:, -1].max())
    first = torch.cumsum(counts, 0) - counts  # each column's first nonzero in sorted order
    slot = ptr[g, v] + torch.arange(col.numel(), device=dev) - first[col]
    ent = torch.zeros((G, E, 2), dtype=torch.int32, device=dev)
    ent[..., 0] = END
    ent[g, slot, 0] = r.to(torch.int32)
    ent[g, slot, 1] = vals.contiguous().view(torch.int32)
    bnd = torch.stack([lb, ub], dim=-1).contiguous()
    st._sparse = SparseColumns(
        ptr=ptr.to(torch.int32).contiguous(), ent=ent, bnd=bnd, max_count=int(counts.max()) if counts.numel() else 0,
        nnz=int(col.numel()))
    return st._sparse


def _catalogue(sp: SparseColumns, kind: int, catalogue, chunk: int, dev: torch.device):
    """The kernel's operands of a catalogue, (a, b, c, s, valid, M) on
    `dev`, uploaded once per catalogue and cached with the sparse columns
    (the cache holds the catalogue's tensors, so their ids stay theirs)."""
    key = (kind, chunk, str(dev)) + tuple(id(t) for t in catalogue)
    hit = sp.catalogues.get(key)
    if hit is not None:
        return hit[1]
    if kind == 0:
        Vp = sp.ptr.shape[1] - 1
        ops = (None, None, None, None, None, 2 * Vp)
    elif kind == 1:
        mm, mp = (t.to(device=dev, dtype=torch.int32).contiguous() for t in catalogue)
        ops = (mm, mp, None, None, None, (mm.shape[0] // chunk) * chunk)
    else:
        a, b, c, s, valid = catalogue
        i32 = [t.to(device=dev, dtype=torch.int32).contiguous() for t in (a, b, c)]
        s = s.to(device=dev, dtype=torch.float32).contiguous()
        valid = valid.to(device=dev, dtype=torch.uint8).contiguous()
        ops = (*i32, s, valid, (a.shape[0] // chunk) * chunk)
    sp.catalogues[key] = (tuple(catalogue), ops)
    return ops


# ------------------------------------------- the sweep kernel (csrc/sweeps.cu)


class SweepOps:
    """The three sweeps of one descent over a case-stacked group (`st`
    from `stack_cases`, X [G, B, Vp]; one case, X [B, Vp], is a group of
    one), gated by the state words of `new_state`.

    On CUDA tensors `sweep` launches the kernel of csrc/sweeps.cu
    (`launch_sweep`) in place on X, hx and scores, and `settle` folds the
    members' flags into the state with `sweep_state_kernel`: neither reads
    the card, so a block of iterations makes no host sync. The kernel
    reads the sparse columns of `st` (`sparse_columns`, built on the
    first descent of a program) and never the dense H.T. On CPU tensors
    `sweep` reads the gate on the host and runs the plain sweep, and
    `settle` updates the words with `settle_state`. The catalogues are
    shared by the group; `tiers` lists the kinds this descent runs."""

    def __init__(self, st: ScoringTensors, X: torch.Tensor, moves=None, moves3=None, chunk: int = 128):
        self.st, self.chunk = st, chunk
        self.cats = {0: (), 1: moves, 2: moves3}
        self.tiers = [k for k in (0, 1, 2) if self.cats[k] is not None]
        self.cuda = X.device.type == "cuda"
        self.G = 1 if X.dim() == 2 else X.shape[0]
        self.B, self.vp = X.shape[-2:]
        self._case_improved: List[bool] = []
        if not self.cuda:
            return
        if self.vp % chunk:
            raise ValueError("Vp %d is not a multiple of the chunk %d" % (self.vp, chunk))
        dev = X.device
        self.sp = sparse_columns(st)
        self.rows = self.sp.bnd.shape[1]
        self.x_ub = st.x_ub.reshape(self.G, self.vp).contiguous()
        self.operands = {k: _catalogue(self.sp, k, self.cats[k], chunk, dev) for k in self.tiers}
        # one key per member (all ones between sweeps), its improved flag
        self.best = torch.full((self.G, self.B), -1, dtype=torch.int64, device=dev)
        self.imp = torch.zeros((self.G, self.B), dtype=torch.int32, device=dev)
        # hx member-major [G, Rows, B] and the members' dense hinge sums
        # [G, B], made from the hx of the first launch (`_bind`) and kept in
        # step by the kernel
        self.hxT = self.base = None
        self._hx, self._hx_version = None, -1

    def _bind(self, hx: torch.Tensor, lib: ctypes.CDLL) -> None:
        """Make hxT and base from `hx` unless they were made from this
        tensor as it is: the kernel keeps them in step with its own
        writes, which torch does not see, and any torch write to hx bumps
        its version. hxT is always a copy (at B = 1 the transpose is
        already contiguous)."""
        if hx is self._hx and hx._version == self._hx_version:
            return
        self.hxT = torch.empty((self.G, self.rows, self.B), dtype=torch.float32, device=hx.device)
        self.hxT.copy_(hx.reshape(self.G, self.B, self.rows).transpose(1, 2))
        self.base = torch.empty((self.G, self.B), dtype=torch.float32, device=hx.device)
        err = lib.sweeps_base_launch(hx.data_ptr(), self.sp.bnd.data_ptr(), self.base.data_ptr(), self.G, self.B,
                                     self.rows, torch.cuda.current_stream(hx.device).cuda_stream)
        _check(lib, err, "sweeps base kernel launch")
        self._hx, self._hx_version = hx, hx._version

    def sweep(self, kind: int, X, hx, scores, state: torch.Tensor):
        """One gated sweep of `kind`; returns (X, hx, scores)."""
        if self.cuda:
            launch_sweep(self, kind, X, hx, scores, state)
            return X, hx, scores
        words = state.tolist()
        if not sweep_gate(words, kind):
            return X, hx, scores
        plain = PLAIN_SWEEPS[KINDS[kind]]
        X, hx, scores, improved = plain(self.st, X, hx, scores, *self.cats[kind], chunk=self.chunk)
        self._case_improved = [bool(v) for v in improved.reshape(-1).tolist()]
        return X, hx, scores

    def settle(self, kind: int, state: torch.Tensor, last: bool) -> None:
        """Fold the last sweep of `kind` into the state words."""
        if self.cuda:
            lib = _library()
            with _on_device(state.device):
                err = lib.sweeps_state_launch(
                    kind, int(last), self.G, self.B, self.imp.data_ptr(), state.data_ptr(),
                    torch.cuda.current_stream(state.device).cuda_stream,
                )
            _check(lib, err, "sweeps state kernel launch")
            return
        words = state.tolist()
        settle_state(words, kind, self._case_improved, last)
        state.copy_(torch.tensor(words, dtype=state.dtype))


def _on_device(dev: torch.device):
    """The device guard for a launch on `dev` (none when it is current)."""
    if dev.index is not None and dev.index != torch.cuda.current_device():
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def launch_sweep(
    ops: SweepOps,
    kind: int,
    X,
    hx,
    scores,
    state: torch.Tensor,
    move_scores: Optional[torch.Tensor] = None,
    visits: Optional[torch.Tensor] = None,
) -> None:
    """Launch one sweep of `kind` (0 delta, 1 paired, 2 triple) of the
    kernel csrc/sweeps.cu, in place on X [G, B, Vp], hx [G, B, Rows] and
    scores [G, B] (or the same without G for one case), gated by the
    state words; `ops.imp` receives the members' improved flags. For
    checks, `move_scores` ([G, B, M] f32), when given, receives every
    move's score in the order of `move_scores_plain`, and `visits` ([G, M]
    int32) every move's |U_m|, the rows it visits; then no move is
    skipped. CUDA tensors only; raises on any fault.
    `launch_sweep.launches` counts the launches, `launch_sweep.by_kind`
    each kind's (gated-off ones too: the host does not know the gate)."""
    tensors = (X, hx, scores)
    if not ops.cuda or any(t.device != ops.sp.ent.device for t in tensors + (state,)):
        raise ValueError("launch_sweep runs on CUDA tensors on one device, the scoring tensors' and the state's")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise ValueError("X, hx and scores must be contiguous float32 tensors")
    G, B, rows, vp = ops.G, ops.B, ops.rows, ops.vp
    if (
        X.shape[-2:] != (B, vp)
        or hx.shape[-2:] != (B, rows)
        or X.numel() != G * B * vp
        or scores.numel() != G * B
        or hx.numel() != G * B * rows
    ):
        raise ValueError("X %s, hx %s, scores %s do not match the group %s" % (
            tuple(X.shape), tuple(hx.shape), tuple(scores.shape), (G, B)))
    if state.dtype != torch.int32 or state.numel() != STATE_WORDS:
        raise ValueError("state must be the %d int32 words of new_state" % STATE_WORDS)
    if kind not in ops.operands:
        raise ValueError("this descent has no %s catalogue" % KINDS[kind])
    a, b, c, s, valid, M = ops.operands[kind]
    if M == 0:
        raise ValueError("the %s catalogue has no full chunk of %d" % (KINDS[kind], ops.chunk))
    for name, t, dtype, n in (("move_scores", move_scores, torch.float32, G * B * M),
                              ("visits", visits, torch.int32, G * M)):
        if t is not None and (t.dtype != dtype or not t.is_contiguous() or t.numel() != n or t.device != X.device):
            raise ValueError("%s must be a contiguous %s tensor of %d elements on X's device" % (name, dtype, n))
    lib = _library()

    def ptr(t: Optional[torch.Tensor]):
        return t.data_ptr() if t is not None else None

    sp = ops.sp
    with _on_device(X.device):
        ops._bind(hx, lib)
        err = lib.sweeps_launch(
            kind, ptr(a), ptr(b), ptr(c), ptr(s), ptr(valid), M, ops.chunk,
            sp.ptr.data_ptr(), sp.ent.data_ptr(), sp.ent.shape[1], sp.bnd.data_ptr(), ops.x_ub.data_ptr(),
            X.data_ptr(), hx.data_ptr(), ops.hxT.data_ptr(), scores.data_ptr(), ops.base.data_ptr(),
            G, B, rows, vp,
            state.data_ptr(), ops.best.data_ptr(), ops.imp.data_ptr(), ptr(move_scores), ptr(visits),
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    _check(lib, err, "sweeps kernel launch")
    with _COUNT_LOCK:
        launch_sweep.launches += 1
        launch_sweep.by_kind[kind] += 1


launch_sweep.launches = 0
launch_sweep.by_kind = [0, 0, 0]


def sweep_kernel(
    kind: str,
    st: ScoringTensors,
    X,
    hx,
    scores,
    *catalogue,
    chunk: int = 128,
    state=None,
    want_move_scores=False,
    want_visits=False,
):
    """One sweep of `kind` ("delta", "moves" or "moves3") through the
    kernel, called as the plain sweep of that kind is and returning what
    it returns, (X', hx', scores', improved_any), on copies of X, hx and
    scores; with `want_move_scores` also every move's score (see
    `move_scores_plain`), then with `want_visits` every move's |U_m|
    ([G, M], or [M] for one case). `state` (default: `new_state(1)`, so
    the sweep runs) gates it: a gated-off launch returns the inputs'
    values and no improvement. CUDA tensors only."""
    k = KINDS.index(kind)
    if X.device.type != "cuda":
        raise ValueError("sweep_kernel runs on CUDA tensors; the plain sweeps serve the CPU")
    cats = {0: {}, 1: {"moves": catalogue}, 2: {"moves3": catalogue}}[k]
    ops = SweepOps(st, X, chunk=chunk, **cats)
    X2, hx2, s2 = X.clone(), hx.clone(), scores.clone()
    state = new_state(1, X.device) if state is None else state
    M = ops.operands[k][-1]
    ms = vis = None
    if want_move_scores or want_visits:
        ms = torch.zeros(tuple(X.shape[:-1]) + (M,), dtype=torch.float32, device=X.device)
    if want_visits:
        vis = torch.zeros(tuple(X.shape[:-2]) + (M,), dtype=torch.int32, device=X.device)
    launch_sweep(ops, k, X2, hx2, s2, state, ms, vis)
    improved = ops.imp.bool().any(dim=-1)
    out = (X2, hx2, s2, improved[0] if X.dim() == 2 else improved)
    if want_move_scores:
        out += (ms,)
    return out + (vis,) if want_visits else out


def move_scores_plain(kind: str, st: ScoringTensors, hx: torch.Tensor, *catalogue, chunk: int = 128) -> torch.Tensor:
    """Every move's hinge sum of one sweep in plain PyTorch, before the
    validity mask: [..., B, M] for hx [..., B, Rows]. The moves are in
    the kernel's order: the delta sweep's chunk by chunk, [+chunk |
    -chunk]; a catalogue's in its own order, whole chunks only."""
    single = hx.dim() == 2
    HT, lb, ub = st.columns(), st.lb, st.ub
    if single:
        HT, lb, ub, hx = HT[None], lb[None], ub[None], hx[None]
    Vp = HT.shape[1]
    parts = []
    if kind == "delta":
        for c0 in range(0, (Vp // chunk) * chunk, chunk):
            Hc = HT[:, c0 : c0 + chunk]
            parts += [_hinge_sum(lb, ub, hx, Hc), _hinge_sum(lb, ub, hx, -Hc)]
    else:
        M = (catalogue[0].shape[0] // chunk) * chunk
        for c0 in range(0, M, chunk):
            if kind == "moves":
                mm, mp = (t[c0 : c0 + chunk] for t in catalogue)
                D = HT[:, mp] - HT[:, mm]
            else:
                a, b, c, s = (t[c0 : c0 + chunk] for t in catalogue[:4])
                D = (HT[:, b] + HT[:, c] - HT[:, a]) * s[:, None]
            parts.append(_hinge_sum(lb, ub, hx, D))
    out = torch.cat(parts, dim=-1)
    return out[0] if single else out


def _hinge1(lb, ub, v: torch.Tensor) -> torch.Tensor:
    """max(max(v - ub, lb - v), 0), the kernel's hinge (equal to the plain
    one while lb <= ub)."""
    return torch.maximum(v - ub, lb - v).clamp_(min=0.0)


def move_scores_sparse_plain(
    kind: str, st: ScoringTensors, hx: torch.Tensor, *catalogue, chunk: int = 128
) -> torch.Tensor:
    """The kernel's formulation of every move's score, in plain PyTorch
    and for checks only (nothing on a search path calls it): base(g, b),
    the member's dense hinge sum, plus the sum over U_m, the union of the
    supports of the move's columns in the sparse columns, of
    hinge(hx + D_m) - hinge(hx), with the kernel's one-max hinge and its
    -0 -> +0. Shapes and order as `move_scores_plain`: on integer targets
    it equals it bit for bit."""
    sp = sparse_columns(st)
    single = hx.dim() == 2
    if single:
        hx = hx[None]
    HT, U = sp.dense()
    lb, ub = sp.bnd[..., 0], sp.bnd[..., 1]
    h0 = _hinge1(lb[:, None, :], ub[:, None, :], hx)  # [G, B, Rows]
    base = h0.sum(dim=-1)

    def scores_of(D, support):  # D, support [G, n, Rows] -> [G, B, n]
        v = hx[:, :, None, :] + D[:, None, :, :]
        t = _hinge1(lb[:, None, None, :], ub[:, None, None, :], v) - h0[:, :, None, :]
        diff = torch.where(support[:, None, :, :], t, 0.0).sum(dim=-1)
        return (base[..., None] + diff).clamp_(min=0.0) + 0.0

    parts = []
    if kind == "delta":
        Vp = HT.shape[1]
        for c0 in range(0, (Vp // chunk) * chunk, chunk):
            Hc, Uc = HT[:, c0 : c0 + chunk], U[:, c0 : c0 + chunk]
            parts += [scores_of(Hc, Uc), scores_of(-Hc, Uc)]
    else:
        M = (catalogue[0].shape[0] // chunk) * chunk
        for c0 in range(0, M, chunk):
            if kind == "moves":
                mm, mp = (t[c0 : c0 + chunk] for t in catalogue)
                D, S = HT[:, mp] - HT[:, mm], U[:, mp] | U[:, mm]
            else:
                a, b, c, s = (t[c0 : c0 + chunk] for t in catalogue[:4])
                D = (HT[:, b] + HT[:, c] - HT[:, a]) * s[:, None]
                S = U[:, a] | U[:, b] | U[:, c]
            parts.append(scores_of(D, S))
    out = torch.cat(parts, dim=-1)
    return out[0] if single else out


def move_valid_plain(kind: str, X: torch.Tensor, x_ub: torch.Tensor, *catalogue, chunk: int = 128) -> torch.Tensor:
    """JAX's validity of every move for every member, [..., B, M] bool for
    X [..., B, Vp] and x_ub [..., Vp], in the order of `move_scores_plain`
    (padding moves invalid)."""
    single = X.dim() == 2
    if single:
        X, x_ub = X[None], x_ub[None]
    xu = x_ub[:, None, :]
    if kind == "delta":
        Vp = X.shape[-1]
        parts = []
        for c0 in range(0, (Vp // chunk) * chunk, chunk):
            xv, uv = X[..., c0 : c0 + chunk], xu[..., c0 : c0 + chunk]
            parts += [~(xv + 1.0 > uv), ~(xv - 1.0 < 0.0)]
        out = torch.cat(parts, dim=-1)
    else:
        M = (catalogue[0].shape[0] // chunk) * chunk
        gi = torch.arange(X.shape[0], device=X.device)[:, None]
        if kind == "moves":
            mm, mp = (t[:M] for t in catalogue)
            out = (X[..., mm] >= 1.0) & (X[..., mp] + 1.0 <= x_ub[gi, mp][:, None, :])
        else:
            a, b, c, s, valid = (t[:M] for t in catalogue)
            need_bc = torch.where(b == c, 2.0, 1.0)
            ok_split = (X[..., a] >= 1.0) & (X[..., b] + need_bc <= x_ub[gi, b][:, None, :]) & (
                X[..., c] + 1.0 <= x_ub[gi, c][:, None, :])
            ok_merge = (X[..., b] >= need_bc) & (X[..., c] >= 1.0) & (X[..., a] + 1.0 <= x_ub[gi, a][:, None, :])
            out = torch.where(s > 0, ok_split, ok_merge) & valid.bool()
    return out[0] if single else out
