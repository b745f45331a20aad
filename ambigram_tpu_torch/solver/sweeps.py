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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ambigram_tpu_torch.solver.score import ScoringTensors


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
