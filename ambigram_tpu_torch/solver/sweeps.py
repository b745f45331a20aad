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
csrc/sweeps.cu instead (`SweepOps`, `sweep_kernel`): it scores a whole
sweep without the temporary, and its launches read their tier gates
from state words on the device (`new_state`), so the host can queue a
block of descent iterations and read one flag per block.
"""

from __future__ import annotations

import contextlib
import ctypes
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
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 5
)


def _library() -> ctypes.CDLL:
    from ambigram_tpu_torch import kernels

    lib = kernels.load("sweeps")
    if lib.sweeps_launch.argtypes is None:
        lib.sweeps_launch.argtypes = _SWEEPS_ARGTYPES
        lib.sweeps_launch.restype = ctypes.c_int
        lib.sweeps_state_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        lib.sweeps_state_launch.restype = ctypes.c_int
        lib.sweeps_error_string.argtypes = [ctypes.c_int]
        lib.sweeps_error_string.restype = ctypes.c_char_p
    return lib


class SweepOps:
    """The three sweeps of one descent over a case-stacked group (`st`
    from `stack_cases`, X [G, B, Vp]; one case, X [B, Vp], is a group of
    one), gated by the state words of `new_state`.

    On CUDA tensors `sweep` launches the kernel of csrc/sweeps.cu
    (`launch_sweep`) in place on X, hx and scores, and `settle` folds the
    members' flags into the state with `sweep_state_kernel`: neither reads
    the card, so a block of iterations makes no host sync. On CPU tensors
    `sweep` reads the gate on the host and runs the plain sweep, and
    `settle` updates the words with `settle_state`. The catalogues are
    shared by the group; `tiers` lists the kinds this descent runs."""

    def __init__(self, st: ScoringTensors, X: torch.Tensor, moves=None, moves3=None, chunk: int = 128):
        self.st, self.chunk = st, chunk
        self.cats = {0: (), 1: moves, 2: moves3}
        self.tiers = [k for k in (0, 1, 2) if self.cats[k] is not None]
        self.cuda = X.device.type == "cuda"
        self.G = 1 if X.dim() == 2 else X.shape[0]
        self.B, Vp = X.shape[-2:]
        self._case_improved: List[bool] = []
        if not self.cuda:
            return
        lead = (1,) if X.dim() == 2 else ()

        def cased(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(lead + tuple(t.shape)).contiguous()

        self.HT = cased(st.columns())
        self.lb, self.ub, self.x_ub = cased(st.lb), cased(st.ub), cased(st.x_ub)
        if Vp % chunk:
            raise ValueError("Vp %d is not a multiple of the chunk %d" % (Vp, chunk))
        dev = X.device
        self.operands = {0: (None, None, None, None, None, 2 * Vp)}
        if moves is not None:
            mm, mp = (t.to(device=dev, dtype=torch.int32).contiguous() for t in moves)
            self.operands[1] = (mm, mp, None, None, None, (mm.shape[0] // chunk) * chunk)
        if moves3 is not None:
            a, b, c, s, valid = moves3
            i32 = [t.to(device=dev, dtype=torch.int32).contiguous() for t in (a, b, c)]
            s = s.to(device=dev, dtype=torch.float32).contiguous()
            valid = valid.to(device=dev, dtype=torch.uint8).contiguous()
            self.operands[2] = (*i32, s, valid, (a.shape[0] // chunk) * chunk)
        # one key per member (all ones between sweeps) and its improved flag
        self.best = torch.full((self.G, self.B), -1, dtype=torch.int64, device=dev)
        self.imp = torch.zeros((self.G, self.B), dtype=torch.int32, device=dev)

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
            if err != 0:
                raise RuntimeError("sweeps state kernel launch failed: %s (cudaError %d)"
                                   % (lib.sweeps_error_string(err).decode(), err))
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
    ops: SweepOps, kind: int, X, hx, scores, state: torch.Tensor, move_scores: Optional[torch.Tensor] = None
) -> None:
    """Launch one sweep of `kind` (0 delta, 1 paired, 2 triple) of the
    kernel csrc/sweeps.cu, in place on X [G, B, Vp], hx [G, B, Rows] and
    scores [G, B] (or the same without G for one case), gated by the
    state words; `ops.imp` receives the members' improved flags, and
    `move_scores` ([G, B, M] f32, for checks), when given, every move's
    hinge sum in the order of `move_scores_plain`. CUDA tensors only;
    raises on any fault. `launch_sweep.launches` counts the
    launches, `launch_sweep.by_kind` each kind's (gated-off ones too: the
    host does not know the gate)."""
    tensors = (X, hx, scores)
    if any(t.device.type != "cuda" or t.device != state.device or t.device != ops.HT.device for t in tensors):
        raise ValueError("launch_sweep runs on CUDA tensors on one device, the scoring tensors' and the state's")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise ValueError("X, hx and scores must be contiguous float32 tensors")
    lead = (ops.G, ops.B)
    if (
        X.shape[-2:] != (ops.B, ops.HT.shape[1])
        or hx.shape[-2:] != (ops.B, ops.HT.shape[2])
        or X.numel() != ops.G * ops.B * ops.HT.shape[1]
        or scores.numel() != ops.G * ops.B
        or hx.numel() != ops.G * ops.B * ops.HT.shape[2]
    ):
        raise ValueError("X %s, hx %s, scores %s do not match the group %s" % (
            tuple(X.shape), tuple(hx.shape), tuple(scores.shape), lead))
    if state.dtype != torch.int32 or state.numel() != STATE_WORDS:
        raise ValueError("state must be the %d int32 words of new_state" % STATE_WORDS)
    a, b, c, s, valid, M = ops.operands[kind]
    if M == 0:
        raise ValueError("the %s catalogue has no full chunk of %d" % (KINDS[kind], ops.chunk))
    if move_scores is not None and (
        move_scores.dtype != torch.float32
        or not move_scores.is_contiguous()
        or move_scores.numel() != ops.G * ops.B * M
        or move_scores.device != X.device
    ):
        raise ValueError("move_scores must be a contiguous float32 [G, B, %d] tensor on X's device" % M)
    lib = _library()

    def ptr(t: Optional[torch.Tensor]):
        return t.data_ptr() if t is not None else None

    rows, vp = ops.HT.shape[2], ops.HT.shape[1]
    with _on_device(X.device):
        err = lib.sweeps_launch(
            kind, ptr(a), ptr(b), ptr(c), ptr(s), ptr(valid), M, ops.chunk,
            ops.HT.data_ptr(), ops.lb.data_ptr(), ops.ub.data_ptr(), ops.x_ub.data_ptr(),
            X.data_ptr(), hx.data_ptr(), scores.data_ptr(),
            ops.G, ops.B, rows, vp,
            state.data_ptr(), ops.best.data_ptr(), ops.imp.data_ptr(), ptr(move_scores),
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "sweeps kernel launch failed: %s (cudaError %d)" % (lib.sweeps_error_string(err).decode(), err)
        )
    with _COUNT_LOCK:
        launch_sweep.launches += 1
        launch_sweep.by_kind[kind] += 1


launch_sweep.launches = 0
launch_sweep.by_kind = [0, 0, 0]


def sweep_kernel(
    kind: str, st: ScoringTensors, X, hx, scores, *catalogue, chunk: int = 128, state=None, want_move_scores=False
):
    """One sweep of `kind` ("delta", "moves" or "moves3") through the
    kernel, called as the plain sweep of that kind is and returning what
    it returns, (X', hx', scores', improved_any), on copies of X, hx and
    scores; with `want_move_scores` also every move's hinge sum (see
    `move_scores_plain`). `state` (default: `new_state(1)`, so the sweep
    runs) gates it: a gated-off launch returns the inputs' values and no
    improvement. CUDA tensors only."""
    k = KINDS.index(kind)
    if X.device.type != "cuda":
        raise ValueError("sweep_kernel runs on CUDA tensors; the plain sweeps serve the CPU")
    cats = {0: {}, 1: {"moves": catalogue}, 2: {"moves3": catalogue}}[k]
    ops = SweepOps(st, X, chunk=chunk, **cats)
    X2, hx2, s2 = X.clone(), hx.clone(), scores.clone()
    state = new_state(1, X.device) if state is None else state
    ms = None
    if want_move_scores:
        ms = torch.zeros(tuple(X.shape[:-1]) + (ops.operands[k][-1],), dtype=torch.float32, device=X.device)
    launch_sweep(ops, k, X2, hx2, s2, state, ms)
    improved = ops.imp.bool().any(dim=-1)
    out = (X2, hx2, s2, improved[0] if X.dim() == 2 else improved)
    return out + (ms,) if want_move_scores else out


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
