"""Device-resident search over candidate BFB structures, in PyTorch.

Port of the single-case path of ambigram_tpu/solver/search.py:
population steepest descent over three tiered move neighborhoods
(solver/sweeps.py), basin hopping with random kicks, then the host tail
(LNS polish and the LP certificate). JAX's `lax.while_loop`/`lax.cond`
become a host loop that reads one `improved` flag per sweep, and
`jax.random` becomes a `torch.Generator`, so a search's trajectory
differs from the JAX one after its first kick; its quality is what the
tests compare.

The two full rescorings of a round, at the start and after each kick, go
through `score_rows`: the hand-written CUDA kernel K1 on a card, its
plain version on the CPU.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ambigram_tpu.engine.ilp import BfbProgram
from ambigram_tpu.solver.exact import SolveResult
from ambigram_tpu.utils.profiling import GLOBAL
from ambigram_tpu_torch.solver.host import (
    _seed_case,
    certified_bound,
    slide_transfer_moves,
    split_merge_moves,
)
from ambigram_tpu_torch.solver.score import ScoringTensors, score_rows, scoring_tensors
from ambigram_tpu_torch.solver.sweeps import sweep_delta, sweep_moves, sweep_moves3

_KICK_SIGNS = (-2.0, -1.0, 1.0, 2.0)
_N_KICKS = 4


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a card raises
    (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but no CUDA device is available" % dev)
    return dev


def descend_loop(
    st: ScoringTensors,
    X: torch.Tensor,
    hx: torch.Tensor,
    scores: torch.Tensor,
    max_sweeps: int,
    chunk: int,
    moves=None,
    moves3=None,
):
    """Tiered descent: single-variable sweeps while they improve; when
    they stall, one paired-move sweep; when BOTH stall, one triple-move
    sweep. Any lower tier's success resumes tier 1, so the expensive
    tiers run only at basin floors. Returns (X, hx, scores,
    n_delta_sweeps, n_move_sweeps, n_move3_sweeps)."""
    it = n_mv = n_m3 = 0
    improved = True
    while improved and it < max_sweeps:
        X, hx, scores, imp = sweep_delta(st, X, hx, scores, chunk=chunk)
        improved = bool(imp)
        if moves is not None and not improved:
            X, hx, scores, imp = sweep_moves(st, X, hx, scores, *moves, chunk=chunk)
            n_mv += 1
            improved = bool(imp)
        if moves3 is not None and not improved:
            X, hx, scores, imp = sweep_moves3(st, X, hx, scores, *moves3, chunk=chunk)
            n_m3 += 1
            improved = bool(imp)
        it += 1
    return X, hx, scores, it, n_mv, n_m3


def _kick(X: torch.Tensor, best_x: torch.Tensor, x_ub: torch.Tensor, gen: torch.Generator):
    """Restart every member with 4 random +-1/+-2 kicks: even members
    from the global best (exploitation), odd members from their own
    minimum (diversity); member 0 stays exactly at the global best."""
    B, Vp = X.shape
    vars_ = torch.randint(0, Vp, (B, _N_KICKS), generator=gen)
    signs = torch.tensor(_KICK_SIGNS)[torch.randint(0, len(_KICK_SIGNS), (B, _N_KICKS), generator=gen)]
    kick = torch.zeros((B, Vp), dtype=X.dtype).scatter_add_(1, vars_, signs)
    kick[0] = 0.0
    kick = kick.to(X.device)
    from_best = (torch.arange(B, device=X.device) % 2 == 0)[:, None]
    base = torch.where(from_best, best_x[None, :], X)
    return torch.minimum(torch.clamp(base + kick, min=0.0), x_ub)


def search_impl(
    st: ScoringTensors,
    X: torch.Tensor,
    gen: torch.Generator,
    moves: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    moves3=None,
    rounds: int = 6,
    max_sweeps: int = 256,
    chunk: int = 128,
    target: float = 0.0,
    patience: int = 2,
):
    """Basin hopping: steepest descent to a local optimum, fold the
    round's best into the global best, kick, rescore. Stops after
    `rounds`, when the best meets `target` (the certified LP bound, 0
    when unavailable), or after more than `patience` rounds in a row
    without improving the best. Returns (best_x [Vp], best_s, (n_delta,
    n_moves, n_moves3) sweep counts, stagnant): stagnant > patience
    means the search converged, otherwise its round budget starved it.

    Scores are compared in f32 as in the JAX loop; `gen` (a CPU
    generator) draws the kicks, so a CPU and a CUDA run of one seed
    follow the same trajectory."""
    scores, hx = score_rows(st, X, want_hx=True)
    best_x = X[0].clone()
    best_s = np.float32(scores[0].item())
    tgt = np.float32(target)
    tol = np.float32(1e-6)
    n_d = n_m = n_3 = 0
    r = stagnant = 0
    while r < rounds and best_s > tgt and stagnant <= patience:
        prev_best = best_s
        X, hx, scores, d, m, t = descend_loop(
            st, X, hx, scores, max_sweeps, chunk, moves, moves3
        )
        n_d, n_m, n_3 = n_d + d, n_m + m, n_3 + t
        idx = int(torch.argmin(scores))
        round_best = np.float32(scores[idx].item())
        if round_best < best_s:
            best_x = X[idx].clone()
            best_s = round_best
        X = _kick(X, best_x, st.x_ub, gen)
        scores, hx = score_rows(st, X, want_hx=True)
        stagnant = 0 if best_s < prev_best - tol else stagnant + 1
        r += 1
    return best_x, best_s, (n_d, n_m, n_3), stagnant


_MOVES_CACHE: dict = {}


def _device_moves(prog: BfbProgram, device: torch.device):
    """Move catalogues on `device`, cached by (start, end, num_vars,
    device): same-interval cases would otherwise rebuild the O(n^3)
    catalogue and upload it per case. Returns (moves, moves3) with index
    tensors in int64."""
    key = (prog.start, prog.end, prog.num_vars, str(device))
    if key not in _MOVES_CACHE:

        def up(a: np.ndarray) -> torch.Tensor:
            t = torch.as_tensor(a)
            if t.dtype == torch.int32:
                t = t.to(torch.int64)
            return t.to(device)

        mv_minus, mv_plus = slide_transfer_moves(prog)
        m3 = split_merge_moves(prog)
        _MOVES_CACHE[key] = (up(mv_minus), up(mv_plus)), tuple(up(a) for a in m3)
    return _MOVES_CACHE[key]


def solve_device(prog: BfbProgram, device="cuda") -> SolveResult:
    """Tiered device search on `device`, then the host tail: LNS polish
    when the incumbent falls short of the LP certificate (wall clock
    capped by AMBIGRAM_LNS_BUDGET), then the certificate. Search budgets
    come from the env knobs AMBIGRAM_SEARCH_POP / _ROUNDS / _SWEEPS /
    _PATIENCE (32 / 6 / 256 / 2)."""
    d = _dispatch_single(prog, device)
    x = _block_and_account(d)[: prog.num_vars]
    return _finish_solution(prog, x, d["lb"], converged=d["converged"])


def _dispatch_single(prog: BfbProgram, device) -> dict:
    """Seed and run ONE case's tiered search (seed 0). Returns the dict
    that `_block_and_account` reads."""
    device = resolve_device(device)
    seed = 0
    pop = int(os.environ.get("AMBIGRAM_SEARCH_POP", 32))
    rounds = int(os.environ.get("AMBIGRAM_SEARCH_ROUNDS", 6))
    max_sweeps = int(os.environ.get("AMBIGRAM_SEARCH_SWEEPS", 256))
    patience = int(os.environ.get("AMBIGRAM_SEARCH_PATIENCE", 2))
    with GLOBAL.phase("solve.tensors"):
        st = scoring_tensors(prog, device)
    Vp = st.H.shape[1]
    x_ub_np = np.zeros(Vp, dtype=np.float32)
    x_ub_np[: prog.num_vars] = prog.x_ub
    with GLOBAL.phase("solve.lp_bound"):
        X0, lb = _seed_case(prog, Vp, x_ub_np, pop, seed)
    gen = torch.Generator().manual_seed(seed)
    moves, moves3 = _device_moves(prog, device)
    target = max(float(certified_bound(prog, lb)), 0.0) if lb is not None else 0.0
    with GLOBAL.phase("score"):
        best_x, best_s, sweeps, stagnant = search_impl(
            st,
            torch.as_tensor(X0).to(device),
            gen,
            moves,
            moves3,
            rounds=rounds,
            max_sweeps=max_sweeps,
            target=target,
            patience=patience,
        )
    return {
        "best_x": best_x,
        "best_s": best_s,
        "stagnant": stagnant,
        "target": target,
        "patience": patience,
        "sweeps": sweeps,
        "lb": lb,
        "pop": pop,
        "Vp": Vp,
        "M": moves[0].shape[0],
        "M3": moves3[0].shape[0],
    }


def _block_and_account(d: dict) -> np.ndarray:
    """Copy best_x to the host, record the real candidates-scored count
    (a delta sweep evaluates 2*Vp moves per member, a paired-move sweep
    M, a triple sweep M3) and the sweep counts, and resolve the
    `converged` flag (stagnation exit or target met, vs round-budget
    starvation) the polish stage reads."""
    with GLOBAL.phase("score"):
        best = d["best_x"].cpu().numpy()
    n_d, n_m, n_3 = d["sweeps"]
    d["converged"] = bool(d["stagnant"] > d["patience"] or d["best_s"] <= d["target"] + 1e-6)
    GLOBAL.count(
        "candidates_scored",
        float(d["pop"]) * (n_d * 2.0 * d["Vp"] + n_m * d["M"] + n_3 * d["M3"]),
    )
    GLOBAL.count("search.delta_sweeps", n_d)
    GLOBAL.count("search.move_sweeps", n_m)
    GLOBAL.count("search.move3_sweeps", n_3)
    GLOBAL.count("solve.device_calls")
    return best


def _finish_solution(
    prog: BfbProgram,
    x: np.ndarray,
    lb: Optional[float],
    converged: bool = True,
) -> SolveResult:
    """Host tail: measure the incumbent, polish when it falls short of
    the certificate, certify, wrap.

    A CONVERGED incumbent is already a local optimum of the full tiered
    neighborhood, so it gets only the cheap LNS probe (escalating on
    improvement); a BUDGET-STARVED one, or one with a hard violation,
    goes straight to the full polish."""
    from ambigram_tpu_torch.solver.lns import lns_polish

    x_int = np.round(x).astype(np.int64)
    eps_sum = float(prog.residual_objective(x_int.astype(np.float64)))
    violation = float(prog.hard_violation(x_int.astype(np.float64)))
    tgt = certified_bound(prog, lb) if lb is not None else None
    if (
        violation > 0.0 or (eps_sum > 0.0 and (tgt is None or eps_sum > tgt + 1e-6))
    ):
        with GLOBAL.phase("solve.lns"):
            if violation > 0.0 or not converged:
                x_p, eps_p, vio_p = lns_polish(prog, x_int, target=tgt)
            else:
                t0 = time.perf_counter()
                full = float(os.environ.get("AMBIGRAM_LNS_BUDGET", 45.0))
                x_p, eps_p, vio_p = lns_polish(
                    prog, x_int, target=tgt, time_budget=min(6.0, full), probe=True
                )
                left = full - (time.perf_counter() - t0)
                if (vio_p, eps_p) < (violation, eps_sum) and left > 1.0 and (
                    tgt is None or eps_p > tgt + 1e-6
                ):
                    # escalate from the ORIGINAL incumbent, not the
                    # probe's point: the probe's budget-starved endpoint
                    # MILP can move it into a worse basin
                    x_f, eps_f, vio_f = lns_polish(prog, x_int, target=tgt, time_budget=left)
                    if (vio_f, eps_f) < (vio_p, eps_p):
                        x_p, eps_p, vio_p = x_f, eps_f, vio_f
        if (vio_p, eps_p) < (violation, eps_sum):
            x_int, eps_sum, violation = x_p, eps_p, vio_p
    status = "heuristic"
    if violation == 0.0:
        # eps == 0 is its own certificate (the objective is nonnegative)
        if eps_sum == 0.0:
            status = "optimal"
        # otherwise the integer optimum is a half-integer >= the LP bound
        elif lb is not None and eps_sum <= certified_bound(prog, lb) + 1e-6:
            status = "optimal"
    elif violation > 0:
        status = "error"
    return SolveResult(
        x=x_int,
        epsilon_sum=eps_sum,
        objective=eps_sum - prog.bias,
        status=status,
    )
