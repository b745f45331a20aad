"""Device-resident search over candidate BFB structures, in PyTorch.

Port of ambigram_tpu/solver/search.py: population steepest descent over
three tiered move neighborhoods (solver/sweeps.py), basin hopping with
random kicks, then the host tail (LNS polish and the LP certificate),
for one case (`solve_device`, a group of one) and for a list of cases
searched in case-stacked same-shape groups (`solve_device_batch`).

The descent is JAX's device program: its `lax.while_loop` carry and
`lax.cond` tier gates are state words on the device that every sweep
launch reads (solver/sweeps.py), the sweeps are the hand-written kernel
csrc/sweeps.cu on a card, and the host queues blocks of iterations and
reads one word per block. The basin-hopping rounds read one flag per
round on the host. So several groups can search at once, and
`solve_device_batch` keeps JAX's window of `MAX_INFLIGHT` groups in
flight, each on its own CUDA stream. `jax.random` becomes a
`torch.Generator` per case, so a search's trajectory differs from the
JAX one after its first kick; its quality is what the tests compare.

The full rescorings of a round, at the start and after each kick, go
through `score_rows`: the hand-written CUDA kernel K1 on a card (one
launch for a whole case-stacked group), its plain version on the CPU.

Unlike the original, the host tail times its measurement of the
incumbent (eps, violation, certified target) under the phase
`solve.measure`, its LNS probe under `solve.lns.probe` and every full
polish under `solve.lns.full` (both inside `solve.lns`), and counts its
probes (`lns.probes`), the probes it escalated (`lns.escalations`) and
the eps it gained (`lns.eps_gain`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ambigram_tpu_torch.engine.ilp import BfbProgram
from ambigram_tpu_torch.solver.exact import SolveResult
from ambigram_tpu_torch.solver.host import (
    _seed_case,
    certified_bound,
    slide_transfer_moves,
    split_merge_moves,
)
from ambigram_tpu_torch.parallel.mesh import stack_cases
from ambigram_tpu_torch.solver.score import ScoringTensors, score_rows
from ambigram_tpu_torch.solver.sweeps import SweepOps, new_state
from ambigram_tpu_torch.utils.profiling import GLOBAL

_KICK_SIGNS = (-2.0, -1.0, 1.0, 2.0)
_N_KICKS = 4
DESCEND_BLOCK = 8  # descent iterations queued between two reads of the state words
MAX_INFLIGHT = 4  # case-stacked groups in flight in solve_device_batch, JAX's max_inflight


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
    n_delta_sweeps, n_move_sweeps, n_move3_sweeps).

    A case-stacked group (X [G, B, Vp]) takes the JAX batch search's
    batch-global gates: tier 2 runs when ANY case stalled at tier 1 (it
    is only a few times tier 1's cost), tier 3 only when NO case
    improved at tiers 1 and 2. Every tier sweeps every case; a converged
    case rides along, since accepts are strictly improving. For one case
    both gates are the rule above.

    JAX's while_loop carry and lax.cond predicates live in the state
    words of `new_state`, which every sweep reads for its gate
    (`SweepOps`). The host queues `DESCEND_BLOCK` iterations at a time
    (`descend_block`) and reads the words once per block; an iteration
    after convergence or past `max_sweeps` is a no-op and counts nothing,
    so the result and the counts are JAX's whatever the block size. On a
    card the sweeps are the kernel of csrc/sweeps.cu and a block makes no
    host sync; on the CPU they are the plain sweeps, gated on the host."""
    ops = SweepOps(st, X, moves, moves3, chunk)
    if ops.cuda:
        # the kernel updates in place; the caller's tensors stay as they were
        X, hx, scores = X.clone(), hx.clone(), scores.clone()
    state = new_state(max_sweeps, X.device)
    while True:
        X, hx, scores = descend_block(ops, X, hx, scores, state, DESCEND_BLOCK)
        improved, it, n_mv, n_m3 = state[:4].tolist()
        if not improved or it >= max_sweeps:
            return X, hx, scores, it, n_mv, n_m3


def descend_block(ops: SweepOps, X, hx, scores, state: torch.Tensor, n: int):
    """Queue `n` gated descent iterations (each: the tiers of `ops`, each
    sweep followed by the fold of its flags into `state`); returns (X, hx,
    scores). On a card it reads nothing back."""
    last = ops.tiers[-1]
    for _ in range(n):
        for kind in ops.tiers:
            X, hx, scores = ops.sweep(kind, X, hx, scores, state)
            ops.settle(kind, state, last=kind == last)
    return X, hx, scores


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


def batch_search(
    st: ScoringTensors,
    X: torch.Tensor,
    gens: List[torch.Generator],
    moves=None,
    moves3=None,
    targets: Optional[torch.Tensor] = None,
    rounds: int = 6,
    max_sweeps: int = 256,
    chunk: int = 128,
    patience: int = 2,
):
    """Basin hopping over a case-stacked group (st from `stack_cases`, X
    [G, B, Vp]; one case is a group of one): steepest descent to a local
    optimum, fold each case's round best into its best, kick, rescore.
    The rounds go on while any case is active: above its target (the
    certified LP bound, 0 when unavailable or when `targets` is None)
    and not stagnant for more than `patience` rounds in a row. Returns
    (best_x [G, Vp], best_s [G], (n_delta, n_moves, n_moves3), stagnant
    [G]): stagnant > patience means the case converged, otherwise its
    round budget starved it.

    Scores are compared in f32 as in the JAX loop. `gens` (CPU
    generators, one per case) draw the kicks, so a CPU and a CUDA run of
    one seed follow the same trajectory. Reads one flag per round (the
    port's stand-in for JAX's round while_loop) and, inside
    `descend_loop`, the state words once per block of descent
    iterations."""
    G = X.shape[0]
    scores, hx = score_rows(st, X, want_hx=True)
    best_x = X[:, 0].clone()
    best_s = scores[:, 0].clone()
    tgt = torch.clamp(targets, min=0.0) if targets is not None else torch.zeros_like(best_s)
    stagnant = torch.zeros(G, dtype=torch.int64, device=X.device)
    gi = torch.arange(G, device=X.device)
    n_d = n_m = n_3 = 0
    r = 0
    while r < rounds and bool(((best_s > tgt) & (stagnant <= patience)).any()):
        prev_best = best_s
        X, hx, scores, d, m, t = descend_loop(st, X, hx, scores, max_sweeps, chunk, moves, moves3)
        n_d, n_m, n_3 = n_d + d, n_m + m, n_3 + t
        idx = torch.argmin(scores, dim=1)
        round_best = scores[gi, idx]
        take = round_best < best_s
        best_x = torch.where(take[:, None], X[gi, idx], best_x)
        best_s = torch.where(take, round_best, best_s)
        X = torch.stack([_kick(X[g], best_x[g], st.x_ub[g], gens[g]) for g in range(G)])
        scores, hx = score_rows(st, X, want_hx=True)
        stagnant = torch.where(best_s < prev_best - 1e-6, 0, stagnant + 1)
        r += 1
    return best_x, best_s, (n_d, n_m, n_3), stagnant


_MOVES_CACHE: dict = {}
_MOVES_LOCK = threading.Lock()


def _device_moves(prog: BfbProgram, device: torch.device):
    """Move catalogues on `device`, cached by (start, end, num_vars,
    device): same-interval cases would otherwise rebuild the O(n^3)
    catalogue and upload it per case. Returns (moves, moves3) with index
    tensors in int64. Thread-safe."""
    key = (prog.start, prog.end, prog.num_vars, str(device))
    with _MOVES_LOCK:
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


def _budgets(pop: Optional[int] = None, rounds: Optional[int] = None, max_sweeps: Optional[int] = None):
    """(pop, rounds, max_sweeps, patience): each argument given, or, when
    it is None, its env knob AMBIGRAM_SEARCH_POP / _ROUNDS / _SWEEPS
    (32 / 6 / 256); patience is always AMBIGRAM_SEARCH_PATIENCE (2)."""
    return (
        int(os.environ.get("AMBIGRAM_SEARCH_POP", 32)) if pop is None else int(pop),
        int(os.environ.get("AMBIGRAM_SEARCH_ROUNDS", 6)) if rounds is None else int(rounds),
        int(os.environ.get("AMBIGRAM_SEARCH_SWEEPS", 256)) if max_sweeps is None else int(max_sweeps),
        int(os.environ.get("AMBIGRAM_SEARCH_PATIENCE", 2)),
    )


def solve_device(
    prog: BfbProgram,
    pop: Optional[int] = None,
    seed: int = 0,
    rounds: Optional[int] = None,
    max_sweeps: Optional[int] = None,
    certify: bool = True,
    device="cuda",
    polish: bool = True,
    lns_budget: Optional[float] = None,
) -> SolveResult:
    """Tiered device search on `device` (a group of one), then the host
    tail: LNS polish (when `polish`) if the incumbent falls short of the
    LP certificate, its wall clock capped by `lns_budget` (by default
    AMBIGRAM_LNS_BUDGET), then the certificate (when `certify`; without
    it the search does not stop at the LP bound and the status stays
    "heuristic"). `seed` seeds the population and the kicks, as in the
    JAX package; budgets left None come from the env knobs
    (`_budgets`)."""
    d = _dispatch(
        [prog], [seed], [seed], resolve_device(device), pop=pop, rounds=rounds, max_sweeps=max_sweeps, certify=certify
    )
    x = _block_and_account(d)[0, : prog.num_vars]
    return _finish_solution(
        prog,
        x,
        d["lbs"][0],
        certify=certify,
        polish=polish,
        lns_budget=lns_budget,
        converged=bool(d["converged"][0]),
    )


def _dispatch(
    group: List[BfbProgram],
    seeds: List[int],
    kick_seeds: List[int],
    device: torch.device,
    pop: Optional[int] = None,
    rounds: Optional[int] = None,
    max_sweeps: Optional[int] = None,
    certify: bool = True,
    post_workers: int = 1,
) -> dict:
    """Seed and run the tiered search of one case-stacked group of
    same-interval programs (one case is a group of one). Case k seeds
    its population with seeds[k] (on `post_workers` threads: each seed
    solves an LP) and draws its kicks from a generator seeded with
    kick_seeds[k]. A case stops at its certified LP bound only when
    `certify`. Returns the dict that `_block_and_account` reads."""
    pop, rounds, max_sweeps, patience = _budgets(pop, rounds, max_sweeps)
    with GLOBAL.phase("solve.tensors"):
        st = stack_cases(group, device)
    Vp = st.H.shape[-1]

    def _seed_one(k):
        x_ub_np = np.zeros(Vp, dtype=np.float32)
        x_ub_np[: group[k].num_vars] = group[k].x_ub
        return _seed_case(group[k], Vp, x_ub_np, pop, seeds[k])

    with GLOBAL.phase("solve.lp_bound"):
        with ThreadPoolExecutor(max_workers=post_workers) as pool:
            seeded = list(pool.map(_seed_one, range(len(group))))
    lbs = [lb for _, lb in seeded]
    targets = np.asarray(
        [
            max(float(certified_bound(p, lb)), 0.0) if (certify and lb is not None) else 0.0
            for p, lb in zip(group, lbs)
        ],
        dtype=np.float32,
    )
    moves, moves3 = _device_moves(group[0], device)
    with GLOBAL.phase("score"):
        best_x, best_s, sweeps, stagnant = batch_search(
            st,
            torch.as_tensor(np.stack([x for x, _ in seeded])).to(device),
            [torch.Generator().manual_seed(s) for s in kick_seeds],
            moves,
            moves3,
            torch.as_tensor(targets).to(device),
            rounds=rounds,
            max_sweeps=max_sweeps,
            patience=patience,
        )
    return {
        "lbs": lbs,
        "best_x": best_x,
        "best_s": best_s,
        "stagnant": stagnant,
        "targets": targets,
        "patience": patience,
        "sweeps": sweeps,
        "pop": pop,
        "Vp": Vp,
        "M": moves[0].shape[0],
        "M3": moves3[0].shape[0],
        "G": len(group),
    }


def _block_and_account(d: dict) -> np.ndarray:
    """Copy best_x [G, Vp] to the host, record the real
    candidates-scored count (a delta sweep evaluates 2*Vp moves per
    member, a paired-move sweep M, a triple sweep M3; a group sweeps all
    G cases) and the sweep counts, and resolve the per-case `converged`
    flags (stagnation exit or target met, vs round-budget starvation)
    the polish stage reads."""
    with GLOBAL.phase("score"):
        best = d["best_x"].cpu().numpy()
        stagnant = d["stagnant"].cpu().numpy()
        best_s = d["best_s"].cpu().numpy()
    n_d, n_m, n_3 = d["sweeps"]
    d["converged"] = (stagnant > d["patience"]) | (best_s <= d["targets"] + 1e-6)
    GLOBAL.count(
        "candidates_scored",
        float(d["G"] * d["pop"]) * (n_d * 2.0 * d["Vp"] + n_m * d["M"] + n_3 * d["M3"]),
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
    certify: bool = True,
    polish: bool = True,
    lns_budget: Optional[float] = None,
    converged: bool = True,
) -> SolveResult:
    """Host tail: measure the incumbent, polish (when `polish`) when it
    falls short of the certificate, certify (when `certify`), wrap.
    `lns_budget` caps the polish's wall clock (None:
    AMBIGRAM_LNS_BUDGET); batch callers divide one global budget across
    their cases.

    A CONVERGED incumbent is already a local optimum of the full tiered
    neighborhood, so it gets only the cheap LNS probe (escalating on
    improvement); a BUDGET-STARVED one, or one with a hard violation,
    goes straight to the full polish."""
    from ambigram_tpu_torch.solver.lns import default_lns_budget, lns_polish

    with GLOBAL.phase("solve.measure"):
        x_int = np.round(x).astype(np.int64)
        eps_sum = float(prog.residual_objective(x_int.astype(np.float64)))
        violation = float(prog.hard_violation(x_int.astype(np.float64)))
        tgt = certified_bound(prog, lb) if lb is not None else None
    if polish and (violation > 0.0 or (eps_sum > 0.0 and (tgt is None or eps_sum > tgt + 1e-6))):
        with GLOBAL.phase("solve.lns"):
            if violation > 0.0 or not converged:
                with GLOBAL.phase("solve.lns.full"):
                    x_p, eps_p, vio_p = lns_polish(prog, x_int, target=tgt, time_budget=lns_budget)
            else:
                GLOBAL.count("lns.probes")
                t0 = time.perf_counter()
                full = lns_budget if lns_budget is not None else default_lns_budget()
                with GLOBAL.phase("solve.lns.probe"):
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
                    GLOBAL.count("lns.escalations")
                    with GLOBAL.phase("solve.lns.full"):
                        x_f, eps_f, vio_f = lns_polish(prog, x_int, target=tgt, time_budget=left)
                    if (vio_f, eps_f) < (vio_p, eps_p):
                        x_p, eps_p, vio_p = x_f, eps_f, vio_f
        eps_before = eps_sum
        if (vio_p, eps_p) < (violation, eps_sum):
            x_int, eps_sum, violation = x_p, eps_p, vio_p
        GLOBAL.count("lns.eps_gain", eps_before - eps_sum)
    status = "heuristic"
    if violation == 0.0 and certify:
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


def solve_device_batch(
    progs: List[BfbProgram],
    seed: int = 0,
    pop: Optional[int] = None,
    rounds: Optional[int] = None,
    max_sweeps: Optional[int] = None,
    certify: bool = True,
    device="cuda",
    polish: bool = True,
    lns_budget: Optional[float] = None,
    post_workers: int = 4,
) -> List[SolveResult]:
    """Solve a list of fitting programs with the full tiered search in
    as few searches as possible: programs sharing one (start, end,
    num_vars) interval are case-stacked (`stack_cases`) and searched
    together by `batch_search`, so every sweep and rescoring covers the
    whole group. Groups are padded to a power of two by repeating their
    last program, as in the JAX package. The keyword arguments mean what
    they mean to `solve_device`. Returns [SolveResult] aligned with
    `progs`.

    Up to `MAX_INFLIGHT` (4, JAX's window) groups are in flight at once,
    largest first in JAX's order (-cases x variables): each is seeded,
    stacked and searched on a thread of its own and, on a card, on a
    CUDA stream of its own, so the host seeds the next groups while the
    card searches the first. The oldest group is drained first; as it
    retires the next one starts. Each finished group's per-case host
    tail (`_finish_solution`: LNS probe or polish, certificate) runs on
    a pool of `post_workers` threads; the seeding LPs of a group run on
    as many. A group's search depends only on its own cases and seeds,
    so every case's result is the one a window of 1 gives. As in the JAX
    package, case i seeds its population with seed + i; a group's k-th
    case draws its kicks from seed + k, a lone case from its own
    seed + i."""
    device = resolve_device(device)
    groups: dict = {}
    for i, prog in enumerate(progs):
        groups.setdefault((prog.start, prog.end, prog.num_vars), []).append(i)
    ordered = [idxs for _, idxs in sorted(groups.items(), key=lambda kv: -len(kv[1]) * kv[0][2])]

    def search_group(idxs: List[int]) -> dict:
        Gp = 1
        while Gp < len(idxs):
            Gp *= 2
        padded = idxs + [idxs[-1]] * (Gp - len(idxs))
        kick_seeds = [seed + i for i in idxs] if Gp == 1 else [seed + k for k in range(Gp)]
        with _group_stream(device):
            d = _dispatch(
                [progs[i] for i in padded],
                [seed + i for i in padded],
                kick_seeds,
                device,
                pop=pop,
                rounds=rounds,
                max_sweeps=max_sweeps,
                certify=certify,
                post_workers=post_workers,
            )
            # to the host on the group's own stream, before it is drained
            for key in ("best_x", "best_s", "stagnant"):
                d[key] = d[key].cpu()
        d["idxs"] = idxs
        return d

    results: List[Optional[SolveResult]] = [None] * len(progs)
    tails = []
    with ThreadPoolExecutor(max_workers=post_workers) as pool, ThreadPoolExecutor(
        max_workers=MAX_INFLIGHT
    ) as window:
        pending: List = []
        next_up = 0
        while next_up < len(ordered) or pending:
            while next_up < len(ordered) and len(pending) < MAX_INFLIGHT:
                pending.append(window.submit(search_group, ordered[next_up]))
                next_up += 1
            d = pending.pop(0).result()  # the oldest: furthest along
            best = _block_and_account(d)
            for k, i in enumerate(d["idxs"]):
                tails.append(
                    (
                        i,
                        pool.submit(
                            _finish_solution,
                            progs[i],
                            best[k, : progs[i].num_vars],
                            d["lbs"][k],
                            certify,
                            polish,
                            lns_budget,
                            bool(d["converged"][k]),
                        ),
                    )
                )
        for i, fut in tails:
            results[i] = fut.result()
    return results


@contextlib.contextmanager
def _group_stream(device: torch.device):
    """A CUDA stream of its own for one group's search on `device` (its
    thread's current stream while it runs); nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(torch.cuda.Stream(device)):
        yield
