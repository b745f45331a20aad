"""The `bfb` op, for one LH case and for a batch of cases, with the
port's device search.

Port of `_solve`, `run_bfb`, `run_bfb_many` and `solve_programs_batch`
(ambigram_tpu/engine/pipeline.py). The fitting programs come from the
JAX-free `extract_programs`; each non-trivial chromosome is solved here,
with the same routing as the JAX package; the path replay is the
JAX-free reference `run_bfb` handed the solutions as `presolved` (the
pattern the reference `run_bfb_many` uses).
"""

from __future__ import annotations

import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ambigram_tpu.engine.ilp import BfbProgram
from ambigram_tpu.engine.pipeline import (
    AUTO_EXACT_FIRST_MAX_VARS,
    BATCH_EXACT_PREPASS_MAX_VARS,
    BfbResult,
    _append_case_ledgers,
    _auto_post,
    _case_store_key,
    _per_case_lns_budget,
    _post_big_auto,
    _result_from_store,
    _result_to_store,
    extract_programs,
)
from ambigram_tpu.engine.pipeline import run_bfb as _replay_bfb
from ambigram_tpu.utils.profiling import GLOBAL


def _solve(prog: BfbProgram, solver: str, device, lns_budget: Optional[float] = None):
    """`exact` and `native` run the shared host solvers. `device` runs
    the port's search on `device`. `auto` settles programs of at most
    AUTO_EXACT_FIRST_MAX_VARS variables in the host MILP first and sends
    the rest (and any the MILP left open) to the port's search, followed
    by the shared auto tail `_auto_post`. `lns_budget` caps the search's
    LNS polish (None: AMBIGRAM_LNS_BUDGET)."""
    from ambigram_tpu.solver.exact import have_exact_solver, solve_exact
    from ambigram_tpu_torch.solver.search import solve_device

    if solver == "exact":
        with GLOBAL.phase("solve.exact"):
            return solve_exact(prog)
    if solver == "device":
        return solve_device(prog, device=device, lns_budget=lns_budget)
    if solver == "native":
        from ambigram_tpu.solver.native_bnb import solve_native

        with GLOBAL.phase("solve.native"):
            res = solve_native(prog)
        if res is None:
            raise RuntimeError("native B&B solver unavailable (no C++ toolchain)")
        return res
    if solver != "auto":
        raise ValueError("unknown solver %r" % solver)
    candidates = []
    if prog.num_vars <= AUTO_EXACT_FIRST_MAX_VARS and have_exact_solver():
        with GLOBAL.phase("solve.exact"):
            eres = solve_exact(prog, time_limit=60.0)
        if eres.status in ("optimal", "infeasible"):
            return eres
        candidates.append(eres)
    res = solve_device(prog, device=device, lns_budget=lns_budget)
    return _auto_post(prog, res, candidates, tried_exact=bool(candidates))


def run_bfb(
    lh_path: str,
    juncs_path: str = "",
    juncs_info: bool = False,
    is_reversed: bool = False,
    print_all: bool = False,
    solver: str = "auto",
    device="cuda",
    out=None,
    ledger_dir: Optional[str] = None,
    lp_prefix: str = "sample",
    emit_lp: bool = False,
) -> BfbResult:
    """Reconstruct the BFB path(s) of one LH case; `device` is where the
    search runs (a CUDA device without a card raises)."""
    from ambigram_tpu_torch.solver.search import resolve_device

    device = resolve_device(device)
    progs = extract_programs(lh_path, juncs_path, juncs_info)
    sols = []
    for prog in progs:
        if prog is None:
            sols.append(None)
            continue
        with GLOBAL.phase("solve"):
            sols.append(_solve(prog, solver, device))
    return _replay_bfb(
        lh_path,
        juncs_path=juncs_path,
        juncs_info=juncs_info,
        is_reversed=is_reversed,
        print_all=print_all,
        solver="exact",
        out=out,
        ledger_dir=ledger_dir,
        lp_prefix=lp_prefix,
        presolved=sols,
        emit_lp=emit_lp,
    )


def run_bfb_many(
    lh_paths: List[str],
    juncs_paths: Optional[List[str]] = None,
    juncs_info: bool = False,
    is_reversed: bool = False,
    solver: str = "auto",
    device="cuda",
    out=None,
    result_store: Optional[str] = None,
    ledger_dir: Optional[str] = None,
) -> List[BfbResult]:
    """Batch pipeline: every case's fitting programs are solved in one
    batch (`solve_programs_batch`), then each case's replay runs on a
    thread pool; its text reaches `out` in input order.

    `result_store` (a directory) makes the batch idempotent: a finished
    case writes `<name>-<content-hash>.json`, and a rerun skips every
    case whose file exists (returning a summary-only BfbResult for it).
    The files are the JAX package's, so either package resumes the
    other's store."""
    from ambigram_tpu_torch.solver.search import resolve_device

    device = resolve_device(device)
    juncs_paths = juncs_paths or [""] * len(lh_paths)
    cached: Dict[int, BfbResult] = {}
    store_keys: Dict[int, str] = {}
    if result_store:
        os.makedirs(result_store, exist_ok=True)
        for i, path in enumerate(lh_paths):
            store_keys[i] = _case_store_key(path)
            fn = os.path.join(result_store, store_keys[i] + ".json")
            if os.path.exists(fn):
                cached[i] = _result_from_store(fn)

    active = [i for i in range(len(lh_paths)) if i not in cached]
    per_case_progs = {i: extract_programs(lh_paths[i], juncs_paths[i], juncs_info) for i in active}
    flat: List[BfbProgram] = []
    index: List[tuple] = []
    for i in active:
        for n, prog in enumerate(per_case_progs[i]):
            if prog is not None:
                flat.append(prog)
                index.append((i, n))

    solutions = solve_programs_batch(flat, index, solver=solver, device=device)

    results: List[Optional[BfbResult]] = [None] * len(lh_paths)
    buffers: Dict[int, io.StringIO] = {}

    def _replay_case(i: int) -> None:
        presolved = [solutions.get((i, n)) for n in range(len(per_case_progs[i]))]
        buf = buffers[i] = io.StringIO()
        results[i] = _replay_bfb(
            lh_paths[i],
            juncs_path=juncs_paths[i],
            juncs_info=juncs_info,
            is_reversed=is_reversed,
            solver="exact",
            out=buf,
            presolved=presolved,
        )

    with ThreadPoolExecutor(max_workers=min(4, max(1, len(active)))) as pool:
        list(pool.map(_replay_case, active))
    for i, path in enumerate(lh_paths):
        if i in cached:
            results[i] = cached[i]
            continue
        if out is not None:
            out.write(buffers[i].getvalue())
        if ledger_dir is not None:
            _append_case_ledgers(results[i], path, juncs_paths[i], ledger_dir)
        if result_store:
            _result_to_store(os.path.join(result_store, store_keys[i] + ".json"), results[i])
    return results


def solve_programs_batch(
    flat: List[BfbProgram],
    index: List[tuple],
    solver: str = "auto",
    device="cuda",
) -> Dict[tuple, object]:
    """Solve a flat list of fitting programs with the batch policy of
    the JAX package on one device: the exact prepass (auto), then the
    device search, then the exact tail. Returns {index_key:
    SolveResult}.

    With one device the JAX policy sends every program to the device
    branch (its mid-size cut is 0 for a single case slot), so the
    stacked sharded pass (`_solve_stacked`) never runs and is not
    ported: more than one program goes through the case-stacked
    `solve_device_batch` and auto's per-case tail `_post_big_auto`, a
    single one through `_solve`."""
    solutions: Dict[tuple, object] = {}
    if flat and solver == "auto":
        # settle small and mid-size programs exactly on the host first,
        # threaded (HiGHS releases the GIL), on short budgets; what is
        # left open falls through to the device search
        from ambigram_tpu.solver.exact import have_exact_solver, solve_exact

        def _prepass(item):
            key, prog = item
            if not have_exact_solver() or prog.num_vars > AUTO_EXACT_FIRST_MAX_VARS:
                return key, prog, None
            budget = 5.0 if prog.num_vars <= BATCH_EXACT_PREPASS_MAX_VARS else 2.5
            return key, prog, solve_exact(prog, time_limit=budget)

        remaining: List[BfbProgram] = []
        remaining_index: List[tuple] = []
        # workers = cores: more concurrent HiGHS solves dilate each one's
        # wall clock past its own budget
        with ThreadPoolExecutor(max_workers=max(1, min(4, os.cpu_count() or 4))) as pool:
            for key, prog, eres in pool.map(_prepass, zip(index, flat)):
                if eres is not None and eres.status in ("optimal", "infeasible"):
                    solutions[key] = eres
                else:
                    remaining.append(prog)
                    remaining_index.append(key)
        flat, index = remaining, remaining_index
    if flat and solver in ("device", "auto"):
        from ambigram_tpu_torch.solver.search import solve_device_batch

        per_case_lns = _per_case_lns_budget(len(flat), min(4, len(flat)))
        if len(flat) > 1:
            # deep queue on one device: case-stack same-shape groups,
            # then auto's host tail per case
            res = solve_device_batch(flat, device=device, lns_budget=per_case_lns)
            for key, prog, r in zip(index, flat, res):
                solutions[key] = _post_big_auto(prog, r, solver)
        else:
            solutions[index[0]] = _solve(flat[0], solver, device, lns_budget=per_case_lns)
        flat, index = [], []
    if flat:
        from ambigram_tpu.solver.exact import solve_exact

        for key, prog in zip(index, flat):
            solutions[key] = solve_exact(prog)
    return solutions
