"""The `bfb` op for one LH case, with the port's device search.

Port of `_solve` and `run_bfb` (ambigram_tpu/engine/pipeline.py). The
fitting programs come from the JAX-free `extract_programs`; each
non-trivial chromosome is solved here, with the same routing as the JAX
package; the path replay is the JAX-free reference `run_bfb` handed the
solutions as `presolved` (the pattern `run_bfb_many` uses).
"""

from __future__ import annotations

from typing import Optional

from ambigram_tpu.engine.ilp import BfbProgram
from ambigram_tpu.engine.pipeline import (
    AUTO_EXACT_FIRST_MAX_VARS,
    BfbResult,
    _auto_post,
    extract_programs,
)
from ambigram_tpu.engine.pipeline import run_bfb as _replay_bfb
from ambigram_tpu.utils.profiling import GLOBAL


def _solve(prog: BfbProgram, solver: str, device):
    """`exact` and `native` run the shared host solvers. `device` runs
    the port's search on `device`. `auto` settles programs of at most
    AUTO_EXACT_FIRST_MAX_VARS variables in the host MILP first and sends
    the rest (and any the MILP left open) to the port's search, followed
    by the shared auto tail `_auto_post`."""
    from ambigram_tpu.solver.exact import have_exact_solver, solve_exact
    from ambigram_tpu_torch.solver.search import solve_device

    if solver == "exact":
        with GLOBAL.phase("solve.exact"):
            return solve_exact(prog)
    if solver == "device":
        return solve_device(prog, device=device)
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
    res = solve_device(prog, device=device)
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
