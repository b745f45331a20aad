"""Native exact branch-and-bound front end.

Builds the unpadded unified row system (residual rows first, hard rows
after) and calls native/bnb_solver.cpp, warm-started from the device
search. Variable order: descending column impact so influential
variables are fixed early and the interval bounds tighten fast.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ambigram_tpu_torch.engine.ilp import BfbProgram
from ambigram_tpu_torch.solver.exact import SolveResult


def solve_native(
    prog: BfbProgram,
    warm: Optional[SolveResult] = None,
    node_cap: int = 20_000_000,
    time_limit_s: float = 0.0,
) -> Optional[SolveResult]:
    """Exact solve via the native B&B. Returns None when the native lib
    is unavailable; status 'heuristic' when the node or wall-clock
    budget was hit (time_limit_s <= 0 disables the clock)."""
    from ambigram_tpu_torch.native import native_bnb

    A_res, c_res = prog.residual_system()
    n_res = A_res.shape[0]
    big = 1e30
    if prog.G.shape[0]:
        H = np.concatenate([A_res, prog.G], axis=0)
        lb = np.concatenate([c_res, np.maximum(prog.g_lb, -big)])
        ub = np.concatenate([c_res, np.minimum(prog.g_ub, big)])
    else:
        H, lb, ub = A_res, c_res.copy(), c_res.copy()
    V = prog.num_vars
    x_ub = np.minimum(prog.x_ub, 2**30).astype(np.int64)
    impact = np.abs(H).sum(axis=0)
    order = np.argsort(-impact, kind="stable")
    warm_x = warm.x if warm is not None else None
    warm_eps = warm.epsilon_sum if warm is not None else 1e300
    out = native_bnb(
        H, lb, ub, n_res, x_ub, order, warm_x, warm_eps, node_cap, time_limit_s
    )
    if out is None:
        return None
    x, eps, proven, nodes = out
    if eps < 0:
        # no incumbent found: proven => truly infeasible; aborted on the
        # node budget => inconclusive ("error" so auto mode falls back)
        return SolveResult(
            x=np.zeros(V, dtype=np.int64),
            epsilon_sum=0.0,
            objective=0.0,
            status="infeasible" if proven else "error",
        )
    return SolveResult(
        x=x,
        epsilon_sum=eps,
        objective=eps - prog.bias,
        status="optimal" if proven else "heuristic",
    )
