"""Exact integer solver for the BFB fitting program.

Replaces the reference's out-of-process `cbc` invocation
(localhap.cpp:179-220) with an in-process exact mixed-integer solve.
The formulation mirrors BFB_ILP's variable layout
[patterns | loops | epsilons] so solutions are directly comparable:

    minimize  sum(e)            (the reported objective subtracts bias)
    s.t.      A x + e >= c ,  A x - e <= c      per residual row
              g_lb <= G x <= g_ub
              x integer in [0, x_ub], e >= 0

Primary engine: scipy's HiGHS MILP (in-process). The JAX device
solver (ambigram_tpu_torch.solver.search) is the performance path; this
module is the exactness anchor and the arbiter in tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ambigram_tpu_torch.engine.ilp import BfbProgram

try:
    from scipy.optimize import Bounds, LinearConstraint, milp

    _HAVE_MILP = True
except Exception:  # pragma: no cover
    _HAVE_MILP = False


@dataclass
class SolveResult:
    x: np.ndarray  # [2T] integer variable values (elementCN)
    epsilon_sum: float  # sum of absolute residuals
    objective: float  # epsilon_sum - bias (what cbc reports as objective value)
    status: str  # "optimal" | "infeasible" | "error"

    @property
    def element_cn(self) -> np.ndarray:
        return self.x


def have_exact_solver() -> bool:
    return _HAVE_MILP


def milp_lad(
    A_res: np.ndarray,
    c_res: np.ndarray,
    G: np.ndarray,
    g_lb: np.ndarray,
    g_ub: np.ndarray,
    x_ub: np.ndarray,
    time_limit: Optional[float] = None,
    relax: bool = False,
):
    """Solve the least-absolute-deviations MILP

        min sum_i |A_res[i] . x - c_res[i]|
        s.t. g_lb <= G x <= g_ub, 0 <= x <= x_ub, x integer

    via epsilon lifting (one epsilon per residual row, the reference's
    BFB_ILP shape). Returns the raw scipy result over [x | eps].
    Shared by the full-program `solve_exact` and the LNS window solves
    (ambigram_tpu_torch.solver.lns), whose restricted subproblems have
    exactly this form."""
    if not _HAVE_MILP:  # pragma: no cover
        raise RuntimeError("scipy HiGHS MILP unavailable")
    V = A_res.shape[1]
    E = A_res.shape[0]
    N = V + E

    # objective: minimize sum of epsilons
    c = np.zeros(N)
    c[V:] = 1.0

    M = G.shape[0]
    A_full = np.zeros((2 * E + M, N))
    lbs = np.empty(2 * E + M)
    ubs = np.empty(2 * E + M)
    A_full[0 : 2 * E : 2, :V] = A_res
    A_full[1 : 2 * E : 2, :V] = A_res
    eps_idx = V + np.arange(E)
    A_full[2 * np.arange(E), eps_idx] = 1.0
    A_full[2 * np.arange(E) + 1, eps_idx] = -1.0
    lbs[0 : 2 * E : 2] = c_res
    ubs[0 : 2 * E : 2] = np.inf
    lbs[1 : 2 * E : 2] = -np.inf
    ubs[1 : 2 * E : 2] = c_res
    if M:
        A_full[2 * E :, :V] = G
        lbs[2 * E :] = g_lb
        ubs[2 * E :] = g_ub

    constraints = LinearConstraint(A_full, lbs, ubs)
    integrality = np.zeros(N)
    if not relax:  # relax=True solves the LP relaxation (LNS screens)
        integrality[:V] = 1
    lb = np.zeros(N)
    ub = np.concatenate([x_ub, np.full(E, np.inf)])
    bounds = Bounds(lb, ub)
    options = {}
    if time_limit is not None:
        options["time_limit"] = time_limit
    return milp(
        c=c,
        constraints=constraints,
        integrality=integrality,
        bounds=bounds,
        options=options,
    )


def solve_on_face(
    prog: BfbProgram,
    eps_cap: float,
    weights: np.ndarray,
    time_limit: Optional[float] = None,
    forbidden_sets: Optional[list] = None,
) -> Optional[SolveResult]:
    """Find an integer point on (or below) the epsilon face
    `sum |A x - c| <= eps_cap` minimizing a SECONDARY objective
    `weights . x`. BFB optima are routinely non-unique, and some
    vertices of the optimal face replay into a BFB path while others do
    not (the shared-parent DAG rule is not span-monotone —
    engine/dag.py); sweeping secondary objectives samples distinct
    vertices so the pipeline can retry replay across the face instead
    of giving up after one solution (the reference prints nothing here,
    localhap.cpp:261).

    `forbidden_sets`: combinatorial CUTS — each entry is a list of
    variable indices that must not ALL be simultaneously positive.
    Used by the replay retry to cut the node set of a detected DAG
    cycle out of the next solve (indicator binaries z_v >= x_v/ub_v,
    cut sum z_v <= |set|-1), which excludes the whole family of
    solutions reproducing that cycle instead of just one point.

    Returns (result_or_None, reason) with reason in {"ok",
    "infeasible", "timeout", "error"} — the caller's cutting-plane loop
    must distinguish a PROVEN-empty face (relax the epsilon cap) from a
    budget miss (beyond help from more cuts at this budget)."""
    if not _HAVE_MILP:  # pragma: no cover
        return None, "error"
    V = prog.num_vars
    A_res, c_res = prog.residual_system()
    E = A_res.shape[0]
    forbidden_sets = [list(s) for s in (forbidden_sets or []) if len(s)]
    union_vars = sorted({v for s in forbidden_sets for v in s})
    zpos = {v: k for k, v in enumerate(union_vars)}
    Z = len(union_vars)
    N = V + E + Z
    c = np.zeros(N)
    c[:V] = weights
    M = prog.G.shape[0]
    # rows: residual lift pairs | hard rows | face row | z-link rows |
    # one cut row per forbidden set
    R = 2 * E + M + 1 + Z + len(forbidden_sets)
    A_full = np.zeros((R, N))
    lbs = np.empty(R)
    ubs = np.empty(R)
    A_full[0 : 2 * E : 2, :V] = A_res
    A_full[1 : 2 * E : 2, :V] = A_res
    eps_idx = V + np.arange(E)
    A_full[2 * np.arange(E), eps_idx] = 1.0
    A_full[2 * np.arange(E) + 1, eps_idx] = -1.0
    lbs[0 : 2 * E : 2] = c_res
    ubs[0 : 2 * E : 2] = np.inf
    lbs[1 : 2 * E : 2] = -np.inf
    ubs[1 : 2 * E : 2] = c_res
    if M:
        A_full[2 * E : 2 * E + M, :V] = prog.G
        lbs[2 * E : 2 * E + M] = prog.g_lb
        ubs[2 * E : 2 * E + M] = prog.g_ub
    r = 2 * E + M
    A_full[r, V : V + E] = 1.0  # sum of epsilons stays on the face
    lbs[r] = -np.inf
    ubs[r] = eps_cap + 1e-6
    r += 1
    for v in union_vars:  # x_v - ub_v z_v <= 0  (z_v = 1 iff x_v > 0)
        A_full[r, v] = 1.0
        A_full[r, V + E + zpos[v]] = -max(float(prog.x_ub[v]), 1.0)
        lbs[r] = -np.inf
        ubs[r] = 0.0
        r += 1
    for s in forbidden_sets:  # not all of this set positive at once
        for v in s:
            A_full[r, V + E + zpos[v]] = 1.0
        lbs[r] = -np.inf
        ubs[r] = len(s) - 1
        r += 1
    constraints = LinearConstraint(A_full, lbs, ubs)
    integrality = np.zeros(N)
    integrality[:V] = 1
    integrality[V + E :] = 1
    bounds = Bounds(
        np.zeros(N),
        np.concatenate([prog.x_ub, np.full(E, np.inf), np.ones(Z)]),
    )
    options = {}
    if time_limit is not None:
        options["time_limit"] = time_limit
    res = milp(
        c=c,
        constraints=constraints,
        integrality=integrality,
        bounds=bounds,
        options=options,
    )
    if res.status == 2:
        return None, "infeasible"  # PROVEN empty: cuts exhausted the face
    if res.x is None or res.status not in (0, 1):
        return None, "timeout" if res.status == 1 else "error"
    x = np.round(res.x[:V]).astype(np.int64)
    if float(prog.hard_violation(x.astype(np.float64))) != 0.0:
        return None, "timeout"  # fractional budget point, not usable
    eps_sum = float(prog.residual_objective(x.astype(np.float64)))
    if eps_sum > eps_cap + 1e-6:
        return None, "timeout"  # rounded off the face
    return (
        SolveResult(
            x=x,
            epsilon_sum=eps_sum,
            objective=eps_sum - prog.bias,
            status="optimal" if res.status == 0 else "heuristic",
        ),
        "ok",
    )


def solve_exact(prog: BfbProgram, time_limit: Optional[float] = None) -> SolveResult:
    V = prog.num_vars
    A_res, c_res = prog.residual_system()
    res = milp_lad(
        A_res, c_res, prog.G, prog.g_lb, prog.g_ub, prog.x_ub, time_limit
    )
    if res.status != 0 or res.x is None:
        if res.status == 1 and res.x is not None:
            # time/iteration limit with an integer-feasible incumbent:
            # return it as heuristic instead of discarding it — but only
            # if the rounded point actually satisfies the hard rows
            # (HiGHS may surface a fractional relaxation point here)
            x = np.round(res.x[:V]).astype(np.int64)
            if float(prog.hard_violation(x.astype(np.float64))) == 0.0:
                eps_sum = float(prog.residual_objective(x.astype(np.float64)))
                return SolveResult(
                    x=x,
                    epsilon_sum=eps_sum,
                    objective=eps_sum - prog.bias,
                    status="heuristic",
                )
            return SolveResult(
                x=np.zeros(V, dtype=np.int64),
                epsilon_sum=0.0,
                objective=0.0,
                status="error",
            )
        status = "infeasible" if res.status == 2 else "error"
        return SolveResult(
            x=np.zeros(V, dtype=np.int64),
            epsilon_sum=0.0,
            objective=0.0,
            status=status,
        )
    x = np.round(res.x[:V]).astype(np.int64)
    eps_sum = float(prog.residual_objective(x.astype(np.float64)))
    return SolveResult(
        x=x,
        epsilon_sum=eps_sum,
        objective=eps_sum - prog.bias,
        status="optimal",
    )
