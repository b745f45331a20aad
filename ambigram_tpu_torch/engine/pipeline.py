"""The `bfb` op, for one LH case and for a batch of cases, with the
port's device search.

Port of ambigram_tpu/engine/pipeline.py. The host parts (the result
types, the case's build and path replay with its face retry, auto's
host tails `_auto_post`/`_post_big_auto`, the ledgers and the result
store) are copies that keep the original's meaning line for line.
Where the port differs:

- one builder and one replay: `build_case` parses a case and builds its
  fitting programs, `replay_case` replays its paths from their
  solutions, and `run_bfb` (build, `_solve` each program, replay) and
  `run_bfb_many` (build each case, one `solve_programs_batch`, replay
  each case) both go over the two; `extract_programs` is a view of the
  builder;
- `_solve`, `run_bfb`, `run_bfb_many` and `solve_programs_batch` take a
  torch `device` and run the port's search (solver/search.py) there;
  a CUDA device without a card raises;
- `run_bfb_many` and `solve_programs_batch` take JAX's `mesh` as well
  (a `parallel.mesh.Mesh` of torch devices). `mesh=None` is the (1, 1)
  mesh of `device`, not every visible card as in JAX: on a host with
  several cards that is still the one-card route, because the 16-case
  batch took 34.1 s over four NVIDIA H100s against 18.3 s on one
  (PERF.md); the multi-card route is `mesh=make_mesh()`.
"""

from __future__ import annotations

import io as _io
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from ambigram_tpu_torch.engine.components import read_components
from ambigram_tpu_torch.engine.dag import construct_dag
from ambigram_tpu_torch.engine.enumerate import sorted_key_order
from ambigram_tpu_torch.engine.ilp import BfbProgram, build_bfb_program
from ambigram_tpu_torch.engine.indel import get_indel_bias, indel_bfb
from ambigram_tpu_torch.engine.junccn import fbi_bias, get_junc_cn
from ambigram_tpu_torch.engine.path import format_bfb, replay_bfb
from ambigram_tpu_torch.engine.props import BfbProps, parse_bfb_props
from ambigram_tpu_torch.model.genome import Genome, Junction, Segment, VertexPath
from ambigram_tpu_torch.utils.profiling import GLOBAL


@dataclass
class ChromosomeResult:
    start: int
    end: int
    path: VertexPath
    path_string: str
    element_cn: Optional[np.ndarray] = None
    objective: float = 0.0
    trivial: bool = False
    infeasible: bool = False
    # False when the solution used for path reconstruction is a feasible
    # incumbent whose optimality no stage proved (time-boxed solves).
    certified: bool = True


@dataclass
class BfbResult:
    paths: List[VertexPath] = field(default_factory=list)
    chromosomes: List[ChromosomeResult] = field(default_factory=list)
    path_strings: List[str] = field(default_factory=list)
    merged_path: Optional[VertexPath] = None
    merged_path_string: str = ""
    target_cn: List[int] = field(default_factory=list)
    ilp_error: float = 0.0
    num_inversions: int = 0
    is_resolved: bool = True
    seconds: float = 0.0
    output_juncs: List[Junction] = field(default_factory=list)
    genome: Optional[Genome] = None


# Auto-solver size split: programs at or under this many variables go to
# the in-process MILP first (closes in well under a second up to ~2k vars
# on one core); larger ones start with the batched device search whose
# incumbent and LP certificate prune the exact stages.
AUTO_EXACT_FIRST_MAX_VARS = 2048

# Batch pre-pass split for run_bfb_many: programs at or under this many
# variables are settled exactly on host (≤~0.25s each) before the single
# device-sharded pass, so all-small batches never pay a search compile.
BATCH_EXACT_PREPASS_MAX_VARS = 512


def _per_case_lns_budget(n_cases: int, workers: int) -> float:
    """One global LNS wall-clock budget for a batch: cases run `workers`
    at a time, so per-case budget = total divided by the number of
    serial waves — total LNS wall-clock stays ~AMBIGRAM_LNS_BUDGET
    regardless of batch size (a flat per-case floor would grow linearly
    with the batch)."""
    import math

    from ambigram_tpu_torch.solver.lns import default_lns_budget

    return max(1.0, default_lns_budget() / math.ceil(max(1, n_cases) / max(1, workers)))


def _solve(prog: BfbProgram, solver: str, device, lns_budget: Optional[float] = None):
    """`exact` and `native` run the host solvers. `device` runs the
    port's search on `device`. `auto` settles programs of at most
    AUTO_EXACT_FIRST_MAX_VARS variables in the host MILP first and sends
    the rest (and any the MILP left open) to the port's search, followed
    by auto's host tail `_auto_post`. `lns_budget` caps the search's
    LNS polish (None: AMBIGRAM_LNS_BUDGET)."""
    from ambigram_tpu_torch.solver.exact import have_exact_solver, solve_exact
    from ambigram_tpu_torch.solver.search import solve_device

    if solver == "exact":
        with GLOBAL.phase("solve.exact"):
            return solve_exact(prog)
    if solver == "device":
        return solve_device(prog, device=device, lns_budget=lns_budget)
    if solver == "native":
        from ambigram_tpu_torch.solver.native_bnb import solve_native

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


def _auto_post(
    prog: BfbProgram,
    res,
    candidates: Optional[list] = None,
    tried_exact: bool = False,
):
    """Auto mode's host tail after a device search result `res`:
    warm-started native B&B polish (skipped where measured useless),
    last-resort exact MILP when nothing feasible exists, best-feasible
    selection. Shared by `_solve` and the batched device path
    (`solve_programs_batch` over `solve_device_batch` results).
    `tried_exact`: a budgeted solve_exact already ran for this program
    upstream — re-running the identical solve as the last resort would
    burn another full budget for no new information."""
    from ambigram_tpu_torch.solver.exact import have_exact_solver, solve_exact
    from ambigram_tpu_torch.solver.native_bnb import solve_native

    candidates = list(candidates or [])
    if res.status == "optimal":
        return res
    candidates.append(res)
    # warm-started native B&B polish: pays off on small/mid programs;
    # at V > 2048 it was measured to never improve the search incumbent
    # within its budget (S=48/64 noisy suites: identical eps, 12-18s
    # spent), so skip it there when the incumbent is already feasible
    large = prog.num_vars > AUTO_EXACT_FIRST_MAX_VARS
    res_feasible = res.status == "heuristic" and float(
        prog.hard_violation(res.x.astype(np.float64))
    ) == 0.0
    if not (large and res_feasible):
        with GLOBAL.phase("solve.native"):
            nres = solve_native(prog, warm=res, time_limit_s=10.0)
        if nres is not None:
            if nres.status in ("optimal", "infeasible"):
                return nres
            candidates.append(nres)

    def _feasible(pool):
        return [
            c
            for c in pool
            if c.status == "heuristic"
            and float(prog.hard_violation(c.x.astype(np.float64))) == 0.0
        ]

    feasible = _feasible(candidates)
    if not feasible and not tried_exact and have_exact_solver():
        # last resort for ANY size when nothing feasible exists: at
        # large V the MILP rarely betters the search incumbent within
        # any budget (see measurements above), but an infeasible pool
        # means no answer at all — and small programs reach here too
        # when a batch routed them around the exact-first stage
        with GLOBAL.phase("solve.exact"):
            eres = solve_exact(prog, time_limit=60.0)
        if eres.status in ("optimal", "infeasible"):
            return eres
        candidates.append(eres)
        feasible = _feasible(candidates)
    if feasible:
        return min(feasible, key=lambda c: c.epsilon_sum)
    return candidates[0]


@dataclass
class ChromosomeBuild:
    """One chromosome of a built case: its segment interval, its
    fold-back inversions (in a single-cell sample, one dict a clone)
    and its fitting program (None where the chromosome is trivial)."""

    start: int
    end: int
    inversions: Union[Dict[int, Junction], List[Dict[int, Junction]]]
    program: Optional[BfbProgram]


@dataclass
class CaseBuild:
    """One case as `build_case` (or, for a single-cell sample,
    sc.build_sc_sample) leaves it for its solve and replay: its genomes
    (one a clone), its props, the TRX modes' segment map and unused SVs,
    its chromosomes; `seconds` is the build's host time."""

    genomes: List[Genome]
    props: BfbProps
    chromosomes: List[ChromosomeBuild]
    original_segs: Dict[Segment, Segment] = field(default_factory=dict)
    unused_sv: List[Junction] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def programs(self) -> List[Optional[BfbProgram]]:
        return [c.program for c in self.chromosomes]


def build_case(lh_path: str, juncs_path: str = "", juncs_info: bool = False) -> CaseBuild:
    """Everything `run_bfb` does before its solve: parse the case, apply
    its insertion or concatenation mode, read its long-read components,
    then chromosome by chromosome tabulate the junction CNs, apply the
    indel bias and build the fitting program of each non-trivial one."""
    begin = time.perf_counter()
    with GLOBAL.phase("parse"):
        g = Genome.from_lh(lh_path)
        g.calculate_hap_depth()
        g.calculate_copy_num()

    props = parse_bfb_props(lh_path)
    original_segs: Dict[Segment, Segment] = {}
    unused_sv: List[Junction] = []
    if props.ins_mode == 1:
        from ambigram_tpu_torch.engine.trx import insert_before_bfb

        g = insert_before_bfb(g, props.ins_chr, original_segs, unused_sv)
    elif props.con_mode == 1:
        from ambigram_tpu_torch.engine.trx import concat_before_bfb

        g = concat_before_bfb(g, props.con_chr, original_segs, unused_sv)

    sources = list(g.sources)
    sinks = list(g.sinks)
    for i, (src, snk) in enumerate(zip(sources, sinks)):
        for seg_id in range(src.id, snk.id + 1):
            g.segment_by_id(seg_id).partition = i

    components = read_components(g, original_segs, juncs_path)

    chromosomes: List[ChromosomeBuild] = []
    for n in range(len(sinks)):
        start_id = sources[n].id
        end_id = sinks[n].id

        inversions, junc_cn = get_junc_cn(g, start_id, end_id)
        bias = fbi_bias(inversions, junc_cn, start_id, end_id)
        get_indel_bias(g, start_id, end_id)

        inversion_cn_sum = float(junc_cn[: end_id + 1, 1].sum())
        valid_components = [
            c for c in components if g.segment_by_id(c[0]).partition == n
        ]
        prog = None
        if abs(inversion_cn_sum) >= 1e-6 or valid_components:
            seg_cn = np.array(
                [g.segment_by_id(i).weight.copy_num for i in range(start_id, end_id + 1)]
            )
            fbi_cn = junc_cn[start_id : end_id + 1, 1].copy()
            max_cn = sum(s.weight.copy_num for s in g.segments)
            with GLOBAL.phase("program_build"):
                prog = build_bfb_program(
                    start_id,
                    end_id,
                    seg_cn,
                    fbi_cn,
                    max_cn,
                    bias,
                    components=valid_components,
                    juncs_info=juncs_info,
                )
        chromosomes.append(ChromosomeBuild(start_id, end_id, inversions, prog))
    return CaseBuild([g], props, chromosomes, original_segs, unused_sv, time.perf_counter() - begin)


def solve_each(
    programs: List[Optional[BfbProgram]],
    solver: str,
    device,
    emit_lp: bool = False,
    lp_prefix: str = "sample",
) -> List[Optional[object]]:
    """One case's solutions: each program solved by `_solve` under the
    `solve` phase, None where the chromosome is trivial. With `emit_lp`
    each program is first written to `<lp_prefix>.lp` / `.mps`, as the
    reference writes one for every solve (LGM.cpp:4749-4750 and
    5091-5092, overwritten per chromosome); here the artifact is opt-in
    since no external solver is invoked: it exists for differential
    checking."""
    solutions: List[Optional[object]] = []
    for prog in programs:
        if prog is None:
            solutions.append(None)
            continue
        if emit_lp:
            from ambigram_tpu_torch.io.program_io import write_lp, write_mps

            write_lp(prog, lp_prefix + ".lp")
            write_mps(prog, lp_prefix + ".mps")
        with GLOBAL.phase("solve"):
            solutions.append(_solve(prog, solver, device))
    return solutions


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
    """Reconstruct the BFB path(s) of one LH case: `build_case`, then
    `_solve` on each non-trivial chromosome's program with the search on
    `device` (a CUDA device without a card raises), then `replay_case`."""
    from ambigram_tpu_torch.solver.search import resolve_device

    device = resolve_device(device)
    begin = time.perf_counter()
    if out is None:
        out = _io.StringIO()
    case = build_case(lh_path, juncs_path, juncs_info)
    solutions = solve_each(case.programs, solver, device, emit_lp, lp_prefix)
    result = replay_case(case, solutions, out, is_reversed, print_all)
    result.seconds = time.perf_counter() - begin
    if ledger_dir is not None:
        _append_ledgers(result, lh_path, juncs_path, ledger_dir)
    return result


def replay_case(
    case: CaseBuild,
    solutions: List[Optional[object]],
    out,
    is_reversed: bool = False,
    print_all: bool = False,
) -> BfbResult:
    """Everything `run_bfb` does after its solve: each chromosome's path
    replayed from its solution (`solutions[n]`, None where the
    chromosome is trivial) and written to `out`, then the case's target
    CN, output junctions, translocation merge and resolved check. The
    caller sets `seconds`."""
    g, props = case.genomes[0], case.props
    result = BfbResult(genome=g)
    result.target_cn = [0] * len(g.segments)
    result.num_inversions = sum(len(c.inversions) for c in case.chromosomes)

    for chrom, sol in zip(case.chromosomes, solutions):
        start_id, end_id, inversions, prog = chrom.start, chrom.end, chrom.inversions, chrom.program
        if prog is not None and sol.status == "heuristic" and float(
            prog.hard_violation(sol.x.astype(np.float64))
        ) != 0.0:
            # a "heuristic" incumbent must satisfy the hard constraints
            # to be usable for path reconstruction; demote otherwise
            sol.status = "error"
        if prog is None or sol.status not in ("optimal", "heuristic"):
            path = [g.segment_by_id(i).pos for i in range(start_id, end_id + 1)]
            out.write(format_bfb(path) + "\n")
            if prog is not None:
                out.write("ILP is unsolvable.\n")
            result.paths.append(path)
            result.chromosomes.append(
                ChromosomeResult(
                    start=start_id,
                    end=end_id,
                    path=path,
                    path_string=format_bfb(path),
                    trivial=True,
                    infeasible=prog is not None,
                )
            )
            continue
        element_cn = sol.x
        pairs = prog.pairs
        T = len(pairs)
        entries = sorted_key_order(pairs)
        with GLOBAL.phase("replay"):
            adj, node2pat, node2loop = construct_dag(entries, element_cn)
            path: VertexPath = replay_bfb(
                g,
                adj,
                node2pat,
                node2loop,
                inversions,
                is_reversed=is_reversed,
                print_all=print_all,
                out=out,
            )
        if not path and np.any(element_cn > 0):
            # the solution exists but no topological order of its
            # structure replays (cyclic graph from the shared-parent
            # rule, or an exhausted order budget). BFB optima are
            # routinely non-unique — sweep SECONDARY objectives over the
            # equal-or-better epsilon face (solver.exact.solve_on_face)
            # until a vertex replays or the sweep budget runs out. The
            # reference has no such retry (it just prints nothing,
            # localhap.cpp:261); goldens are unaffected because their
            # first solution replays. Every accepted alternate has
            # epsilon_sum <= the incumbent's, so ilp_error/target_cn
            # never silently inflate.
            sol2, element_cn2, path2 = _retry_replay_on_face(
                prog,
                sol,
                element_cn,
                entries,
                g,
                inversions,
                is_reversed,
                print_all,
                out,
            )
            if path2:
                sol, element_cn, path = sol2, element_cn2, path2
        result.ilp_error += sol.objective

        # target CN accumulation (localhap.cpp:222-232)
        for t in range(T):
            i1, i2 = int(pairs[t][0]), int(pairs[t][1])
            if element_cn[t] > 0:
                for k in range(i1 - 1, i2):
                    result.target_cn[k] += int(element_cn[t])
            if element_cn[T + t] > 0:
                for k in range(i1 - 1, i2):
                    result.target_cn[k] += int(element_cn[T + t]) * 2
        indel_bfb(g, path, start_id, end_id, out=out)
        if props.ins_mode == 1 or props.con_mode == 1:
            from ambigram_tpu_torch.engine.trx import virus_bfb

            virus_bfb(g, path, case.original_segs, case.unused_sv, out=out)
        result.paths.append(path)
        result.chromosomes.append(
            ChromosomeResult(
                start=start_id,
                end=end_id,
                path=path,
                path_string=format_bfb(path),
                element_cn=element_cn,
                objective=sol.objective,
                certified=sol.status == "optimal",
            )
        )

    # output junction derivation (localhap.cpp:267-289)
    output_juncs: List[Junction] = []
    for p in result.paths:
        for i in range(len(p) - 1):
            u, v = p[i], p[i + 1]
            if not (abs(u.id - v.id) == 1 and u.dir == v.dir):
                has_junc = False
                for j in output_juncs:
                    a, b = j.edge_a, j.edge_b
                    if (a.source is u and a.target is v) or (
                        b.source is u and b.target is v
                    ):
                        has_junc = True
                        j.weight.copy_num += 1
                if not has_junc:
                    output_juncs.append(
                        Junction(u.seg, v.seg, u.dir, v.dir, 30, 1, 1, True, False, False)
                    )

    # post-BFB translocation merging (localhap.cpp:296-316)
    if props.ins_mode == 2 or props.con_mode == 2:
        from ambigram_tpu_torch.engine.trx import translocation_bfb

        res_path: VertexPath = []
        translocation_bfb(g, result.paths, res_path, props.main_chr, out=out)
        result.merged_path = res_path
        result.merged_path_string = format_bfb(res_path)
        for i in range(len(res_path) - 1):
            u, v = res_path[i], res_path[i + 1]
            if not (abs(u.id - v.id) == 1 and u.dir == v.dir):
                has_junc = False
                for j in output_juncs:
                    a, b = j.edge_a, j.edge_b
                    if (a.source is u and a.target is v) or (
                        b.source is u and b.target is v
                    ):
                        has_junc = True
                if not has_junc:
                    output_juncs.append(
                        Junction(u.seg, v.seg, u.dir, v.dir, 30, 1, 1, True, False, False)
                    )
    result.output_juncs = output_juncs

    # resolved check (localhap.cpp:318-324)
    if result.ilp_error < 0.1:
        error = 0
        for k, seg in enumerate(g.segments):
            # reference accumulates abs(double diff) into an int, which
            # truncates toward zero (localhap.cpp:320-322)
            error += int(abs(seg.weight.copy_num - result.target_cn[k]))
        if error > len(g.segments):
            result.is_resolved = False

    result.path_strings = [c.path_string for c in result.chromosomes]
    return result


def _retry_replay_on_face(
    prog,
    sol,
    element_cn,
    entries,
    g,
    inversions,
    is_reversed,
    print_all,
    out,
):
    """Replay-retry sweep over the epsilon face at the incumbent's
    objective (VERDICT r4 #4). Attempts, in order: the plain re-solve
    (often lands elsewhere already), sparsest structure (min Σx — fewer
    DAG nodes, simpler orders), densest (max Σx), then seeded random
    secondary objectives. Distinct solutions only; first replayable
    vertex wins. Returns (sol, element_cn, path) — path is [] when the
    whole sweep fails, and a per-case log line records how many face
    vertices were tried so a persistent no-path is auditable
    (AMBIGRAM_FACE_RETRIES caps the sweep, default 6)."""
    from ambigram_tpu_torch.engine.dag import find_cycle
    from ambigram_tpu_torch.engine.enumerate import pair_index
    from ambigram_tpu_torch.engine.path import direct_splice_replay
    from ambigram_tpu_torch.solver.exact import have_exact_solver, solve_on_face

    # step 0 FIRST — the direct replay is pure Python and needs no MILP
    # solver, so a host without scipy still recovers the cases the
    # reference cannot (the face machinery below does need the solver)
    with GLOBAL.phase("replay"):
        path0 = direct_splice_replay(
            g,
            prog.pairs,
            element_cn,
            inversions,
            is_reversed=is_reversed,
            out=out,
        )
    if path0:
        return sol, element_cn, path0
    if not have_exact_solver():
        return sol, element_cn, []
    n_retries = int(os.environ.get("AMBIGRAM_FACE_RETRIES", 6))
    per_solve = float(os.environ.get("AMBIGRAM_FACE_SOLVE_SECONDS", 10.0))
    eps_cap = float(prog.residual_objective(element_cn.astype(np.float64)))
    V = prog.num_vars
    T = len(prog.pairs)

    def cycle_cut(adj, n2p, n2l):
        """Variable-index set of one directed cycle, [] when acyclic."""
        nodes = find_cycle(adj)
        cut = set()
        for k in nodes:
            # a node can carry both payloads (the node2loop sort quirk);
            # include both — a slightly stronger cut is still sound for
            # a retry heuristic
            if n2p[k]:
                cut.add(pair_index(prog.start, prog.end, n2p[k][0], n2p[k][1]))
            if n2l[k]:
                cut.add(
                    T + pair_index(prog.start, prog.end, n2l[k][0], n2l[k][1])
                )
        return sorted(cut)

    # cutting-plane loop: every CYCLIC solution contributes a cycle cut
    # (excluding the whole family of solutions reproducing that cycle).
    # Cut faces are attacked LOCALLY first — cut_repair (solver.lns)
    # re-solves only the endpoint-neighborhood + cut variables with the
    # cuts as indicator constraints, closing in seconds where the
    # full-program face MILP finds nothing in its whole budget on hard
    # noisy instances. The global face solve remains the opener (cheap
    # when optima are plentiful) and the acyclic-diversification tool.
    # A repair may cost epsilon (bounded below); the accepted alternate
    # reports its own objective, so quality loss is visible, never
    # silent.
    from ambigram_tpu_torch.solver.exact import SolveResult
    from ambigram_tpu_torch.solver.lns import cut_repair

    cuts: List[List[int]] = []
    adj0, n2p0, n2l0 = construct_dag(entries, element_cn)
    first_cut = cycle_cut(adj0, n2p0, n2l0)
    if first_cut:
        cuts.append(first_cut)
    rng = np.random.default_rng(0)
    # repaired structures may fit worse than the unreplayable optimum;
    # tolerate a bounded degradation (5% + one CN unit) — a replayable
    # near-optimum beats printing nothing (the reference's outcome)
    eps_accept = eps_cap * 1.05 + 1.0
    tried = {element_cn.tobytes()}
    attempts = 0
    global_weights = [np.zeros(V), np.ones(V)]
    while attempts < n_retries:
        attempts += 1
        alt = None
        if cuts:
            with GLOBAL.phase("solve"):
                x_rep = cut_repair(prog, element_cn, cuts, time_limit=per_solve / 3.0)
            if x_rep is not None and x_rep.tobytes() not in tried:
                eps_rep = float(prog.residual_objective(x_rep.astype(np.float64)))
                if eps_rep <= eps_accept:
                    alt = SolveResult(
                        x=x_rep,
                        epsilon_sum=eps_rep,
                        objective=eps_rep - prog.bias,
                        status="heuristic",
                    )
        if alt is None:
            # no cuts yet (acyclic-but-unreplayable), or the local
            # repair failed: one global face solve, varied objectives
            w = (
                global_weights.pop(0)
                if global_weights
                else rng.integers(-8, 9, size=V).astype(np.float64)
            )
            with GLOBAL.phase("solve"):
                alt, reason = solve_on_face(
                    prog, eps_cap, w, time_limit=per_solve, forbidden_sets=cuts
                )
            if alt is None:
                if reason == "infeasible" and cuts and eps_cap < eps_accept:
                    eps_cap = min(eps_cap * 1.05 + 1.0, eps_accept)
                    continue  # cuts exhausted the face: relax a step
                # a face proven empty AT the acceptance ceiling cannot
                # become feasible under different secondary weights —
                # stop instead of re-proving it each remaining attempt
                break  # or timeout/error: this budget won't crack it
        if alt.x.tobytes() in tried:
            continue
        tried.add(alt.x.tobytes())
        adj2, n2p2, n2l2 = construct_dag(entries, alt.x)
        cut = cycle_cut(adj2, n2p2, n2l2)
        if cut:
            # cyclic alternate: direct span-ordered replay first, cut
            # only if that fails too
            with GLOBAL.phase("replay"):
                path2 = direct_splice_replay(
                    g,
                    prog.pairs,
                    alt.x,
                    inversions,
                    is_reversed=is_reversed,
                    out=out,
                )
            if path2:
                return alt, alt.x, path2
            cuts.append(cut)
            continue  # cyclic again: cut it out and re-solve
        with GLOBAL.phase("replay"):
            path2: VertexPath = replay_bfb(
                g,
                adj2,
                n2p2,
                n2l2,
                inversions,
                is_reversed=is_reversed,
                print_all=print_all,
                out=out,
            )
        if path2:
            return alt, alt.x, path2
    from ambigram_tpu_torch.native import _warn_budget

    _warn_budget(
        "no vertex of the eps<=%.4f face replayed into a BFB path "
        "(%d distinct solutions, %d cycle cuts, %d face solves)"
        % (eps_cap, len(tried) - 1, len(cuts), attempts)
    )
    return sol, element_cn, []


def extract_programs(
    lh_path: str, juncs_path: str = "", juncs_info: bool = False
) -> List[Optional[BfbProgram]]:
    """Per-chromosome fitting programs for one case (None where the
    chromosome is trivial): `build_case`'s."""
    return build_case(lh_path, juncs_path, juncs_info).programs


def batch_programs(programs: Dict[int, List[Optional[BfbProgram]]]):
    """The flat program list of a batch and its (case, chromosome) keys,
    for `solve_programs_batch`, from each case's programs."""
    index = [(i, n) for i, progs in programs.items() for n, prog in enumerate(progs) if prog is not None]
    return [programs[i][n] for i, n in index], index


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
    mesh=None,
) -> List[BfbResult]:
    """Batch pipeline: each case is built once (`build_case`), every
    fitting program is solved in one call of `solve_programs_batch` (on
    `mesh`, by default the one device `device`), then each case is
    replayed (`replay_case`) on a thread pool; its text reaches `out` in
    input order. A case's `seconds` is its build and replay time.

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
    builds = {i: build_case(lh_paths[i], juncs_paths[i], juncs_info) for i in active}
    flat, index = batch_programs({i: case.programs for i, case in builds.items()})
    solutions = solve_programs_batch(flat, index, solver=solver, device=device, mesh=mesh)

    results: List[Optional[BfbResult]] = [None] * len(lh_paths)
    buffers: Dict[int, _io.StringIO] = {}

    def _replay_case(i: int) -> None:
        begin = time.perf_counter()
        case = builds[i]
        buf = buffers[i] = _io.StringIO()
        results[i] = replay_case(
            case, [solutions.get((i, n)) for n in range(len(case.chromosomes))], buf, is_reversed
        )
        results[i].seconds = case.seconds + time.perf_counter() - begin

    with ThreadPoolExecutor(max_workers=min(4, max(1, len(active)))) as pool:
        list(pool.map(_replay_case, active))
    for i, path in enumerate(lh_paths):
        if i in cached:
            results[i] = cached[i]
            continue
        if out is not None:
            out.write(buffers[i].getvalue())
        if ledger_dir is not None:
            _append_ledgers(results[i], path, juncs_paths[i], ledger_dir)
        if result_store:
            _result_to_store(os.path.join(result_store, store_keys[i] + ".json"), results[i])
    return results


def solve_programs_batch(
    flat: List[BfbProgram],
    index: List[tuple],
    solver: str = "auto",
    device="cuda",
    mesh=None,
) -> Dict[tuple, object]:
    """Solve a flat list of fitting programs with the batch policy of
    the JAX package: exact prepass for small programs (auto), per-case
    device searches for large ones (round-robin over the mesh's devices,
    threaded) or one case-stacked leg per device when the queue is deep,
    one stacked case-sharded pass (`_solve_stacked`) for the mid-size
    rest when the mesh has more than one case slot, then the exact tail.
    Returns {index_key: SolveResult}.

    `mesh=None` is the (1, 1) mesh of `device`. With one case slot the
    mid-size cut is 0, so `_solve_stacked` never runs: more than one
    program goes through the case-stacked `solve_device_batch` (8
    host-tail threads) and auto's per-case tail `_post_big_auto`, a
    single one through `_solve` (auto) or `solve_device`.

    Shared by `run_bfb_many` (bulk cases) and `run_sc_bfb_many`
    (single-cell samples, engine/sc.py)."""
    solutions: Dict[tuple, object] = {}
    if flat and solver == "auto":
        # settle small and mid-size programs exactly on the host first,
        # threaded (HiGHS releases the GIL), on short budgets; what is
        # left open falls through to the device search
        from ambigram_tpu_torch.solver.exact import have_exact_solver, solve_exact

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
        # programs above the mid-size cut search per case (the dense-move
        # sharded step is memory-hostile there); with a single case slot
        # everything does, since the stacked greedy step buys nothing
        # without case parallelism. The stacked pass is submitted to the
        # pool first, so it runs while the big cases search.
        from ambigram_tpu_torch.parallel.mesh import make_mesh
        from ambigram_tpu_torch.solver.search import resolve_device, solve_device, solve_device_batch

        if mesh is None:
            mesh = make_mesh(devices=[resolve_device(device)])
        n_case_slots = mesh.shape[0]
        big_cut = AUTO_EXACT_FIRST_MAX_VARS if n_case_slots > 1 else 0
        big = [(key, prog) for key, prog in zip(index, flat) if prog.num_vars > big_cut]
        rest = [(key, prog) for key, prog in zip(index, flat) if prog.num_vars <= big_cut]
        devices = mesh.flat()
        workers = min(4, len(big)) if big else 0
        per_case_lns = _per_case_lns_budget(len(big), max(workers, 1))

        if len(big) > 1 and (len(devices) == 1 or len(big) > 2 * len(devices)):
            # deep queue: case-stack same-shape groups into one search per
            # device leg (round-robin split), then auto's host tail per
            # case; each leg's thread runs max(2, 8 // legs) tail threads
            n_legs = min(len(devices), len(big))
            chunks = [big[k::n_legs] for k in range(n_legs)]
            leg_post_workers = max(2, 8 // n_legs)

            def _stacked_leg(leg_idx):
                items = chunks[leg_idx]
                res_leg = solve_device_batch(
                    [prog for _, prog in items],
                    device=devices[leg_idx],
                    lns_budget=per_case_lns,
                    post_workers=leg_post_workers,
                )
                return [(key, _post_big_auto(prog, res, solver)) for (key, prog), res in zip(items, res_leg)]

            with ThreadPoolExecutor(max_workers=n_legs + (1 if rest else 0)) as pool:
                stack_fut = pool.submit(_solve_stacked, rest, solver, mesh) if rest else None
                for leg in pool.map(_stacked_leg, range(n_legs)):
                    for key, sol in leg:
                        solutions[key] = sol
                if stack_fut is not None:
                    solutions.update(stack_fut.result())
        else:
            # per-case searches, round-robin over the mesh's devices on a
            # thread pool: case i's host work (LP seeding, LNS) overlaps
            # case j's search; each case's seeds are fixed, so the results
            # do not depend on the interleaving
            def _solve_big(item):
                k, (key, prog) = item
                dev = devices[k % len(devices)]
                if solver == "auto":
                    return key, _solve(prog, "auto", dev, lns_budget=per_case_lns)
                return key, solve_device(prog, device=dev, lns_budget=per_case_lns)

            with ThreadPoolExecutor(max_workers=max(workers, 1) + (1 if rest else 0)) as pool:
                stack_fut = pool.submit(_solve_stacked, rest, solver, mesh) if rest else None
                if big:
                    for key, sol in pool.map(_solve_big, enumerate(big)):
                        solutions[key] = sol
                if stack_fut is not None:
                    solutions.update(stack_fut.result())
        flat, index = [], []
    if flat:
        from ambigram_tpu_torch.solver.exact import solve_exact

        for key, prog in zip(index, flat):
            solutions[key] = solve_exact(prog)
    return solutions


def _post_big_auto(prog: BfbProgram, res, solver: str):
    """Auto's host tail for one case-stacked search result. Auto's
    policy is exact-FIRST for small/mid programs (the per-case path,
    `_solve`); the case-stacked batch routes them through the search
    instead, so run the exact stage here when the search did not
    already certify — batch results must match per-case runs, and a
    small program must never end uncertified merely because it arrived
    in a batch (advisor r4)."""
    if solver != "auto":
        return res
    if res.status != "optimal" and prog.num_vars <= AUTO_EXACT_FIRST_MAX_VARS:
        from ambigram_tpu_torch.solver.exact import have_exact_solver, solve_exact

        if have_exact_solver():
            with GLOBAL.phase("solve.exact"):
                eres = solve_exact(prog, time_limit=60.0)
            if eres.status in ("optimal", "infeasible"):
                return eres
            return _auto_post(prog, res, [eres], tried_exact=True)
    return _auto_post(prog, res)


def _solve_stacked(items, solver: str, mesh) -> Dict[tuple, object]:
    """The mid-size leg of `solve_programs_batch`: one stacked
    case-sharded pass (`solve_cases_sharded`) over `items` ([(key, prog),
    ...]) on `mesh`, then a threaded host polish/certify/fallback per
    incumbent on min(4, n) workers. Runs inside the batch's thread pool
    so its device pass overlaps the big-case searches."""
    from ambigram_tpu_torch.parallel.mesh import solve_cases_sharded
    from ambigram_tpu_torch.solver.exact import SolveResult, solve_exact
    from ambigram_tpu_torch.solver.host import certified_bound, lp_lower_bound
    from ambigram_tpu_torch.solver.lns import lns_polish
    from ambigram_tpu_torch.solver.native_bnb import solve_native

    flat = [prog for _, prog in items]
    index = [key for key, _ in items]
    best = solve_cases_sharded(flat, mesh=mesh)
    # the same global LNS wall-clock policy as the big-case branch
    post_workers = min(4, max(1, len(flat)))
    per_case_lns = _per_case_lns_budget(len(flat), post_workers)

    def _post_one(args):
        """Host polish/certify/fallback for one sharded incumbent, on a
        thread pool (HiGHS and the native B&B release the GIL)."""
        key, prog, x = args
        eps = float(prog.residual_objective(x.astype(np.float64)))
        vio = float(prog.hard_violation(x.astype(np.float64)))
        lb = None
        if vio != 0.0 or eps != 0.0:
            # LNS window polish on the sharded incumbent: recovers the
            # last epsilon the dense-move step leaves behind and repairs
            # violated rows, often reaching the LP certificate
            lb = lp_lower_bound(prog)
            tgt = certified_bound(prog, lb) if lb is not None else None
            x_p, eps_p, vio_p = lns_polish(prog, x.astype(np.int64), target=tgt, time_budget=per_case_lns)
            if (vio_p, eps_p) < (vio, eps):
                x, eps, vio = x_p.astype(x.dtype), eps_p, vio_p
        certified = False
        if vio == 0.0:
            if eps == 0.0:
                # the objective is nonnegative: eps == 0 certifies itself
                certified = True
            else:
                if lb is None:
                    lb = lp_lower_bound(prog)
                # the LP bound rounded to the epsilon lattice is the
                # sharpest sound certificate
                certified = lb is not None and eps <= certified_bound(prog, lb) + 1e-6
        if certified:
            return key, SolveResult(x=x, epsilon_sum=eps, objective=eps - prog.bias, status="optimal")
        if solver == "auto":
            warm = SolveResult(
                x=x.astype(np.int64),
                epsilon_sum=eps,
                objective=eps - prog.bias,
                status="heuristic" if vio == 0 else "error",
            )
            nres = solve_native(prog, warm=warm if vio == 0 else None, time_limit_s=10.0)
            if nres is not None and nres.status in ("optimal", "infeasible"):
                return key, nres
            eres = solve_exact(prog, time_limit=60.0)
            if eres.status in ("optimal", "infeasible"):
                return key, eres
            # no stage proved optimality: the best feasible incumbent
            pool = [
                c
                for c in (warm, nres, eres)
                if c is not None
                and c.status == "heuristic"
                and float(prog.hard_violation(c.x.astype(np.float64))) == 0.0
            ]
            return key, (min(pool, key=lambda c: c.epsilon_sum) if pool else eres)
        return key, SolveResult(
            x=x,
            epsilon_sum=eps,
            objective=eps - prog.bias,
            status="heuristic" if vio == 0 else "error",
        )

    out: Dict[tuple, object] = {}
    with ThreadPoolExecutor(max_workers=post_workers) as pool_ex:
        for key, sol in pool_ex.map(_post_one, list(zip(index, flat, best))):
            out[key] = sol
    return out


def _case_store_key(lh_path: str) -> str:
    import hashlib

    digest = hashlib.sha1(open(lh_path, "rb").read()).hexdigest()[:16]
    return "%s-%s" % (os.path.basename(lh_path), digest)


def _result_to_store(fn: str, res: BfbResult) -> None:
    import json

    payload = {
        "path_strings": res.path_strings,
        "merged_path_string": res.merged_path_string,
        "target_cn": [int(v) for v in res.target_cn],
        "ilp_error": res.ilp_error,
        "num_inversions": res.num_inversions,
        "is_resolved": res.is_resolved,
        "seconds": res.seconds,
    }
    tmp = fn + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, fn)  # atomic: a crash never leaves a half-written result


def _result_from_store(fn: str) -> BfbResult:
    import json

    payload = json.load(open(fn))
    return BfbResult(
        path_strings=payload["path_strings"],
        merged_path_string=payload["merged_path_string"],
        target_cn=payload["target_cn"],
        ilp_error=payload["ilp_error"],
        num_inversions=payload["num_inversions"],
        is_resolved=payload["is_resolved"],
        seconds=payload["seconds"],
    )


def _append_ledgers(result: BfbResult, lh_path: str, juncs_path: str, ledger_dir: str) -> None:
    """The case's rows of simulation_sv.txt and time.csv (localhap.cpp
    analogs), appended in `ledger_dir`."""
    g = result.genome
    segs = list(g.segments)
    path_len = sum(len(p) for p in result.paths)
    cn_sum = sum(int(s.weight.copy_num) for s in segs)
    max_cn = max((int(s.weight.copy_num) for s in segs), default=0)
    with open(os.path.join(ledger_dir, "simulation_sv.txt"), "a") as f:
        for j in g.junctions:
            u, v = j.edge_a.source, j.edge_a.target
            f.write(
                "%s\t%s\t%s\t%d\t%s\t%s\t%d\t%s\t%g\tinput\n"
                % (
                    lh_path,
                    juncs_path,
                    u.seg.chrom,
                    u.seg.end if u.dir == "+" else u.seg.start,
                    u.dir,
                    v.seg.chrom,
                    v.seg.start if v.dir == "+" else v.seg.end,
                    v.dir,
                    j.weight.copy_num,
                )
            )
        for j in result.output_juncs:
            u, v = j.edge_a.source, j.edge_a.target
            f.write(
                "%s\t%s\t%s\t%d\t%s\t%s\t%d\t%s\t%g\toutput\n"
                % (
                    lh_path,
                    juncs_path,
                    u.seg.chrom,
                    u.seg.end if u.dir == "+" else u.seg.start,
                    u.dir,
                    v.seg.chrom,
                    v.seg.start if v.dir == "+" else v.seg.end,
                    v.dir,
                    j.weight.copy_num,
                )
            )
    name = os.path.basename(lh_path)
    name = lh_path[: lh_path.find(".")] if "." in lh_path else lh_path
    with open(os.path.join(ledger_dir, "time.csv"), "a") as f:
        f.write(
            "%s,%d,%d,%d,%d,%d,%d,%s\n"
            % (
                name,
                len(segs),
                result.num_inversions,
                len(g.junctions) - result.num_inversions,
                cn_sum,
                path_len,
                max_cn,
                result.seconds,
            )
        )
