"""Single-cell samples whose copy numbers come from read depth, on the
port's normal path.

The benchmark's configuration `sc_k3_s30_depth` writes each clone's SEG
lines as `<depth> -1`, so the parser derives fractional copy numbers and
the block program has no eps lattice (`eps_quantum` 0): the certificate
is the raw LP bound and the LNS tail runs on every sample above it.
Here, at K = 3 and S = 10-12 of that recipe on the CPU: the port's block
program against the benchmark's plain reference (bfbbench/reference.py),
`run_sc_bfb` through the search and the host tail with its answer judged
by the reference, and the host tail's phases and counters against what
the tail did.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ambigram_tpu_torch.engine import pipeline
from ambigram_tpu_torch.engine import sc as tsc
from ambigram_tpu_torch.solver import lns, search
from ambigram_tpu_torch.solver.exact import solve_exact
from ambigram_tpu_torch.solver.host import certified_bound, eps_quantum, lp_lower_bound
from ambigram_tpu_torch.utils.profiling import GLOBAL
from bfbbench import gen, readings, reference, run

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "bfbbench", "configs", "sc_k3_s30_depth.json")) as f:
    RECIPE = json.load(f)["generator"]

# (seed, S): the recipe's samples 0 and 1 (chain, star) at a small S
SAMPLES = [(0, 10), (1, 12)]
# the search's population and the LNS budget, cut so that the CPU runs a
# sample in seconds; the search still converges, so the tail probes
SMALL = {"AMBIGRAM_SEARCH_POP": "8", "AMBIGRAM_LNS_BUDGET": "10"}


def write_sample(workdir, seed, S, noise):
    """The recipe's sample `seed` at S segments an arm and the given
    noise: (its LH files, the port's block program, the reference's)."""
    sc = gen.simulate_sc_case(
        seed=seed,
        n_clones=RECIPE["n_clones"],
        n_segments=S,
        coverage=RECIPE["coverage"],
        noise=noise,
        topology=RECIPE["topologies"][seed % len(RECIPE["topologies"])],
    )
    names = gen.write_sc_clones(sc, os.path.join(str(workdir), "s%d_%d_%g_c" % (seed, S, noise)))
    (prog,) = [p for p in tsc.extract_sc_programs(",".join(names)) if p is not None]
    return names, prog, reference.Program([reference.parse_lh(c.lh_text) for c in sc.cases])


@pytest.fixture(scope="module", params=SAMPLES, ids=["s%d_S%d" % s for s in SAMPLES])
def solved(request, tmp_path_factory):
    """A depth-input sample through `run_sc_bfb(solver="device")` on the
    CPU: (LH files, the port's program, the reference's, the result, the
    solution `pipeline._solve` returned, the window's counters)."""
    seed, S = request.param
    names, prog, ref = write_sample(tmp_path_factory.mktemp("depth"), seed, S, RECIPE["noise"])
    sols = []
    solve = pipeline._solve

    def keep(*args, **kwargs):
        sols.append(solve(*args, **kwargs))
        return sols[-1]

    with pytest.MonkeyPatch.context() as mp:
        for key, value in SMALL.items():
            mp.setenv(key, value)
        mp.setattr(pipeline, "_solve", keep)
        GLOBAL.reset()
        res = tsc.run_sc_bfb(",".join(names), solver="device", device="cpu")
        counters = dict(GLOBAL.counters)
    assert len(sols) == 1
    return names, prog, ref, res, sols[0], counters


@pytest.mark.parametrize("seed,S", SAMPLES)
def test_block_program_is_the_references_on_fractional_targets(tmp_path, seed, S):
    _, prog, ref = write_sample(tmp_path, seed, S, RECIPE["noise"])
    assert eps_quantum(prog) == 0.0
    assert np.any(np.abs(prog.c_seg - np.round(prog.c_seg)) > 1e-3)
    # the port's rows are [K x seg | K x fbi]; the reference's [seg | fbi]
    # a clone
    K, n = ref.K, prog.n
    order = np.concatenate([np.concatenate([k * n + np.arange(n), (K + k) * n + np.arange(n)]) for k in range(K)])
    assert np.array_equal(ref.residual.toarray(), np.concatenate([prog.A_seg, prog.A_fbi])[order])
    assert np.array_equal(ref.target, np.concatenate([prog.c_seg, prog.c_fbi])[order])
    assert np.array_equal(ref.x_ub, prog.x_ub) and ref.bias == prog.bias == 0
    assert sorted(map(tuple, ref.coupling.tolist())) == sorted(map(tuple, prog.coupling.tolist()))
    rng = np.random.default_rng(seed)
    for _ in range(50):
        x = rng.integers(0, 3, size=ref.V).astype(float)
        for k in range(K):
            x[k * ref.block : k * ref.block + ref.T] = rng.integers(0, 2, size=ref.T)
        x[rng.random(ref.V) < 0.8] = 0
        assert ref.violation(x) == pytest.approx(float(prog.hard_violation(x)), abs=1e-9)
        assert ref.eps(x) == pytest.approx(float(prog.residual_objective(x)), abs=1e-9)
    assert ref.lp_bound() == pytest.approx(lp_lower_bound(prog), rel=1e-7)


def test_run_sc_bfb_answer_passes_the_reference(solved):
    _, _, ref, res, sol, counters = solved
    assert sol.status in ("optimal", "heuristic")
    paths = [p[0] for p in res.path_strings]
    assert len(paths) == ref.K and all(len(p) == 1 for p in res.path_strings)
    lp = ref.lp_bound()
    v = reference.judge(ref, lp, np.asarray(sol.x, dtype=float), sol.objective + ref.bias, None, paths)
    assert v.violation == 0 and v.cn_mismatch == 0 and v.path_faults == 0
    assert v.eps_gap <= 1e-9 and v.lp_ratio > 1.0
    # the answer is above its LP bound and there is no lattice: the tail
    # ran, as a probe of the converged search or as a full polish
    assert counters.get("lns.probes", 0) + counters.get("lns.neighbourhoods", 0) >= 1
    assert "lns.eps_gain" in counters


def loop_taken_out(prog, x):
    """x with its first loop lowered by one."""
    T = len(prog.pairs)
    v = next(v for v in np.flatnonzero(x) if v % (2 * T) >= T)
    y = x.copy()
    y[v] -= 1
    return y


def tail(prog, x, converged):
    """`_finish_solution` on x under the cut LNS budget, from reset
    counters: (its result, the counters, the phases)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AMBIGRAM_LNS_BUDGET", SMALL["AMBIGRAM_LNS_BUDGET"])
        GLOBAL.reset()
        res = search._finish_solution(prog, x.astype(np.float64), lp_lower_bound(prog), converged=converged)
        return res, dict(GLOBAL.counters), dict(GLOBAL.phases)


def measure(prog, x):
    x = np.asarray(x, dtype=np.float64)
    return float(prog.hard_violation(x)), float(prog.residual_objective(x))


def test_full_polish_counts_what_it_gained(solved):
    _, prog, _, _, sol, _ = solved
    bad = loop_taken_out(prog, np.asarray(sol.x, dtype=np.int64))
    vio0, eps0 = measure(prog, bad)
    res, counters, phases = tail(prog, bad, converged=True)
    vio1, eps1 = measure(prog, res.x)
    assert (vio1, eps1) < (vio0, eps0) and vio1 == 0
    assert res.epsilon_sum == eps1
    assert counters["lns.eps_gain"] == pytest.approx(eps0 - eps1, abs=1e-9)
    # a violating incumbent goes straight to the full polish: no probe
    assert "lns.probes" not in counters and "lns.escalations" not in counters
    assert phases["solve.lns.full"].calls == 1 and "solve.lns.probe" not in phases
    assert phases["solve.lns"].seconds >= phases["solve.lns.full"].seconds
    assert counters["lns.milps"] == phases["solve.lns.milp"].calls
    assert counters.get("lns.milp_capped", 0) <= counters["lns.milps"]


def test_mending_a_violation_at_a_higher_eps_counts_a_loss(solved, monkeypatch):
    """Where the polish's only feasible point fits worse than the
    violating incumbent, the tail takes it and the gain is negative."""
    _, prog, _, _, sol, _ = solved
    bad = loop_taken_out(prog, np.asarray(sol.x, dtype=np.int64))
    vio0, eps0 = measure(prog, bad)
    worse = np.zeros_like(bad)  # feasible: no pattern, no loop
    vio1, eps1 = measure(prog, worse)
    assert vio0 > 0 and vio1 == 0 and eps1 > eps0
    monkeypatch.setattr(lns, "lns_polish", lambda *args, **kwargs: (worse, eps1, vio1))
    res, counters, _ = tail(prog, bad, converged=False)
    assert np.array_equal(res.x, worse)
    assert counters["lns.eps_gain"] == pytest.approx(eps0 - eps1, abs=1e-9) and counters["lns.eps_gain"] < 0


def test_probe_counts_are_consistent(solved):
    _, prog, _, _, sol, _ = solved
    x = np.asarray(sol.x, dtype=np.int64)
    eps0 = measure(prog, x)[1]
    res, counters, phases = tail(prog, x, converged=True)
    assert counters["lns.probes"] == 1 and phases["solve.lns.probe"].calls == 1
    assert counters.get("lns.escalations", 0) <= counters["lns.probes"]
    assert counters.get("lns.escalations", 0) == (phases["solve.lns.full"].calls if "solve.lns.full" in phases else 0)
    assert counters.get("lns.milp_capped", 0) <= counters.get("lns.milps", 0)
    assert counters.get("lns.milps", 0) == (phases["solve.lns.milp"].calls if "solve.lns.milp" in phases else 0)
    assert counters["lns.eps_gain"] == pytest.approx(eps0 - res.epsilon_sum, abs=1e-9)
    assert counters["lns.eps_gain"] >= 0


@pytest.mark.parametrize("noise,probes", [(0.0, 0), (RECIPE["noise"], 1)], ids=["integer", "depth"])
def test_only_a_sample_above_its_certificate_probes(tmp_path, noise, probes):
    """At its exact optimum an integer-target sample sits on its
    certificate (the LP bound rounded up to the 0.5 lattice) and counts
    no probe; a depth-input one sits above its raw LP bound and probes."""
    _, prog, _ = write_sample(tmp_path, 3, 10, noise)
    opt = solve_exact(prog, time_limit=60.0)
    assert opt.status == "optimal"
    lb = lp_lower_bound(prog)
    assert (opt.epsilon_sum <= certified_bound(prog, lb) + 1e-6) == (probes == 0)
    _, counters, phases = tail(prog, opt.x, converged=True)
    assert counters.get("lns.probes", 0) == probes
    assert ("solve.lns" in phases) == (probes == 1)


def test_float32_eps_fails_the_cells_limits_alone():
    """The cell's limits pass a sound run and fail the reference's eps in
    float32, the precision below the configuration's, by `eps_gap`
    alone: on depth-derived targets float32 rounds the fit."""
    _, cell = run.load_cell("sc_k3_depth_single")
    small = dataclasses.replace(
        cell,
        config=dict(cell.config, generator=dict(RECIPE, n_segments=8)),
        traffic=dict(cell.traffic, cycle=2, cases=[0, 1]),
    )
    (sound,) = readings.readings(cell.name, [2**31 + 18], 0.0, device="cpu", cell=small, out=None)
    (f32,) = readings.readings(cell.name, [2**31 + 18], 0.0, control="eps_f32", device="cpu", cell=small, out=None)
    assert sound["cases"] == f32["cases"] == 2
    assert all(v <= cell.limits[k] for k, v in sound["numbers"].items()), sound["numbers"]
    assert [k for k, v in f32["numbers"].items() if v > cell.limits[k]] == ["eps_gap"], f32["numbers"]
