"""The whole run, on the CPU at a size a test holds (samples of 3 clones
of 8 segments, which the program settles in host HiGHS), with the look
for a card skipped: sound, `correct` is true; with the timed path broken
underneath, it comes out false. Faults: a solve that returns its
starting state unchanged, half of a manifest's samples left out, an
answer altered where it is produced (x, and a path). The cells run on
one chip, so there is no exchange between chips to leave out."""

import dataclasses

import numpy as np
import pytest

from bfbbench import run

pipeline = pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
sc = pytest.importorskip("ambigram_tpu_torch.engine.sc")
exact = pytest.importorskip("ambigram_tpu_torch.solver.exact")

SEED = 2**31 + 12345


def tiny(workload):
    """The cell, its limits and its cases' recipe, at a CPU size."""
    _, cell = run.load_cell(workload)
    recipe = dict(cell.config["generator"], n_segments=8)
    return dataclasses.replace(cell, config=dict(cell.config, generator=recipe))


def go(workload):
    return run.run_cell(workload, SEED, 0.3, False, device="cpu", cell=tiny(workload))


@pytest.mark.parametrize("workload", ["sc_k3_single", "sc_k3_cohort"])
def test_sound_run_is_correct(workload):
    res = go(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert set(res["metrics"]) == {"setup_s", "cases_per_min", "eps_lp_ratio"}


def _unchanged(prog, solver, device, lns_budget=None):
    x = np.zeros(prog.num_vars, dtype=np.int64)
    eps = float(prog.residual_objective(x.astype(np.float64)))
    return exact.SolveResult(x=x, epsilon_sum=eps, objective=eps - prog.bias, status="heuristic")


@pytest.mark.parametrize("workload", ["sc_k3_single", "sc_k3_cohort"])
def test_state_returned_unchanged_is_caught(monkeypatch, workload):
    def unchanged_batch(flat, index, *a, **k):
        return {key: _unchanged(prog, None, None) for key, prog in zip(index, flat)}

    monkeypatch.setattr(pipeline, "_solve", _unchanged)
    monkeypatch.setattr(pipeline, "solve_programs_batch", unchanged_batch)
    res = go(workload)
    assert not res["correct"] and res["checks"]["path_faults"]["value"] >= 1


def test_half_the_manifest_left_out_is_caught(monkeypatch):
    whole = sc.run_sc_bfb_many

    def half(samples, **kw):
        return whole(samples[: len(samples) // 2], **kw)

    monkeypatch.setattr(sc, "run_sc_bfb_many", half)
    res = go("sc_k3_cohort")
    assert not res["correct"] and res["checks"]["missing"]["value"] >= 2


@pytest.mark.parametrize("workload", ["sc_k3_single", "sc_k3_cohort"])
def test_answer_altered_where_produced_is_caught(monkeypatch, workload):
    solve, batch = pipeline._solve, pipeline.solve_programs_batch

    def bump(sol):
        x = np.asarray(sol.x).copy()
        T = len(x) // 2
        x[T + int(np.argmax(x[T:]))] += 1
        return dataclasses.replace(sol, x=x)

    monkeypatch.setattr(pipeline, "_solve", lambda *a, **k: bump(solve(*a, **k)))
    monkeypatch.setattr(pipeline, "solve_programs_batch", lambda *a, **k: {key: bump(s) for key, s in batch(*a, **k).items()})
    res = go(workload)
    assert not res["correct"]


@pytest.mark.parametrize("workload", ["sc_k3_single", "sc_k3_cohort"])
def test_path_altered_where_produced_is_caught(monkeypatch, workload):
    one, many = sc.run_sc_bfb, sc.run_sc_bfb_many

    def alter(res):
        paths = [list(p) for p in res.path_strings]
        paths[0][0] = paths[0][0].replace("2+3+", "2+2+", 1).replace("3-2-", "3-3-", 1)
        res.path_strings = paths
        return res

    monkeypatch.setattr(sc, "run_sc_bfb", lambda *a, **k: alter(one(*a, **k)))
    monkeypatch.setattr(sc, "run_sc_bfb_many", lambda *a, **k: [alter(r) for r in many(*a, **k)])
    res = go(workload)
    assert not res["correct"] and res["checks"]["path_faults"]["value"] >= 1
