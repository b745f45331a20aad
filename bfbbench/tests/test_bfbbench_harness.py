"""The harness's arithmetic and its judgement, on the CPU: the rate over
whole units with the last unit's overshoot counted, the epsilon over
whole cycles only, the idle share by the union of device intervals, the
import check, the reference against the program's own formulation, and
the reference rejecting a corrupted answer."""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from bfbbench import gen, reference, run
from bfbbench import trace as device_trace


def fake_cell(unit="case"):
    return run.Cell("fake", 1, {"op": "bfb"}, {"unit": unit, "cycle": 3}, {})


def sleeper(seconds):
    def entry(cases):
        time.sleep(seconds)
        return [run.Answer(np.zeros(2)) for _ in cases]

    return entry


CYCLE = [run.Case("c%d" % i, [], i) for i in range(3)]


def test_rate_counts_whole_units_and_the_overshoot():
    w = run.run_window(fake_cell(), sleeper(0.1), CYCLE, 0.35, lambda: None)
    # units start until 0.35 s have passed and the cycle is whole: 6 units
    assert w.units == 6 and len(w.answers) == 6
    # the units after 0.35 s run to their end and their time counts
    assert w.seconds >= 0.6
    ctx = SimpleNamespace(cases=len(w.answers), window_s=w.seconds)
    rate = run.load_reader("cases_per_min").read(ctx)
    assert rate == pytest.approx(60.0 * 6 / w.seconds)
    assert rate < 60.0 * 6 / 0.35


def test_window_holds_whole_cycles_only():
    w = run.run_window(fake_cell(), sleeper(0.01), CYCLE, 0.0, lambda: None)
    assert w.units == 3 and [c.key for c, _ in w.answers] == ["c0", "c1", "c2"]
    m = run.run_window(fake_cell("manifest"), sleeper(0.1), CYCLE, 0.25, lambda: None)
    assert m.units == 3 and len(m.answers) == 9


def test_eps_over_the_windows_cases():
    verdicts = [SimpleNamespace(lp_ratio=r) for r in (1.0, 2.0, 3.0)] + [None]
    assert run.load_reader("eps_lp_ratio").read(SimpleNamespace(verdicts=verdicts)) == pytest.approx(2.0)


def test_every_seed_takes_the_listed_cases(tmp_path):
    _, cell = run.load_cell("sc_k3_single")
    cell = run.Cell(cell.name, 1, dict(cell.config, generator=dict(cell.config["generator"], n_segments=8)),
                    cell.traffic, cell.limits)
    texts = {}
    for seed in (1, 2**31 + 5):
        d = tmp_path / str(seed)
        d.mkdir()
        cycle = run.make_cases(cell, seed, str(d))
        texts[seed] = sorted(tuple((tmp_path / str(seed) / os.path.basename(f)).read_text() for f in c.lh) for c in cycle)
        assert run.first_unit(cell, cycle)[0].listed == 0
    assert texts[1] == texts[2**31 + 5]


def test_idle_share_counts_overlapping_kernels_once():
    ivs = [("k1", 0.0, 1.0), ("k2", 0.5, 1.5), ("copy", 3.0, 3.5), ("k3", 3.2, 3.3)]
    assert device_trace.busy_seconds(ivs) == pytest.approx(2.0)
    ctx = SimpleNamespace(intervals=ivs, window_s=10.0)
    assert run.load_reader("device_idle_pct").read(ctx) == pytest.approx(80.0)
    gaps = device_trace.idle_gaps(ivs)
    assert gaps[0][1] == pytest.approx(1.5) and "k2" in gaps[0][0]
    assert run.load_reader("device_idle_pct").read(SimpleNamespace(intervals=None, window_s=1.0)) is None


def test_kernel_readers_by_name():
    ivs = [("void sweep_score_kernel<3>(...)", 0.0, 0.002), ("void score_rows_i8<1, 64, 0>(...)", 0.0, 0.001),
           ("sweep_apply_kernel", 0.01, 0.011)]
    ctx = SimpleNamespace(intervals=ivs, cases=2)
    assert run.load_reader("sweep_kernel_ms_per_case").read(ctx) == pytest.approx(1.5)
    assert run.load_reader("k1_ms_per_case").read(ctx) == pytest.approx(0.5)
    assert run.load_reader("k1_ms_per_case").read(SimpleNamespace(intervals=ivs[:1], cases=2)) is None


def test_import_check_compares_whole_names():
    assert run.forbidden_modules(["jax.numpy", "numpy", "ambigram_tpu_torch.engine"]) == ["jax"]
    assert run.forbidden_modules(["ambigram_tpu.solver.score", "__graft_entry__", "jaxlib"]) == [
        "__graft_entry__", "ambigram_tpu", "jaxlib"]
    assert run.forbidden_modules(["ambigram_tpu_torch", "jaxtyping", "flaxen"]) == []


def test_reference_imports_nothing_of_the_program():
    import ast

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("reference.py", "gen.py", "trace.py"):
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [m for m in mods if m.split(".")[0].startswith(("ambigram", "jax", "__graft"))], name


@pytest.mark.parametrize("seed,S,noise", [(1, 10, 0.05), (2, 12, 0.0), (7, 20, 0.05)])
def test_reference_is_the_programs_formulation(tmp_path, seed, S, noise):
    pipeline = pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
    from ambigram_tpu_torch.solver.host import lp_lower_bound

    case = gen.simulate_bfb_case(seed=seed, n_segments=S, rounds=5, noise=noise)
    fn = gen.write_case(case, str(tmp_path / "b"))["lh"]
    prog = pipeline.extract_programs(fn)[0]
    ours = reference.Program([reference.parse_lh(case.lh_text)])
    assert np.array_equal(ours.residual.toarray(), np.concatenate([prog.A_seg, prog.A_fbi]))
    assert np.array_equal(ours.target, np.concatenate([prog.c_seg, prog.c_fbi]))
    assert np.array_equal(ours.x_ub, prog.x_ub) and ours.bias == prog.bias
    rng = np.random.default_rng(seed)
    for _ in range(100):
        x = rng.integers(0, 3, size=ours.V).astype(float)
        x[: ours.T] = rng.integers(0, 2, size=ours.T)
        x[rng.random(ours.V) < 0.8] = 0
        assert ours.violation(x) == pytest.approx(float(prog.hard_violation(x)), abs=1e-9)
        assert ours.eps(x) == pytest.approx(float(prog.residual_objective(x)), abs=1e-9)
    assert ours.lp_bound() == pytest.approx(lp_lower_bound(prog), rel=1e-7)


def test_reference_is_the_programs_block_formulation(tmp_path):
    sc_mod = pytest.importorskip("ambigram_tpu_torch.engine.sc")
    sc = gen.simulate_sc_case(seed=3, n_clones=3, n_segments=8, topology="star")
    names = gen.write_sc_clones(sc, str(tmp_path / "s"))
    prog = [p for p in sc_mod.extract_sc_programs(",".join(names), "") if p is not None][0]
    ours, reading = run.load_kind("sc").case_program([c.lh_text for c in sc.cases])
    assert reading is None
    rng = np.random.default_rng(3)
    for _ in range(100):
        x = rng.integers(0, 3, size=ours.V).astype(float)
        for k in range(3):
            x[k * ours.block : k * ours.block + ours.T] = rng.integers(0, 2, size=ours.T)
        x[rng.random(ours.V) < 0.8] = 0
        assert ours.violation(x) == pytest.approx(float(prog.hard_violation(x)), abs=1e-9)
        assert ours.eps(x) == pytest.approx(float(prog.residual_objective(x)), abs=1e-9)


def _solved_case(tmp_path):
    """A 12-segment case, its exact answer from the program on the CPU."""
    pipeline = pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
    case = gen.simulate_bfb_case(seed=4, n_segments=12, rounds=5, noise=0.05)
    fn = gen.write_case(case, str(tmp_path / "b"))["lh"]
    res = pipeline.run_bfb(fn, solver="exact", device="cpu")
    prog = reference.Program([reference.parse_lh(case.lh_text)])
    ch = res.chromosomes[0]
    return prog, prog.lp_bound(), ch.element_cn.astype(float), res.ilp_error + prog.bias, res.target_cn, res.path_strings


def test_reference_accepts_the_programs_answer(tmp_path):
    prog, lp, x, eps, cn, paths = _solved_case(tmp_path)
    v = reference.judge(prog, lp, x, eps, cn, paths)
    assert v.violation == 0 and v.cn_mismatch == 0 and v.path_faults == 0
    assert v.eps_gap < 1e-9 and v.lp_ratio >= 1


def test_reference_rejects_a_corrupted_path(tmp_path):
    prog, lp, x, eps, cn, paths = _solved_case(tmp_path)
    steps = reference.parse_path(paths[0])
    # a segment skipped: 3+ followed by 5+
    k = next(i for i in range(len(steps) - 2) if steps[i][1] == steps[i + 1][1] == "+")
    bad = gen.format_steps(steps[: k + 1] + steps[k + 2 :])
    assert reference.judge(prog, lp, x, eps, cn, [bad]).path_faults == 1
    # a fold-back dropped along with the segment's second visit
    extra = gen.format_steps(steps + [(steps[-1][0], "+" if steps[-1][1] == "-" else "-")])
    assert reference.judge(prog, lp, x, eps, cn, [extra]).cn_mismatch >= 1


def test_reference_rejects_a_corrupted_copy_number_or_eps(tmp_path):
    prog, lp, x, eps, cn, paths = _solved_case(tmp_path)
    bad_cn = list(cn)
    bad_cn[3] += 1
    assert reference.judge(prog, lp, x, eps, bad_cn, paths).cn_mismatch == 1
    assert reference.judge(prog, lp, x, eps - 0.5, cn, paths).eps_gap == pytest.approx(0.5)
    x2 = x.copy()
    x2[prog.T + int(np.argmax(x[prog.T :]))] += 1
    v = reference.judge(prog, lp, x2, eps, cn, paths)
    assert v.cn_mismatch >= 2 or v.violation > 0
    assert v.eps_gap > 0 or v.violation > 0
