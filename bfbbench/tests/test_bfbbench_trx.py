"""Bulk cases of the TRX-BFB concatenation mode (`PROP C1`): the
generator; the reference's fused arm against the program's; the
reference's judgement of paths in original ids; the `bfb` entry; and a
whole run of `bulk_c1_depth_single` on the CPU at 8 + 8 arms (which the
program settles in host HiGHS), with the look for a card skipped: sound,
`correct` is true; with the timed path broken underneath (a solve that
returns its starting state unchanged, an answer altered where it is
produced: x, and a path), it comes out false; and its control, the
reference's epsilon in float32, comes out not correct. The cell runs
one case a unit on one chip, so no batch is halved and no exchange
between chips is left out."""

import dataclasses
import os

import numpy as np
import pytest

from bfbbench import gen_trx, readings, reference, run

WORKLOAD = "bulk_c1_depth_single"
SEED = 2**31 + 4242
CONTROL_SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


def tiny():
    """The cell, its limits and its cases' recipe, at arms of 8 + 8."""
    _, cell = run.load_cell(WORKLOAD)
    recipe = dict(cell.config["generator"], arms=[8, 8])
    return dataclasses.replace(cell, config=dict(cell.config, generator=recipe))


def seg_fields(text):
    """{id: (chromosome, start, depth, cn)} of an LH text's SEG lines."""
    out = {}
    for line in text.splitlines():
        tok = line.split()
        if tok[0] == "SEG":
            _, seg, chrom, start, _ = tok[1].split(":")
            out[int(seg)] = (chrom, int(start), tok[2], tok[3])
    return out


# ------------------------------------------------------------- generator


@pytest.mark.parametrize("orientation", ["+", "-"])
def test_generator_writes_two_arms_and_their_translocation(orientation):
    case = gen_trx.simulate_c1_case(2**31 + 7, orientation=orientation)
    again = gen_trx.simulate_c1_case(2**31 + 7, orientation=orientation)
    other = gen_trx.simulate_c1_case(2**31 + 8, orientation=orientation)
    assert case.lh_text == again.lh_text and case.truth_path == again.truth_path
    assert case.lh_text != other.lh_text
    lines = case.lh_text.splitlines()
    assert "SOURCE 1,31" in lines and "SINK 30,60" in lines
    assert lines[-1] == "PROP C1:chr7:chr12"
    segs = seg_fields(case.lh_text)
    assert sorted(segs) == list(range(1, 61))
    assert {segs[i][0] for i in range(1, 31)} == {"chr7"} and {segs[i][0] for i in range(31, 61)} == {"chr12"}
    # chr12 in its own coordinates, its depths read, not called
    assert segs[31][1] == segs[1][1] and all(segs[i][3] == "-1" for i in segs)
    far = "H:31:+" if orientation == "+" else "H:60:-"
    trx = [line.split() for line in lines if line.startswith("JUNC H:30:+ %s " % far)]
    crossing = sum(1 for (s1, _), (s2, _) in zip(case.fused_path, case.fused_path[1:]) if {s1, s2} == {30, 31})
    assert len(trx) == 1 and crossing >= 2 and case.crossings == crossing
    assert trx[0][3:] == ["%g" % (crossing * 30.0 / 2), "%g" % crossing, "U", "B"]
    # every other junction is a fold-back on one arm, in original ids
    for line in lines:
        tok = line.split()
        if tok[0] == "JUNC" and tok[1:3] != ["H:30:+", far]:
            (s1, d1), (s2, d2) = [(int(f.split(":")[1]), f.split(":")[2]) for f in tok[1:3]]
            assert s1 == s2 and d1 != d2
    # the truth in original ids: chr12 entered at 31+ or at 60-
    assert case.truth_path[:31] == [(i, "+") for i in range(1, 31)] + [(31, "+") if orientation == "+" else (60, "-")]
    assert "||" in case.truth_string


def test_orientation_reverses_the_second_arm():
    plus = seg_fields(gen_trx.simulate_c1_case(2**31 + 9, orientation="+").lh_text)
    minus = seg_fields(gen_trx.simulate_c1_case(2**31 + 9, orientation="-").lh_text)
    assert [plus[i][2] for i in range(1, 31)] == [minus[i][2] for i in range(1, 31)]
    assert [plus[31 + i][2] for i in range(30)] == [minus[60 - i][2] for i in range(30)]


# ------------------------------------------------------------- reference


def _rows(matrix, lo, hi):
    """The rows of a hard-row system as a sorted list, whatever their order."""
    import scipy.sparse as sp

    m = sp.csr_matrix(np.asarray(matrix, dtype=np.float64) if not sp.issparse(matrix) else matrix)
    m.eliminate_zeros()
    m.sort_indices()
    return sorted(
        (tuple(m.indices[m.indptr[r] : m.indptr[r + 1]].tolist()), tuple(m.data[m.indptr[r] : m.indptr[r + 1]].tolist()),
         float(lo[r]), float(hi[r]))
        for r in range(m.shape[0])
    )


@pytest.mark.parametrize("orientation", ["+", "-"])
@pytest.mark.parametrize("recipe_seed", range(8))
def test_fused_program_is_the_programs(tmp_path, monkeypatch, recipe_seed, orientation):
    pipeline = pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
    monkeypatch.chdir(tmp_path)
    _, cell = run.load_cell(WORKLOAD)
    recipe = cell.config["generator"]
    case = gen_trx.simulate_c1_case(recipe_seed, arms=recipe["arms"], chroms=recipe["chroms"],
                                    coverage=recipe["coverage"], noise=recipe["noise"], orientation=orientation)
    fn = gen_trx.write_c1_case(case, str(tmp_path / "c"))[0]
    programs = pipeline.build_case(fn).programs
    assert len(programs) == 1
    prog = programs[0]
    ours, fusion = run.load_kind("bfb_c1").case_program([case.lh_text])
    assert fusion is not None and ours.n == 60 and ours.V == prog.num_vars == 3660
    assert np.array_equal(ours.residual.toarray(), np.concatenate([prog.A_seg, prog.A_fbi]))
    assert np.array_equal(ours.target, np.concatenate([prog.c_seg, prog.c_fbi]))
    assert np.array_equal(ours.x_ub, prog.x_ub) and ours.bias == prog.bias
    assert _rows(ours.hard, ours.hard_lo, ours.hard_hi) == _rows(prog.G, prog.g_lb, prog.g_ub)
    # the generator's truth, in original ids, is a walk of the fused arm
    steps, fault = fusion.fused_path(case.truth_string)
    assert fault == "" and steps == case.fused_path


def _solved(tmp_path, monkeypatch, recipe_seed, orientation):
    """A case of 8 + 8 arms, the program's exact answer on the CPU."""
    pipeline = pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
    monkeypatch.chdir(tmp_path)
    case = gen_trx.simulate_c1_case(recipe_seed, arms=(8, 8), orientation=orientation)
    fn = gen_trx.write_c1_case(case, str(tmp_path / "c"))[0]
    res = pipeline.run_bfb(fn, solver="exact", device="cpu")
    prog, fusion = run.load_kind("bfb_c1").case_program([case.lh_text])
    x = res.chromosomes[0].element_cn.astype(float)
    return prog, fusion, prog.lp_bound(), x, res.ilp_error + prog.bias, res.path_strings


@pytest.mark.parametrize("orientation", ["+", "-"])
@pytest.mark.parametrize("recipe_seed", [0, 3, 5])
def test_reference_accepts_the_programs_answers(tmp_path, monkeypatch, recipe_seed, orientation):
    prog, fusion, lp, x, eps, paths = _solved(tmp_path, monkeypatch, recipe_seed, orientation)
    assert len(paths) == 1 and "||" in paths[0]
    v = reference.judge(prog, lp, x, eps, None, fusion.fused_strings(paths))
    assert v.violation == 0 and v.cn_mismatch == 0 and v.path_faults == 0
    assert v.eps_gap < 1e-9 and np.isfinite(v.lp_ratio) and v.lp_ratio >= 1


@pytest.mark.parametrize("orientation", ["+", "-"])
def test_reference_rejects_a_corrupted_answer(tmp_path, monkeypatch, orientation):
    prog, fusion, lp, x, eps, paths = _solved(tmp_path, monkeypatch, 3, orientation)
    ps = paths[0]

    def faults(path):
        return reference.judge(prog, lp, x, eps, None, fusion.fused_strings([path])).path_faults

    assert faults(ps) == 0
    # a `||` between other segments: a fold-back marked as a translocation
    k = next(i for i in range(len(ps)) if ps[i] == "|" and ps[i - 1] != "|" and ps[i + 1] != "|")
    assert fusion.fused_path(ps[:k] + "||" + ps[k + 1 :])[1] and faults(ps[:k] + "||" + ps[k + 1 :]) == 1
    # the change of arm left unmarked
    assert faults(ps.replace("||", "", 1)) == 1
    # a segment skipped
    assert ps.startswith("1+2+3+") and faults("1+3+" + ps[len("1+2+3+") :]) == 1
    # a step outside the two arms
    assert faults(ps + "17+") == 1
    # x moved by one
    x2 = x.copy()
    x2[prog.T + int(np.argmax(x[prog.T :]))] += 1
    v = reference.judge(prog, lp, x2, eps, None, fusion.fused_strings(paths))
    assert v.cn_mismatch >= 1 or v.violation > 0
    assert v.eps_gap > 0 or v.violation > 0


def test_the_arms_fuse_as_the_junction_says():
    text = "\n".join([
        "PURITY 1", "AVG_TUMOR_PLOIDY 2", "AVG_WHOLE_HOST_DP 30", "SOURCE 1,4", "SINK 3,6",
        "SEG H:1:a:0:9 15 -1", "SEG H:2:a:10:19 30 -1", "SEG H:3:a:20:29 30 -1",
        "SEG H:4:b:0:9 30 -1", "SEG H:5:b:10:19 45 -1", "SEG H:6:b:20:29 45 -1",
        "JUNC H:2:+ H:2:- 15 1 U B", "JUNC H:1:- H:4:+ 15 1 U B", "JUNC H:5:- H:5:+ 15 1 U B", "PROP C1:b:a",
    ]) + "\n"
    fused, fusion = reference.fuse_c1(text)
    # the junction leaves arm a at 1 going "-": a runs from its sink down
    # to 1, reversed; then arm b from 4 going "+" to its sink
    assert fusion.fused_of == {3: (1, True), 2: (2, True), 1: (3, True), 4: (4, False), 5: (5, False), 6: (6, False)}
    assert fusion.ends == (1, 4)
    obs = reference.parse_lh(fused)
    assert obs.seg_cn.tolist() == [2, 2, 1, 2, 3, 3] and obs.fbi_cn.tolist() == [0, 1, 0, 0, 1, 0]
    assert fusion.fused_path("3-2-1-||4+5+|5-") == ([(1, "+"), (2, "+"), (3, "+"), (4, "+"), (5, "+"), (5, "-")], "")
    assert fusion.fused_path("3-2-1-4+5+")[1] and fusion.fused_path("3-2-||1-4+")[1]
    assert fusion.fused_path("3-2-1-||5+")[1] and fusion.fused_path("3-2-1-||4+5+x")[1]
    # a junction that would leave segments out of the fused arm
    with pytest.raises(ValueError):
        reference.fuse_c1(text.replace("H:1:- H:4:+", "H:2:- H:4:+"))
    with pytest.raises(ValueError):
        reference.fuse_c1(text.replace("PROP C1:b:a", ""))


# ----------------------------------------------------------------- entry


def test_bfb_entry_makes_one_solve(tmp_path, monkeypatch):
    pipeline = pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
    cell = tiny()
    cases = run.make_cases(cell, SEED, str(tmp_path))
    assert len(cases) == 8 and all(len(c.lh) == 1 for c in cases)
    with run.SolutionRecorder() as recorder:
        entry = run.make_entry(cell, "cpu", recorder)
        cwd = os.getcwd()
        (ans,) = entry(cases[:1])
        assert ans.x is not None and ans.x.shape == (272,) and len(ans.paths) == 1 and "||" in ans.paths[0]
        # the rewritten graph lands beside the case, and the directory is restored
        assert os.getcwd() == cwd and (tmp_path / "new.lh").exists()
        whole = pipeline.solve_each

        def twice(programs, solver, device, *a, **k):
            pipeline._solve(programs[0], solver, device)
            return whole(programs, solver, device, *a, **k)

        monkeypatch.setattr(pipeline, "solve_each", twice)
        with pytest.raises(RuntimeError, match="2 calls"):
            entry(cases[:1])
    with pytest.raises(ValueError, match="no cell"):
        run.make_entry(dataclasses.replace(cell, traffic=dict(cell.traffic, unit="manifest")), "cpu", None)


# ------------------------------------------------------------- whole run


def go():
    return run.run_cell(WORKLOAD, SEED, 0.3, False, device="cpu", cell=tiny())


def test_sound_run_is_correct():
    res = go()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 8
    assert set(res["metrics"]) == {"setup_s", "cases_per_min", "eps_lp_ratio"}
    assert np.isfinite(res["metrics"]["eps_lp_ratio"]["value"])


def test_state_returned_unchanged_is_caught(monkeypatch):
    pipeline = pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
    exact = pytest.importorskip("ambigram_tpu_torch.solver.exact")

    def unchanged(prog, solver, device, lns_budget=None):
        x = np.zeros(prog.num_vars, dtype=np.int64)
        eps = float(prog.residual_objective(x.astype(np.float64)))
        return exact.SolveResult(x=x, epsilon_sum=eps, objective=eps - prog.bias, status="heuristic")

    monkeypatch.setattr(pipeline, "_solve", unchanged)
    res = go()
    assert not res["correct"] and res["checks"]["path_faults"]["value"] >= 1


def test_answer_altered_where_produced_is_caught(monkeypatch):
    pipeline = pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
    solve = pipeline._solve

    def bumped(*a, **k):
        sol = solve(*a, **k)
        x = np.asarray(sol.x).copy()
        T = len(x) // 2
        x[T + int(np.argmax(x[T:]))] += 1
        return dataclasses.replace(sol, x=x)

    monkeypatch.setattr(pipeline, "_solve", bumped)
    assert not go()["correct"]


def test_path_altered_where_produced_is_caught(monkeypatch):
    pipeline = pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
    whole = pipeline.run_bfb

    def altered(*a, **k):
        res = whole(*a, **k)
        res.path_strings = [p.replace("2+3+", "2+2+", 1) for p in res.path_strings]
        return res

    monkeypatch.setattr(pipeline, "run_bfb", altered)
    res = go()
    assert not res["correct"] and res["checks"]["path_faults"]["value"] >= 1


# --------------------------------------------------------------- control


def fails(line, limits):
    return any(line["numbers"][k] > limits[k] for k in line["numbers"])


def test_control_fails_on_the_cpu():
    pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
    cell = tiny()
    lines = readings.readings(WORKLOAD, CONTROL_SEEDS[:1], 0.2, control="eps_f32", device="cpu", cell=cell, out=None)
    assert fails(lines[0], cell.limits), lines[0]["numbers"]


@pytest.mark.cuda
def test_control_fails_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, cell = run.load_cell(WORKLOAD)
    lines = readings.readings(WORKLOAD, CONTROL_SEEDS, 1.0, control="eps_f32", out=None)
    assert all(fails(line, cell.limits) for line in lines), [line["numbers"] for line in lines]
