"""Each op of the port has one builder, which both of its entries use.

A manifest parses each of its cases once (`run_bfb_many`,
`run_sc_bfb_many`); the batch entries answer as the single-case entries
and the JAX package's do, on the LH fixtures with an indel or
translocation SV too, where the single-cell cohort must apply the same
indel bias as `run_sc_bfb` and the JAX package's `run_sc_bfb`. The
replays handle a solution no search gave (a heuristic that breaks a
hard row, an infeasible status) as the JAX package's entries do when
handed it as `presolved`.
"""

import io
import os

import numpy as np
import pytest
import torch

from ambigram_tpu.engine import pipeline as jpipeline
from ambigram_tpu.engine import sc as jsc
from ambigram_tpu.solver.exact import SolveResult as JaxSolveResult
from ambigram_tpu_torch.engine import pipeline
from ambigram_tpu_torch.engine import sc as tsc
from ambigram_tpu_torch.model.genome import Genome
from ambigram_tpu_torch.solver.exact import SolveResult, solve_exact
from ambigram_tpu_torch.utils.profiling import GLOBAL
from test_torch_sc import FUZZ, write_clones

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def lh(name):
    return os.path.join(DATA, name + ".lh")


@pytest.fixture
def parsed_files(monkeypatch):
    """The LH files the port's Genome parses, in order."""
    files = []
    from_lh = Genome.from_lh

    def spy(cls, path):
        files.append(path)
        return from_lh(path)

    monkeypatch.setattr(Genome, "from_lh", classmethod(spy))
    return files


@pytest.mark.parametrize("op", ["bfb", "sc_bfb"])
def test_manifest_parses_each_case_once(op, parsed_files, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    GLOBAL.reset()
    if op == "bfb":
        paths = [lh("egfr6"), lh("indel_dup"), lh("c2_twochrom")]
        results = pipeline.run_bfb_many(paths, solver="exact", device="cpu")
        files = paths
    else:
        samples = []
        for case in (FUZZ[0], FUZZ[3]):
            _, names, edges = write_clones(tmp_path, *case)
            samples.append({"lh_paths": ",".join(names), "edges": edges})
        results = tsc.run_sc_bfb_many(samples, solver="exact", device="cpu")
        files = [name for s in samples for name in s["lh_paths"].split(",")]
    assert all(r.path_strings for r in results)
    assert GLOBAL.phases["parse"].calls == len(results)
    assert parsed_files == files
    assert all(r.seconds > 0 for r in results)


@pytest.mark.parametrize("name", ["indel_del", "indel_dup", "indel_ins"])
def test_cohort_applies_the_indel_bias_as_the_single_sample(name):
    lh_paths = "%s,%s" % (lh(name), lh(name))
    out_many, out_one = io.StringIO(), io.StringIO()
    (many,) = tsc.run_sc_bfb_many([{"lh_paths": lh_paths, "edges": ""}], solver="exact", device="cpu", out=out_many)
    one = tsc.run_sc_bfb(lh_paths, solver="exact", device="cpu", out=out_one)
    want = jsc.run_sc_bfb(lh_paths, solver="exact")
    assert many.path_strings == one.path_strings == want.path_strings
    assert out_many.getvalue() == out_one.getvalue()


@pytest.mark.parametrize(
    "name",
    ["indel_del", "indel_dup", "indel_ins", "indel_inv", "readme_i1", "readme_i2", "readme_c1", "readme_c2"],
)
def test_run_bfb_many_answers_as_run_bfb(name, tmp_path, monkeypatch):
    """Both port entries against each other and against the JAX
    package's `run_bfb`, which builds, solves and replays each
    chromosome in turn."""
    monkeypatch.chdir(tmp_path)  # the TRX modes write ./new.lh
    out_many, out_one, out_ref = io.StringIO(), io.StringIO(), io.StringIO()
    (many,) = pipeline.run_bfb_many([lh(name)], solver="exact", device="cpu", out=out_many)
    one = pipeline.run_bfb(lh(name), solver="exact", device="cpu", out=out_one)
    want = jpipeline.run_bfb(lh(name), solver="exact", out=out_ref)
    for got in (many, one):
        assert got.path_strings == want.path_strings
        assert got.merged_path_string == want.merged_path_string
        assert got.target_cn == want.target_cn
        assert got.ilp_error == want.ilp_error
        assert got.is_resolved == want.is_resolved
    assert out_many.getvalue() == out_one.getvalue() == out_ref.getvalue()


def given_solution(kind, opt):
    """A solution as a search might hand it to the replay: the optimum
    `opt` reported as a heuristic, as a heuristic with its first
    variable raised by one (which breaks a hard row on egfr6), or as
    infeasible."""
    x = opt.x.copy()
    if kind == "violating":
        x[0] += 1
    status = "infeasible" if kind == "infeasible" else "heuristic"
    return dict(x=x, epsilon_sum=opt.epsilon_sum, objective=opt.objective, status=status)


def chromosome_flags(result):
    return [(c.path_string, c.trivial, c.infeasible, c.certified) for c in result.chromosomes]


@pytest.mark.parametrize("kind", ["heuristic", "violating", "infeasible"])
def test_replay_case_takes_a_given_solution_as_reference(kind):
    case = pipeline.build_case(lh("egfr6"))
    (prog,) = case.programs
    sol = given_solution(kind, solve_exact(prog))
    if kind == "violating":
        assert float(prog.hard_violation(sol["x"].astype(np.float64))) != 0.0
    out_got, out_ref = io.StringIO(), io.StringIO()
    got = pipeline.replay_case(case, [SolveResult(**sol)], out_got)
    want = jpipeline.run_bfb(lh("egfr6"), solver="exact", out=out_ref, presolved=[JaxSolveResult(**sol)])
    assert chromosome_flags(got) == chromosome_flags(want)
    assert got.chromosomes[0].infeasible == (kind != "heuristic")
    assert got.path_strings == want.path_strings
    assert got.target_cn == want.target_cn
    assert got.ilp_error == want.ilp_error
    assert got.is_resolved == want.is_resolved
    assert out_got.getvalue() == out_ref.getvalue()


@pytest.mark.parametrize("kind", ["heuristic", "infeasible"])
def test_replay_sc_sample_takes_a_given_solution_as_reference(kind, tmp_path):
    _, names, edges = write_clones(tmp_path, *FUZZ[0])
    lh_paths = ",".join(names)
    sample = tsc.build_sc_sample(lh_paths, edges)
    solutions = [None if p is None else given_solution(kind, solve_exact(p)) for p in sample.programs]
    assert any(s is not None for s in solutions)
    out_got, out_ref = io.StringIO(), io.StringIO()
    got = tsc.replay_sc_sample(sample, [s and SolveResult(**s) for s in solutions], out_got)
    want = jsc.run_sc_bfb(
        lh_paths, solver="exact", edges=edges, out=out_ref, presolved=[s and JaxSolveResult(**s) for s in solutions]
    )
    assert got.path_strings == want.path_strings
    assert out_got.getvalue() == out_ref.getvalue()
