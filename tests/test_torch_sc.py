"""The port's single-cell mode (`--op sc_bfb`, `sc:` manifest lines)
against the JAX package.

Inputs are the JAX suite's simulated K-clone samples
(`simulate_sc_case`, numpy seeds) and the two-clone egfr6 fixture of
tests/test_cli_and_sc.py. Block programs, their scoring tensors and
K1's plain scores on them are held bitwise against the JAX package
(every coefficient and target is an integer, so every f32 sum is exact
in any order). The exact route must print the JAX path strings and text
byte for byte. The device route on the CPU draws its kicks from torch
generators, so it is judged on its result: every clone's simulated
truth (`multiplicity_diff == 0`). Every comparison here is exact.
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from ambigram_tpu.engine import sc as jsc
from ambigram_tpu.parallel import mesh as jmesh
from ambigram_tpu.scripts.simulate import simulate_sc_case
from ambigram_tpu.solver import score as jscore
from ambigram_tpu_torch import cli
from ambigram_tpu_torch.engine import pipeline
from ambigram_tpu_torch.engine import sc as tsc
from ambigram_tpu_torch.parallel.mesh import stack_cases
from ambigram_tpu_torch.scripts.evaluate import multiplicity_diff
from ambigram_tpu_torch.scripts.simulate import write_sc_clones
from ambigram_tpu_torch.solver import lns, search
from ambigram_tpu_torch.solver import score as tscore
from ambigram_tpu_torch.utils.profiling import GLOBAL
from test_torch_score import LEAVES, STATIC, assert_tensors_equal, port_from_jax

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
EGFR6 = os.path.join(DATA, "egfr6.lh")
GOLDEN_EGFR6 = "1+2+3+4+5+6+|6-5-4-3-2-|2+3+4+|4-3-|3+4+|4-3-2-|2+3+4+5+6+|6-5-4-3-2-1-"
# the JAX suite's (seed, K, S, topology) table (tests/test_sc_scale.py)
FUZZ = [(0, 2, 12, "chain"), (1, 3, 14, "chain"), (2, 4, 16, "star"), (5, 3, 10, "star")]
FUZZ_IDS = ["s%d_k%d_S%d_%s" % c for c in FUZZ]


def write_clones(workdir, seed, n_clones, n_segments, topology="chain"):
    """The sample's clone files; returns (ScCase, names, evolution edges)."""
    sc = simulate_sc_case(seed=seed, n_clones=n_clones, n_segments=n_segments, topology=topology)
    return (sc, *write_sc_clones(sc, os.path.join(str(workdir), "s%d_clone" % seed)))


def two_clone_fixture(workdir):
    """egfr6 and a clone with one fewer inner loop
    (tests/test_cli_and_sc.py)."""
    text = open(EGFR6).read()
    text = text.replace("SEG H:3:chr7:55283001:55284000 240.0 8.0", "SEG H:3:chr7:55283001:55284000 180.0 6.0")
    text = text.replace("SEG H:4:chr7:55284001:55285000 240.0 8.0", "SEG H:4:chr7:55284001:55285000 180.0 6.0")
    text = text.replace("JUNC H:3:- H:3:+ 30.0 1.0 U B", "JUNC H:3:- H:3:+ 30.0 0.0 U B")
    lh2 = os.path.join(str(workdir), "clone2.lh")
    with open(lh2, "w") as f:
        f.write(text)
    return "%s,%s" % (EGFR6, lh2)


def assert_programs_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("edges_kind", ["dag", "all-pairs"])
@pytest.mark.parametrize("case", FUZZ, ids=FUZZ_IDS)
def test_extract_sc_programs_match_jax(case, edges_kind, tmp_path):
    """Every array of every block program, the coupling pairs included;
    an empty edges string is the all-pairs default, a different
    program."""
    _, names, edges = write_clones(tmp_path, *case)
    if edges_kind == "all-pairs":
        edges = ""
    got = tsc.extract_sc_programs(",".join(names), edges)
    want = jsc.extract_sc_programs(",".join(names), edges)
    assert len(got) == len(want) and any(p is not None for p in want)
    K = case[1]
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert_programs_equal(g, w)
            n_edges = K - 1 if edges_kind == "dag" else K * (K - 1) // 2
            assert g.num_coupling == n_edges * (g.num_vars // K)


def test_build_sc_program_memory_discipline_case_matches_jax():
    """K=4 x S=64 (tests/test_sc_scale.py): G int8 block-diagonal,
    coupling as index pairs, equal to the JAX block program."""
    from ambigram_tpu.engine.ilp import build_bfb_program as jbuild
    from ambigram_tpu_torch.engine.ilp import build_bfb_program as tbuild

    K, S = 4, 64
    rng = np.random.default_rng(0)
    profiles = []
    for _ in range(K):
        seg = rng.integers(1, 9, size=S).astype(np.float64)
        profiles.append((seg, rng.integers(0, 3, size=S).astype(np.float64)))
    evolution = [[1, 2, 3], [2], [3], []]
    want = jsc.build_sc_program([jbuild(1, S, s, f, float(s.sum()), 0) for s, f in profiles], evolution)
    got = tsc.build_sc_program([tbuild(1, S, s, f, float(s.sum()), 0) for s, f in profiles], evolution)
    assert got.G.dtype == np.int8 and got.num_vars == K * S * (S + 1)
    assert_programs_equal(got, want)


NAMES = ["a.lh", "b.lh", "c.lh"]
COLON_NAMES = ["/data/run:3/c1.lh", "/data/run:3/c2.lh"]


@pytest.mark.parametrize(
    "edges, names, expected",
    [
        ("a.lh:b.lh,a.lh:c.lh", NAMES, [[1, 2], [], []]),
        ("1:2,2:3", NAMES, [[1], [2], []]),
        ("", NAMES, [[1, 2], [2], []]),
        ("/data/run:3/c1.lh:/data/run:3/c2.lh", COLON_NAMES, [[1], []]),
        ("1:2,2:1,1:2", NAMES, [[1], [], []]),
        ("a.lh:nope.lh", NAMES, "cannot resolve"),
        ("a.lh", NAMES, "not parent:child"),
        ("1:1", NAMES, "itself"),
        ("a.lh:b.lh:c.lh", ["a.lh", "b.lh:c.lh", "a.lh:b.lh", "c.lh"], "ambiguous"),
    ],
    ids=["names", "indices", "all-pairs", "colon-names", "duplicates", "unknown", "no-colon", "self", "ambiguous"],
)
def test_parse_evolution_edges_matches_jax(edges, names, expected):
    if isinstance(expected, str):
        with pytest.raises(ValueError, match=expected):
            jsc.parse_evolution_edges(edges, names)
        with pytest.raises(ValueError, match=expected):
            tsc.parse_evolution_edges(edges, names)
    else:
        assert jsc.parse_evolution_edges(edges, names) == expected
        assert tsc.parse_evolution_edges(edges, names) == expected


def block_program(tmp_path, case):
    _, names, edges = write_clones(tmp_path, *case)
    return [p for p in jsc.extract_sc_programs(",".join(names), edges) if p is not None][0]


@pytest.mark.parametrize("case", FUZZ, ids=FUZZ_IDS)
def test_block_program_scoring_tensors_match_jax(case, tmp_path):
    """H8, w, lb_raw/ub_raw and the coupling rows (+-1, weight 1, target
    0) bitwise; the block program stays int8-exact."""
    prog = block_program(tmp_path, case)
    jst = jscore.scoring_tensors(prog)
    tst = tscore.scoring_tensors(prog, "cpu")
    assert_tensors_equal(tst, jst)
    assert tst.int8_ok and tscore.k1_planes(tst) == 1
    R0 = prog.A_seg.shape[0] + prog.A_fbi.shape[0]
    P = prog.num_coupling
    assert tst.num_residual_rows == R0 + P
    w = tst.w.numpy()[R0 : R0 + P]
    assert (w == 1.0).all()
    assert (tst.lb_raw.numpy()[R0 : R0 + P] == 0).all() and (tst.ub_raw.numpy()[R0 : R0 + P] == 0).all()
    rows = tst.H8.numpy()[R0 : R0 + P, : prog.num_vars].astype(np.int64)
    np.testing.assert_array_equal(rows, prog.coupling_rows_dense(np.int64))


def search_like_candidates(prog, Vp, B, seed=3):
    """B candidates shaped like the search's: the LP-seeded population,
    each member kicked at 4 variables by +-1/+-2, clipped to the box."""
    from ambigram_tpu_torch.solver.host import _seed_case

    x_ub = np.zeros(Vp, dtype=np.float32)
    x_ub[: prog.num_vars] = prog.x_ub
    X, _ = _seed_case(prog, Vp, x_ub, B, seed)
    rng = np.random.default_rng(seed)
    for b in range(B):
        np.add.at(X[b], rng.integers(0, prog.num_vars, size=4), rng.choice([-2.0, -1.0, 1.0, 2.0], size=4))
    return np.clip(X, 0.0, x_ub).astype(np.float32)


@pytest.mark.parametrize("case", FUZZ[1:3], ids=FUZZ_IDS[1:3])
def test_k1_plain_versions_on_block_program_match_pallas(case, tmp_path):
    """K1's plain f32 and int8 versions against the Pallas scorer in
    interpret mode (as tests/test_solver.py runs it on the CPU)."""
    prog = block_program(tmp_path, case)
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    X = search_like_candidates(prog, tst.H.shape[1], 256)
    want = np.asarray(jscore.score_batch_pallas(jst, X, block_b=256))
    assert float(want.max()) < 2.0**24  # every f32 sum exact
    s_plain, hx_plain = tscore.score_rows_plain(tst, torch.as_tensor(X), want_hx=True)
    s_i8, hx_i8 = tscore.score_rows_int8_plain(tst, torch.as_tensor(X), want_hx=True)
    np.testing.assert_array_equal(s_plain.numpy(), want)
    np.testing.assert_array_equal(s_i8.numpy(), want)
    assert torch.equal(hx_plain, hx_i8)
    hx64 = X.astype(np.float64) @ np.asarray(jst.H, dtype=np.float64).T
    np.testing.assert_array_equal(hx_plain.numpy(), hx64.astype(np.float32))


def test_stack_cases_of_two_samples_matches_jax(tmp_path):
    """Two K=3 samples of one interval form one case-stacked group (the
    grouping of an sc: manifest); the stacked tensors equal JAX's."""
    progs = [block_program(tmp_path, (seed, 3, 14, "chain")) for seed in (1, 6)]
    assert len({(p.start, p.end, p.num_vars) for p in progs}) == 1
    jst = jmesh.stack_cases(progs)
    tst = stack_cases(progs, "cpu")
    assert tuple(tst.H.shape) == tuple(jst.H.shape) and tst.H.dim() == 3
    for k in LEAVES:
        got, want = getattr(tst, k).numpy(), np.asarray(getattr(jst, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in STATIC:
        assert getattr(tst, k) == getattr(jst, k), k


def run_both(lh_paths, edges, **kw):
    out_t, out_j = io.StringIO(), io.StringIO()
    got = tsc.run_sc_bfb(lh_paths, solver="exact", device="cpu", edges=edges, out=out_t, **kw)
    want = jsc.run_sc_bfb(lh_paths, solver="exact", edges=edges, out=out_j, **kw)
    return got, want, out_t.getvalue(), out_j.getvalue()


def test_run_sc_bfb_exact_two_clone_fixture_matches_jax(tmp_path):
    got, want, text_t, text_j = run_both(two_clone_fixture(tmp_path), "")
    assert got.path_strings == want.path_strings
    assert got.path_strings[0][0] == GOLDEN_EGFR6
    assert text_t == text_j


@pytest.mark.parametrize("case", FUZZ, ids=FUZZ_IDS)
def test_run_sc_bfb_exact_fuzz_matches_jax(case, tmp_path):
    sc, names, edges = write_clones(tmp_path, *case)
    got, want, text_t, text_j = run_both(",".join(names), edges)
    assert got.path_strings == want.path_strings
    assert text_t == text_j
    for k, clone in enumerate(sc.cases):
        assert multiplicity_diff(clone.truth_string, got.path_strings[k][0]) == 0


@pytest.fixture
def small_search(monkeypatch):
    """The search budgets of tests/test_sc_scale.py's device-regime test."""
    monkeypatch.setenv("AMBIGRAM_SEARCH_POP", "8")
    monkeypatch.setenv("AMBIGRAM_SEARCH_ROUNDS", "2")
    monkeypatch.setenv("AMBIGRAM_SEARCH_SWEEPS", "64")
    monkeypatch.setenv("AMBIGRAM_LNS_BUDGET", "60")


@pytest.mark.parametrize("case", FUZZ, ids=FUZZ_IDS)
def test_run_sc_bfb_device_on_cpu_recovers_every_clone(case, tmp_path, small_search):
    sc, names, edges = write_clones(tmp_path, *case)
    GLOBAL.reset()
    res = tsc.run_sc_bfb(",".join(names), solver="device", device="cpu", edges=edges)
    assert GLOBAL.counters.get("solve.device_calls", 0) >= 1
    for k, clone in enumerate(sc.cases):
        assert res.path_strings[k], "clone %d produced no path" % k
        assert multiplicity_diff(clone.truth_string, res.path_strings[k][0]) == 0


@pytest.mark.parametrize("case", FUZZ, ids=FUZZ_IDS)
def test_run_sc_bfb_device_reaches_the_cross_clone_lns(case, tmp_path, small_search, monkeypatch):
    """With an all-zero seed population and one sweep the search leaves
    an incumbent short of the certificate, so the host tail's LNS polish
    runs on the block program, with its masks replicated over the K
    clone blocks, and must still recover every clone's truth."""
    monkeypatch.setenv("AMBIGRAM_SEARCH_ROUNDS", "1")
    monkeypatch.setenv("AMBIGRAM_SEARCH_SWEEPS", "1")
    seed_case = search._seed_case

    def zero_population(prog, Vp, x_ub, pop, seed):
        X, lb = seed_case(prog, Vp, x_ub, pop, seed)
        return np.zeros_like(X), lb

    blocks = []
    num_blocks = lns._num_blocks

    def spy_blocks(prog):
        blocks.append(num_blocks(prog))
        return blocks[-1]

    monkeypatch.setattr(search, "_seed_case", zero_population)
    monkeypatch.setattr(lns, "_num_blocks", spy_blocks)
    sc, names, edges = write_clones(tmp_path, *case)
    GLOBAL.reset()
    res = tsc.run_sc_bfb(",".join(names), solver="device", device="cpu", edges=edges)
    assert GLOBAL.counters.get("solve.device_calls", 0) >= 1
    assert "solve.lns" in GLOBAL.phases
    assert blocks and set(blocks) == {case[1]}
    for k, clone in enumerate(sc.cases):
        assert multiplicity_diff(clone.truth_string, res.path_strings[k][0]) == 0


def make_samples(tmp_path, seeds, n_clones=2, n_segments=10):
    samples, cases = [], []
    for seed in seeds:
        d = tmp_path / ("sample%d" % seed)
        d.mkdir()
        sc, names, edges = write_clones(d, seed, n_clones, n_segments)
        samples.append({"lh_paths": ",".join(names), "edges": edges})
        cases.append(sc)
    return samples, cases


def test_run_sc_bfb_many_matches_serial_and_resumes_from_store(tmp_path):
    samples, _ = make_samples(tmp_path, (0, 1))
    serial = [tsc.run_sc_bfb(s["lh_paths"], solver="exact", device="cpu", edges=s["edges"]) for s in samples]
    want = jsc.run_sc_bfb_many(samples, solver="exact")
    store = str(tmp_path / "store")
    out = io.StringIO()
    batch = tsc.run_sc_bfb_many(samples, solver="exact", device="cpu", result_store=store, out=out)
    assert [b.path_strings for b in batch] == [s.path_strings for s in serial] == [w.path_strings for w in want]
    assert all(p in out.getvalue().splitlines() for b in batch for c in b.path_strings for p in c)
    files = set(os.listdir(store))
    assert len(files) == 2 and all("-sc-" in f for f in files)
    # the store's files are the JAX package's: either package resumes the other's
    assert sorted(files) == sorted(jsc._sc_store_key(s) + ".json" for s in samples)
    GLOBAL.reset()
    batch2 = tsc.run_sc_bfb_many(samples, solver="exact", device="cpu", result_store=store)
    assert set(os.listdir(store)) == files
    assert [b.path_strings for b in batch2] == [s.path_strings for s in serial]
    assert "solve.exact" not in GLOBAL.phases


def test_run_sc_bfb_many_case_stacks_samples_of_one_interval(tmp_path, small_search):
    """Two samples of one interval search as ONE case-stacked group, and
    each clone's path is replayed from its own slice of the solution."""
    samples, cases = make_samples(tmp_path, (1, 6), n_clones=3, n_segments=14)
    GLOBAL.reset()
    res = tsc.run_sc_bfb_many(samples, solver="device", device="cpu")
    assert GLOBAL.counters["solve.device_calls"] == 1
    for r, sc in zip(res, cases):
        for k, clone in enumerate(sc.cases):
            assert multiplicity_diff(clone.truth_string, r.path_strings[k][0]) == 0


def test_cli_sc_bfb_matches_jax_cli(tmp_path, capsys):
    from ambigram_tpu.cli import main as jmain

    lh_paths = two_clone_fixture(tmp_path)
    argv = ["--op", "sc_bfb", "--in_lh", lh_paths, "--solver", "exact", "--no-ledgers"]
    assert jmain(argv) == 0
    want = capsys.readouterr().out
    res = cli.run(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert res.path_strings[0][0] == GOLDEN_EGFR6 and want.splitlines()[0] == GOLDEN_EGFR6


def test_cli_manifest_with_sc_lines_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """A manifest of a bulk case and two sc: samples: the same stdout,
    summary lines and result store as the JAX CLI, and ledgers in the
    working directory."""
    from ambigram_tpu.cli import main as jmain

    samples, _ = make_samples(tmp_path, (0, 1))
    manifest = tmp_path / "cases.manifest"
    manifest.write_text(
        "# one bulk case, two single-cell samples\n%s\n" % EGFR6
        + "".join("sc:%s edges=%s\n" % (s["lh_paths"], s["edges"]) for s in samples)
    )
    monkeypatch.chdir(tmp_path)
    argv = ["--op", "bfb", "--in_lh", str(manifest), "--solver", "exact"]
    assert jmain(argv + ["--result_store", str(tmp_path / "jstore")]) == 0
    want = capsys.readouterr()
    os.rename("time.csv", "time.jax.csv")
    res = cli.run(argv + ["--result_store", str(tmp_path / "tstore"), "--device", "cpu"])
    got = capsys.readouterr()
    assert len(res) == 3
    assert got.out == want.out and GOLDEN_EGFR6 in got.out
    summary = [line for line in got.err.splitlines() if line.startswith("## ")]
    assert summary == [line for line in want.err.splitlines() if line.startswith("## ")]
    assert summary[-1] == "## manifest complete: 3 case(s)"
    assert sum(line.startswith("## sc:") for line in summary) == 2
    assert sorted(os.listdir("tstore")) == sorted(os.listdir("jstore"))
    assert len(open("time.csv").read().splitlines()) == len(open("time.jax.csv").read().splitlines()) == 3


def test_run_sc_bfb_on_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsc.run_sc_bfb(two_clone_fixture(tmp_path), solver="exact", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsc.run_sc_bfb_many([{"lh_paths": two_clone_fixture(tmp_path), "edges": ""}], device="cuda")


def test_evaluate_copy_matches_jax():
    """`multiplicity_diff` and `junction_score`, which the card checks
    hold each clone's path against, equal the JAX package's."""
    from ambigram_tpu.scripts import evaluate as jev
    from ambigram_tpu_torch.scripts import evaluate as tev

    truth = "1+2+3+4+|4-3-2-|2+3+4+5+|5-4-3-2-1-"
    for pred in (truth, GOLDEN_EGFR6, "1+2+3+|3-2-1-", ""):
        assert tev.multiplicity_diff(truth, pred) == jev.multiplicity_diff(truth, pred)
        assert dataclasses.asdict(tev.junction_score(truth, pred)) == dataclasses.asdict(jev.junction_score(truth, pred))
    assert tev.multiplicity_diff(truth, truth) == 0


def test_bench_sc_samples_are_the_jax_legs(tmp_path):
    """The port bench's sc leg runs the JAX leg's samples: 6 samples of
    K=3 clones at S=24, seeds 700-705, chain and star alternating, the
    all-pairs default; each block program (V=1800) is small enough for
    auto's exact prepass, as in the JAX leg."""
    from ambigram_tpu_torch import bench

    samples = bench.sc_samples(str(tmp_path))
    assert len(samples) == 6
    for s, sample in enumerate(samples):
        sc = simulate_sc_case(seed=700 + s, n_clones=3, n_segments=24, topology="chain" if s % 2 == 0 else "star")
        names = sample["lh_paths"].split(",")
        assert sample["edges"] == "" and len(names) == 3
        assert [open(n).read() for n in names] == [c.lh_text for c in sc.cases]
        progs = [p for p in tsc.extract_sc_programs(sample["lh_paths"], "") if p is not None]
        assert [p.num_vars for p in progs] == [1800]
        assert progs[0].num_vars <= pipeline.AUTO_EXACT_FIRST_MAX_VARS


@pytest.mark.parametrize(
    "mode, rc, message",
    [("sc", 1, "needs an NVIDIA GPU"), ("big", 1, "needs an NVIDIA GPU"), ("proxy", 2, "is not a mode of the bench")],
)
def test_bench_sc_mode_is_ported_and_needs_a_card(mode, rc, message, monkeypatch, capsys):
    """AMBIGRAM_BENCH_SUITE=sc and =big are ported modes: without a card
    they fail as the bench's other modes do, never running on the CPU; a
    value that is no mode (the scaling proxy runs in the default mode, as
    in the JAX bench, and has no mode of its own) exits 2."""
    from ambigram_tpu_torch import bench

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("AMBIGRAM_BENCH_SUITE", mode)
    assert bench.main() == rc
    captured = capsys.readouterr()
    assert message in captured.err and captured.out == ""


def _broken_leg():
    raise RuntimeError("K1 did not build")


@pytest.mark.parametrize("leg, rc, message", [
    (lambda: {"solved": 6}, 0, '{"metric": "sc_batch_throughput", "solved": 6}'),
    (_broken_leg, 1, "sc_batch_throughput failed: RuntimeError('K1 did not build')"),
], ids=["finished", "failed"])
def test_bench_exit_code_follows_the_sc_leg(leg, rc, message, monkeypatch, capsys):
    """The chain's result line goes out before the sc leg runs; the leg's
    line or its failure goes to stderr, and a failed leg makes the bench
    exit 1. The card and the chain are stubbed, the leg's outcome is
    forced."""
    from types import SimpleNamespace

    from ambigram_tpu_torch import bench

    monkeypatch.setenv("AMBIGRAM_BENCH_SUITE", "sc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stub")
    monkeypatch.setattr(bench, "card_line", lambda: "stub, 700.00 W")
    st = SimpleNamespace(H8=torch.zeros(4, 8, dtype=torch.int8))
    monkeypatch.setattr(bench, "build_workload", lambda device: (None, st, None))
    monkeypatch.setattr(bench, "bench_device", lambda st, X: (1.0, 0.0, "stub"))
    monkeypatch.setattr(bench, "bench_baseline", lambda prog, X: 1.0)
    monkeypatch.setattr(bench, "bench_sc", leg)
    assert bench.main() == rc
    captured = capsys.readouterr()
    assert captured.out.count("\n") == 1 and '"metric": "bfb_candidates_scored_per_sec_per_chip"' in captured.out
    assert message in captured.err
