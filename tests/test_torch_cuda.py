"""Card-only checks of the port: K1 and K2 on the GPU, the int8 scorer,
the search, the batch path, the single-cell slice and the sharded step
on logical meshes (and on distinct cards where there are several) on
cuda.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither jax nor a test module that does, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

from ambigram_tpu_torch import bench
from ambigram_tpu_torch.engine.pipeline import extract_programs
from ambigram_tpu_torch.parallel.mesh import stack_cases
from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case
from ambigram_tpu_torch.solver import search
from ambigram_tpu_torch.solver.score import (
    ScoringTensors,
    chained_score,
    chained_score_plain,
    k1_planes,
    score_batch,
    score_rows,
    score_rows_plain,
    scoring_tensors,
)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def simulated_prog(tmp_path, seed, n_segments, **kw):
    case = simulate_bfb_case(seed=seed, n_segments=n_segments, **kw)
    return extract_programs(write_case(case, str(tmp_path / ("s%d_%d" % (n_segments, seed))))["lh"])[0]


@pytest.mark.parametrize("B", [1, 32, 511, 1000])
def test_score_rows_kernel_matches_plain(cuda_device, tmp_path, B):
    """K1 (its int8 tensor-core path) against its plain version for
    ragged batches of sparse candidates on a noise-free case (integer
    targets, scores below 2^22: every f32 sum is exact), so hx and scores
    are bitwise equal."""
    prog = simulated_prog(tmp_path, seed=2, n_segments=24, mode="nested")
    st = scoring_tensors(prog, cuda_device)
    assert k1_planes(st) == 1
    rng = np.random.default_rng(B)
    Vp = st.H.shape[1]
    X = np.zeros((B, Vp), dtype=np.float32)
    X[:, : prog.num_vars] = np.minimum(rng.integers(0, 3, size=(B, prog.num_vars)), prog.x_ub)
    X *= rng.random((B, Vp)) < 0.05
    X = torch.as_tensor(X).to(cuda_device)
    before, before_i8 = score_rows.launches, score_rows.int8_launches
    s_k, hx_k = score_rows(st, X, want_hx=True)
    assert score_rows.launches == before + 1 and score_rows.int8_launches == before_i8 + 1
    s_p, hx_p = score_rows_plain(st, X, want_hx=True)
    torch.cuda.synchronize()
    assert float(s_p.max()) < 2.0**22
    assert torch.equal(hx_k, hx_p)
    assert torch.equal(s_k, s_p)
    s_only, no_hx = score_rows(st, X)
    assert no_hx is None and torch.equal(s_only, s_k)


# B crosses the f32 path's regimes: the streaming kernel up to 64
# candidates (32 or 64 a block), the tiled kernel above
F32_BATCHES = (1, 7, 32, 33, 64, 65, 300, 1000)


@pytest.mark.parametrize(
    "path, B, want_hx",
    [("f32", B, want_hx) for B in F32_BATCHES for want_hx in (True, False)] + [("int8_two_planes", 300, True)],
)
def test_score_rows_kernel_other_paths_match_plain(cuda_device, tmp_path, path, B, want_hx):
    """K1's f32 FFMA path on rows that are not int8-exact (a 0.25
    coefficient), at batches on both sides of its regime boundary, with
    and without hx, and its int8 path with two candidate planes (a box
    past 255): hx bitwise equal to the plain version. The scores are
    bitwise equal wherever they stay on the exact f32 lattice (below
    2^23); the large loop counts push some past it, where the two
    versions' f32 row sums round in different orders (rel 1e-6). Without
    hx the kernel returns the same scores bitwise."""
    import dataclasses

    prog = simulated_prog(tmp_path, seed=2, n_segments=24, mode="nested")
    rng = np.random.default_rng(17)
    if path == "f32":
        prog = dataclasses.replace(prog, A_fbi=prog.A_fbi * 0.5)
    else:
        prog.x_ub = prog.x_ub.copy()
        prog.x_ub[len(prog.pairs):] = 400
    st = scoring_tensors(prog, cuda_device)
    assert k1_planes(st) == (0 if path == "f32" else 2)
    Vp, T = st.H.shape[1], len(prog.pairs)
    X = np.zeros((B, Vp), dtype=np.float32)
    X[:, : prog.num_vars] = np.minimum(rng.integers(0, 2, size=(B, prog.num_vars)), prog.x_ub)
    X *= rng.random((B, Vp)) < 0.05
    if path != "f32":
        X[np.arange(B), T + rng.integers(0, T, size=B)] = rng.integers(256, 401, size=B)
    X = torch.as_tensor(X).to(cuda_device)
    counter = "f32_launches" if path == "f32" else "int8_launches"
    before = getattr(score_rows, counter)
    s_k, hx_k = score_rows(st, X, want_hx=True)
    assert getattr(score_rows, counter) == before + 1
    s_p, hx_p = score_rows_plain(st, X, want_hx=True)
    torch.cuda.synchronize()
    assert torch.equal(hx_k, hx_p)
    exact = s_p < 2.0**23
    assert int(exact.sum()) >= 1
    assert torch.equal(s_k[exact], s_p[exact])
    assert float(((s_k - s_p).abs() / s_p.abs().clamp(min=1.0)).max()) <= 1e-6
    if not want_hx:
        s_only, no_hx = score_rows(st, X)
        assert no_hx is None and torch.equal(s_only, s_k)


def dyadic_rows(rng, rows, vp, device):
    """A ScoringTensors that only K1's f32 path reads: H [rows, vp] of
    multiples of 0.25 in [-2, 2], half of them 0, and integer row bounds
    (lb = ub on the first half of the rows, open ub on the rest). Every
    product and partial sum of a small integer candidate is exact in f32,
    so hx and scores are bitwise in any order."""
    H = (rng.integers(-8, 9, size=(rows, vp)) * (rng.random((rows, vp)) < 0.5) / 4.0).astype(np.float32)
    lb = rng.integers(-4, 5, size=rows).astype(np.float32)
    ub = lb.copy()
    ub[rows // 2 :] = 3.0e38
    z = np.zeros((1, vp), dtype=np.float32)
    return ScoringTensors.from_numpy(
        H=H, lb=lb, ub=ub, x_ub=np.full(vp, 3.0, np.float32), H8=z.astype(np.int8), lb_raw=lb, ub_raw=ub,
        w=np.zeros(rows, np.float32), num_vars=vp, num_residual_rows=rows, int8_ok=False, x_ub_max=3.0,
        device=device,
    )


@pytest.mark.parametrize("rows, vp", [(1000, 999), (1000, 1000), (777, 1284)])
@pytest.mark.parametrize("B", [7, 33, 65])
def test_score_rows_f32_ragged_shapes(cuda_device, rows, vp, B):
    """K1's f32 path at ragged Rows and Vp on both sides of its regime
    boundary: a Vp that is not a multiple of 4 takes 4-byte copies, and
    so does a candidate block that is not 16-byte aligned (X one float
    into a buffer); hx and scores bitwise equal to the plain version."""
    rng = np.random.default_rng(rows + vp + B)
    st = dyadic_rows(rng, rows, vp, cuda_device)
    assert k1_planes(st) == 0
    X = torch.as_tensor(rng.integers(0, 4, size=(B, vp)).astype(np.float32)).to(cuda_device)
    s_p, hx_p = score_rows_plain(st, X, want_hx=True)
    shifted = torch.empty(B * vp + 1, dtype=torch.float32, device=cuda_device)[1:].view(B, vp)
    shifted.copy_(X)
    for Xk in (X, shifted):
        before = score_rows.f32_launches
        s_k, hx_k = score_rows(st, Xk, want_hx=True)
        assert score_rows.f32_launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(hx_k, hx_p) and torch.equal(s_k, s_p)


@pytest.mark.parametrize("B", [32, 65])
def test_batched_f32_score_rows_is_bitwise(cuda_device, tmp_path, B):
    """K1's f32 path with a case axis (G = 3 stacked programs with FBI
    coefficients halved, so no case is int8-exact) against one
    single-case launch per case and the plain loop, in both regimes."""
    import dataclasses

    progs = [simulated_prog(tmp_path, seed=s, n_segments=n, mode="nested") for s, n in ((2, 24), (3, 20), (4, 24))]
    progs = [dataclasses.replace(p, A_fbi=p.A_fbi * 0.5) for p in progs]
    st = stack_cases(progs, cuda_device)
    assert not st.int8_ok and k1_planes(st) == 0
    rng = np.random.default_rng(B)
    G, rows, Vp = st.H.shape
    X = np.zeros((G, B, Vp), dtype=np.float32)
    for g, prog in enumerate(progs):
        X[g, :, : prog.num_vars] = np.minimum(rng.integers(0, 3, size=(B, prog.num_vars)), prog.x_ub)
    X *= rng.random(X.shape) < 0.05
    X = torch.as_tensor(X).to(cuda_device)
    before = score_rows.f32_launches
    s_b, hx_b = score_rows(st, X, want_hx=True)
    assert score_rows.f32_launches == before + 1
    s_p, hx_p = score_rows_plain(st, X, want_hx=True)
    torch.cuda.synchronize()
    assert float(s_p.max()) < 2.0**22
    assert torch.equal(hx_b, hx_p) and torch.equal(s_b, s_p)
    for g in range(G):
        s_g, hx_g = score_rows(st.case(g), X[g].contiguous(), want_hx=True)
        assert torch.equal(s_g, s_b[g]) and torch.equal(hx_g, hx_b[g])


@pytest.mark.parametrize("B", [32, 1000])
def test_score_rows_f32_on_the_noisy_s48_case(cuda_device, tmp_path, B):
    """K1's f32 path on the S=48 seed-0 suite case (noise 0.05) with its
    FBI coefficients halved, at search-like candidates: hx bitwise equal
    to the plain version (every partial sum is a multiple of 0.25 below
    2^24), the scores within rel 1e-5 (fractional targets: the hinges
    round, and the two versions sum them in different orders)."""
    import dataclasses

    from ambigram_tpu_torch.solver.host import _seed_case

    prog = simulated_prog(tmp_path, seed=0, n_segments=48, rounds=5, coverage=30.0, mode="process", noise=0.05)
    prog = dataclasses.replace(prog, A_fbi=prog.A_fbi * 0.5)
    st = scoring_tensors(prog, cuda_device)
    assert k1_planes(st) == 0
    x_ub = st.x_ub.cpu().numpy()
    X, _ = _seed_case(prog, len(x_ub), x_ub, B, 2)
    rng = np.random.default_rng(B)
    for b in range(B):
        np.add.at(X[b], rng.integers(0, prog.num_vars, size=4), rng.choice([-2.0, -1.0, 1.0, 2.0], size=4))
    X = torch.as_tensor(np.clip(X, 0.0, x_ub).astype(np.float32)).to(cuda_device)
    s_k, hx_k = score_rows(st, X, want_hx=True)
    s_p, hx_p = score_rows_plain(st, X, want_hx=True)
    torch.cuda.synchronize()
    assert torch.equal(hx_k, hx_p)
    assert float(((s_k - s_p).abs() / s_p.abs().clamp(min=1.0)).max()) <= 1e-5


@pytest.mark.slow
def test_bounded_s128_search_on_card(cuda_device, tmp_path):
    """The big leg's recipe at S=128 (seed 428, noise 0.05) fails the
    int8 gate, so a bounded device search (one round, one sweep, no
    polish, no certificate) rescores through K1's f32 path only: at
    least two launches (the first scoring and the rescoring after the
    kick), none on the int8 path, and an integral x inside the box."""
    from ambigram_tpu_torch.solver.score import reset_launch_counts

    prog = extract_programs(bench.big_case_path(str(tmp_path), 128))[0]
    assert k1_planes(scoring_tensors(prog, "cpu", need_f32=False)) == 0
    reset_launch_counts()
    res = search.solve_device(prog, device="cuda", rounds=1, max_sweeps=1, polish=False, certify=False)
    assert score_rows.f32_launches >= 2 and score_rows.int8_launches == 0
    x = np.asarray(res.x, dtype=np.float64)
    assert np.array_equal(x, np.round(x)) and (x >= 0).all() and (x <= prog.x_ub).all()


def test_search_on_cuda_follows_the_cpu_trajectory(cuda_device, monkeypatch):
    """The kicks come from a CPU generator and every sum is exact on
    egfr6, so the search takes the same path on cuda as on the CPU."""
    monkeypatch.setenv("AMBIGRAM_SEARCH_POP", "8")
    monkeypatch.setenv("AMBIGRAM_SEARCH_ROUNDS", "3")
    prog = extract_programs(os.path.join(DATA, "egfr6.lh"))[0]
    d_gpu = search._dispatch([prog], [0], [0], cuda_device)
    d_cpu = search._dispatch([prog], [0], [0], torch.device("cpu"))
    assert np.array_equal(d_gpu["best_x"].cpu().numpy(), d_cpu["best_x"].numpy())
    assert torch.equal(d_gpu["best_s"].cpu(), d_cpu["best_s"])
    assert d_gpu["sweeps"] == d_cpu["sweeps"]


def _determinism_prog():
    """The program of tests/test_determinism.py."""
    from ambigram_tpu_torch.engine.ilp import build_bfb_program

    seg = np.array([2.0, 6.0, 8.0, 8.0, 4.0, 4.0])
    fbi = np.array([0.0, 2.0, 1.0, 2.0, 0.0, 2.0])
    return build_bfb_program(1, 6, seg, fbi, 32, 1)


@pytest.mark.parametrize("case", ["determinism_prog", "s48_seed0_noisy"])
def test_device_search_deterministic_on_cuda(cuda_device, tmp_path, case):
    """solve_device(prog, seed=3) twice on the card gives the same x and
    eps: on the program of tests/test_determinism.py at the default
    budgets, and on the noisy S=48 seed-0 case (fractional targets, so
    an unordered reduction in a sweep would show) without the
    wall-clock LNS polish."""
    if case == "determinism_prog":
        prog, kw = _determinism_prog(), {}
    else:
        prog = simulated_prog(tmp_path, 0, 48, rounds=5, coverage=30.0, mode="process", noise=0.05)
        kw = {"polish": False}
    r1 = search.solve_device(prog, seed=3, device=cuda_device, **kw)
    r2 = search.solve_device(prog, seed=3, device=cuda_device, **kw)
    assert np.array_equal(r1.x, r2.x)
    assert r1.epsilon_sum == r2.epsilon_sum


@pytest.mark.slow
def test_s48_suite_on_card(cuda_device, tmp_path):
    """The repo's 4xS48 suite (bench.py's recipe) through the port's
    auto path: 4/4 solved at eps_sum <= 35.48, the value of the host
    MILP and of the JAX auto path on these cases."""
    from ambigram_tpu_torch.engine.pipeline import _solve

    eps_sum, solved = 0.0, 0
    for seed in range(4):
        prog = simulated_prog(tmp_path, seed, 48, rounds=5, coverage=30.0, mode="process", noise=0.05)
        assert prog.num_vars > 2048
        r = _solve(prog, "auto", cuda_device)
        if r.status in ("optimal", "heuristic") and float(prog.hard_violation(r.x.astype(np.float64))) == 0.0:
            eps_sum += r.epsilon_sum
            solved += 1
    assert solved == 4
    assert eps_sum <= 35.48 + 1e-3


def demo_int8_prog(n_segments):
    """The bench's demo program at `n_segments` (integer targets), with
    the loop box capped at 127 as the bench caps it."""
    from ambigram_tpu_torch.bench import _demo_program

    prog = _demo_program(n_segments)
    prog.x_ub = np.minimum(prog.x_ub, 127)
    return prog


@pytest.mark.parametrize("block_b", [64, 128])
def test_chained_score_kernel_matches_plain(cuda_device, block_b):
    """K2 against its plain version: on a small program every sum is
    exact; at the bench width (3840 x 1152) the scores pass 2^24 but both
    round each exact hinge sum once, so the final candidates are bitwise
    equal there too and only the checksum's summation order differs."""
    rng = np.random.default_rng(block_b)
    for n_segments, B, iters, rtol in ((10, 256, 5, 1e-6), (32, 1024, 8, 1e-5)):
        prog = demo_int8_prog(n_segments)
        st = scoring_tensors(prog, cuda_device)
        assert st.use_int8
        X = np.zeros((B, st.H8.shape[1]), dtype=np.float32)
        X[:, : prog.num_vars] = rng.integers(0, 3, size=(B, prog.num_vars))
        X = torch.as_tensor(X).to(cuda_device)
        before = chained_score.launches
        acc_k, x_k = chained_score(st, X, iters, block_b=block_b, want_x=True)
        assert chained_score.launches == before + 1
        acc_p, x_p = chained_score_plain(st, X, iters, want_x=True)
        torch.cuda.synchronize()
        assert torch.equal(x_k, x_p), n_segments
        assert float(acc_k) == pytest.approx(float(acc_p), rel=rtol)
        assert float(chained_score(st, X, iters, block_b=block_b)) == float(acc_k)  # deterministic
    with pytest.raises(ValueError, match="divisible"):
        chained_score(st, X[: B - 1], 1, block_b=block_b)


def test_int8_score_batch_on_cuda(cuda_device):
    """The int8 scorer runs on CUDA tensors and equals the CPU result
    bitwise, on egfr6 and on the bench program (scores above 2^24, summed
    exactly in f64 and rounded once)."""
    egfr = extract_programs(os.path.join(DATA, "egfr6.lh"))[0]
    for prog in (egfr, demo_int8_prog(32)):
        st_cpu = scoring_tensors(prog, "cpu")
        assert st_cpu.use_int8
        rng = np.random.default_rng(3)
        X = np.zeros((200, st_cpu.H8.shape[1]), dtype=np.float32)
        X[:, : prog.num_vars] = np.minimum(rng.integers(0, 3, size=(200, prog.num_vars)), prog.x_ub)
        want = score_batch(st_cpu, torch.as_tensor(X))
        got = score_batch(st_cpu.to(cuda_device), torch.as_tensor(X).to(cuda_device))
        assert got.is_cuda
        assert torch.equal(got.cpu(), want)


def test_batched_score_rows_kernel_is_bitwise(cuda_device, tmp_path):
    """K1 with a case axis (one launch for G = 3 stacked cases of mixed
    shape) against one single-case launch per case and the plain loop.
    The candidates are sparse, as in the single-case test, so the scores
    stay below 2^22 and every f32 sum is exact."""
    progs = [simulated_prog(tmp_path, seed=s, n_segments=n, mode="nested") for s, n in ((2, 24), (3, 20), (4, 24))]
    st = stack_cases(progs, cuda_device)
    rng = np.random.default_rng(9)
    G, rows, Vp = st.H.shape
    X = np.zeros((G, 100, Vp), dtype=np.float32)
    for g, prog in enumerate(progs):
        X[g, :, : prog.num_vars] = np.minimum(rng.integers(0, 3, size=(100, prog.num_vars)), prog.x_ub)
    X *= rng.random(X.shape) < 0.05
    X = torch.as_tensor(X).to(cuda_device)
    before = score_rows.launches
    s_b, hx_b = score_rows(st, X, want_hx=True)
    assert score_rows.launches == before + 1
    s_p, hx_p = score_rows_plain(st, X, want_hx=True)
    torch.cuda.synchronize()
    assert float(s_p.max()) < 2.0**22
    assert torch.equal(hx_b, hx_p) and torch.equal(s_b, s_p)
    for g in range(G):
        s_g, hx_g = score_rows(st.case(g), X[g].contiguous(), want_hx=True)
        assert torch.equal(s_g, s_b[g]) and torch.equal(hx_g, hx_b[g])


@pytest.mark.slow
def test_bench_batch_leg_on_card(cuda_device):
    """The bench's 16-case batch leg (mixed S=32/S=48, noise 0.05) through
    the port's case-stacked device path: 16/16 solved with no hard
    violation, at eps_sum <= 942.8 (5% above the JAX batch's 897.91, room
    for another random stream). The port measured 900.75 on an NVIDIA
    H100 80GB HBM3 at 700 W."""
    out = bench.bench_batch()
    print("batch_throughput %s" % json.dumps(out))
    leg = out["batch_device"]
    assert leg["solved"] == 16
    assert leg["max_hard_violation"] == 0.0
    assert leg["eps_sum"] <= 942.8


def test_sc_slice_on_card(cuda_device, tmp_path, monkeypatch):
    """The single-cell slice: K=3 clones at S=32 (seed 3, chain; its
    block program has 3168 variables) through the CLI's --op sc_bfb
    with its evolution edges and --solver auto. Auto sends it to the
    device search, every K1 launch takes the int8 path, the replayed
    solution reaches the host MILP's optimum (eps 8.0) with no hard
    violation, and each clone's simulated truth is recovered."""
    import contextlib
    import io

    from ambigram_tpu_torch import cli
    from ambigram_tpu_torch.engine import pipeline
    from ambigram_tpu_torch.scripts.evaluate import multiplicity_diff
    from ambigram_tpu_torch.scripts.simulate import simulate_sc_case, write_sc_clones
    from ambigram_tpu_torch.solver.score import reset_launch_counts
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    sc = simulate_sc_case(seed=3, n_clones=3, n_segments=32)
    names, edges = write_sc_clones(sc, str(tmp_path / "c"))
    solved = []
    solve = pipeline._solve

    def spy(prog, *args, **kw):
        solved.append((prog, solve(prog, *args, **kw)))
        return solved[-1][1]

    monkeypatch.setattr(pipeline, "_solve", spy)
    GLOBAL.reset()
    reset_launch_counts()
    buf = io.StringIO()
    argv = ["--op", "sc_bfb", "--in_lh", ",".join(names), "--edges", edges, "--solver", "auto",
            "--device", "cuda", "--no-ledgers"]
    with contextlib.redirect_stdout(buf):
        res = cli.run(argv)
    assert GLOBAL.counters.get("solve.device_calls", 0) >= 1
    assert score_rows.int8_launches >= 1 and score_rows.f32_launches == 0
    (prog, sol), = solved
    assert prog.num_vars == 3168
    x = sol.x.astype(np.float64)
    assert float(prog.hard_violation(x)) == 0.0
    assert float(prog.residual_objective(x)) <= 8.0 + 1e-4
    lines = buf.getvalue().splitlines()
    for k, case in enumerate(sc.cases):
        assert res.path_strings[k][0] in lines
        assert multiplicity_diff(case.truth_string, res.path_strings[k][0]) == 0


@pytest.mark.slow
def test_bench_sc_leg_on_card(cuda_device):
    """The bench's single-cell leg (6 samples, K=3, S=24, chain and star
    alternating): every sample solved in the batch leg and in the serial
    exact loop. Every block program (V=1800) settles in the batch's
    exact prepass, as in the JAX leg, so the search never runs."""
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    GLOBAL.reset()
    out = bench.bench_sc()
    assert out["batch"]["solved"] == 6
    assert out["serial"]["solved"] == 6
    assert GLOBAL.counters.get("solve.device_calls", 0) == 0


@pytest.mark.slow
def test_bench_big_leg_on_card(cuda_device):
    """The bench's big leg against the JAX device search's quality
    (docs/bench_big.json): at S=64 eps <= 3.78 (two decimals), at S=96 a
    feasible point with eps <= 98.32, hard violation 0 in both, and
    every K1 launch on the int8 path (one plane at S=64, two at S=96)."""
    out = bench.bench_big()
    print("large_s_device_vs_exact %s" % json.dumps(out))
    s64, s96 = out["S64"], out["S96"]
    assert (s64["vars"], s96["vars"]) == (4160, 9312)
    assert (s64["k1_planes"], s96["k1_planes"]) == (1, 2)
    assert s64["device"]["eps"] is not None and s64["device"]["eps"] <= 3.78
    assert s96["device"]["eps"] is not None and s96["device"]["eps"] <= 98.32
    for leg in (s64, s96):
        assert leg["device"]["hard_violation"] == 0.0
        assert leg["k1_launches"]["f32"] == 0 and leg["k1_launches"]["int8"] == leg["k1_launches"]["all"] >= 1


def proxy_programs(tmp_path):
    """The bench proxy leg's 8 cases (S=16, seeds 400-407, noise 0:
    integer targets, so every score is exact)."""
    d = tmp_path / "proxy"
    d.mkdir()
    bench.proxy_case_dir(str(d))
    return [extract_programs(str(d / ("sp%d.lh" % i)))[0] for i in range(8)]


def _step(progs, devices, X, shape):
    from ambigram_tpu_torch.parallel.mesh import make_mesh, shard_cases, sharded_step

    mesh = make_mesh(case_axis=shape[0], devices=devices)
    cases = shard_cases(stack_cases(progs), mesh)
    Xo, So = sharded_step(mesh)(cases, cases.put(X))
    return cases.gather(Xo), cases.gather(So)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 2)])
def test_sharded_step_on_logical_mesh_is_bitwise(cuda_device, tmp_path, shape):
    """The sharded step on a logical mesh of the card (every shard on
    cuda:0, K1's int8 path on each row shard) against the same step on
    CPU labels (K1's plain version): X' and the scores bitwise equal on
    the proxy's integer-target cases, every shard launch on the int8
    path."""
    from ambigram_tpu_torch.parallel.mesh import cpu_devices

    progs = proxy_programs(tmp_path)
    st = stack_cases(progs)
    rng = np.random.default_rng(5)
    x_ub = st.x_ub.numpy()
    X = np.minimum(rng.integers(0, 3, size=(8, 8, x_ub.shape[1])).astype(np.float32), x_ub[:, None, :])
    n = shape[0] * shape[1]
    before, before_i8 = score_rows.launches, score_rows.int8_launches
    Xc, Sc = _step(progs, [cuda_device] * n, X, shape)
    launches = score_rows.launches - before
    assert launches == 2 * n and score_rows.int8_launches - before_i8 == launches
    Xp, Sp = _step(progs, cpu_devices(n), X, shape)
    assert np.array_equal(Xc, Xp) and np.array_equal(Sc, Sp)
    assert (Xc != X).any()


def test_solve_cases_sharded_on_card_matches_cpu(cuda_device, tmp_path):
    """`solve_cases_sharded` on a logical (2, 2) mesh of the card returns
    the same best_x as on CPU labels, at the proxy's budgets."""
    from ambigram_tpu_torch.parallel.mesh import cpu_devices, make_mesh, solve_cases_sharded

    progs = proxy_programs(tmp_path)
    card = solve_cases_sharded(progs, mesh=make_mesh(devices=[cuda_device] * 4), pop=8, steps=12, rounds=2)
    cpu = solve_cases_sharded(progs, mesh=make_mesh(devices=cpu_devices(4)), pop=8, steps=12, rounds=2)
    assert all(np.array_equal(a, b) for a, b in zip(card, cpu))


def test_score_rows_counts_every_launch_across_threads(cuda_device, tmp_path):
    """N threads x M launches of K1 count N * M, under a short switch
    interval that would expose a lost update."""
    import sys
    import threading

    prog = simulated_prog(tmp_path, seed=2, n_segments=10, mode="nested")
    st = scoring_tensors(prog, cuda_device)
    X = torch.zeros((32, st.H.shape[1]), dtype=torch.float32, device=cuda_device)
    n_threads, m_calls = 8, 200
    before = score_rows.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [score_rows(st, X) for _ in range(m_calls)]) for _ in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert score_rows.launches - before == n_threads * m_calls


def test_sharded_step_on_distinct_cards(cuda_device, tmp_path):
    """With two cards or more: the step and `solve_cases_sharded` over
    distinct cards equal the same mesh shape on one card (skips with one
    card)."""
    from ambigram_tpu_torch.parallel.mesh import make_mesh, solve_cases_sharded, visible_devices

    cards = visible_devices()
    if len(cards) < 2:
        pytest.skip("needs two cards")
    n = 4 if len(cards) >= 4 else 2
    shape = (2, 2) if n == 4 else (1, 2)
    progs = proxy_programs(tmp_path)
    st = stack_cases(progs)
    rng = np.random.default_rng(5)
    x_ub = st.x_ub.numpy()
    X = np.minimum(rng.integers(0, 3, size=(8, 8, x_ub.shape[1])).astype(np.float32), x_ub[:, None, :])
    assert all(np.array_equal(a, b) for a, b in zip(_step(progs, cards[:n], X, shape), _step(progs, [cards[0]] * n, X, shape)))
    got = solve_cases_sharded(progs, mesh=make_mesh(devices=cards[:n]), pop=8, steps=12, rounds=2)
    want = solve_cases_sharded(progs, mesh=make_mesh(devices=[cards[0]] * n), pop=8, steps=12, rounds=2)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.slow
def test_bench_mesh_legs(cuda_device):
    """The bench's multi-card legs (`AMBIGRAM_BENCH_SUITE=mesh`): the
    16-case batch's device leg on one card and, with several cards, over
    all of them, each 16/16 with no hard violation; the round-robin
    searches on 1, 2 and 4 threads. Prints the leg's line."""
    out = bench.bench_mesh()
    print("multi_gpu_batch %s" % json.dumps(out))
    for key in ("one_card", "all_cards"):
        if key in out:
            assert out[key]["solved"] == 16 and out[key]["max_hard_violation"] == 0.0
    assert set(out["round_robin_4xS48"]) == {"threads1", "threads2", "threads4"}


# ------------------------------------------------- the sweep kernel (csrc/sweeps.cu)

TIE_VARS = dict(minus=10, plus=20, far=150, spare=30, empty=31)


def tie_case():
    """A program built so that moves tie (numpy; Rows = Vp = 256, two
    chunks of variables). Row 0 has target 1; variable 10 has column -1
    there, variables 20 and 150 (the second chunk) +1, variables 30 and 31
    zero columns; every other row is open. Member 0 (x10 = x30 = 1, score
    2) reaches score 1 by +x20, -x10 or +x150 in the delta sweep, so + and
    - tie within a chunk and across chunks; member 1 (x30 = 1, score 1)
    reaches 0 by +x20 or +x150. The paired catalogue moves a unit from 30
    to 150 (move 40), to 20 (90) and to 20 again (200, the second chunk);
    the triple catalogue splits 30 into (150, 31) (move 140) and (20, 31)
    (move 300), the rest padding. Returns (leaves, X, moves, moves3)."""
    rows = vp = 256
    v = TIE_VARS
    H = np.zeros((rows, vp), dtype=np.float32)
    H[0, v["minus"]], H[0, v["plus"]], H[0, v["far"]] = -1.0, 1.0, 1.0
    lb = np.full(rows, -3.0e38, dtype=np.float32)
    ub = np.full(rows, 3.0e38, dtype=np.float32)
    lb[0] = ub[0] = 1.0
    leaves = dict(H=H, lb=lb, ub=ub, x_ub=np.full(vp, 3.0, dtype=np.float32), H8=H.astype(np.int8),
                  lb_raw=lb.copy(), ub_raw=ub.copy(), w=np.ones(rows, dtype=np.float32))
    X = np.zeros((2, vp), dtype=np.float32)
    X[0, v["minus"]] = X[0, v["spare"]] = X[1, v["spare"]] = 1.0
    mm, mp = np.zeros(256, dtype=np.int32), np.zeros(256, dtype=np.int32)
    for m, to in ((40, v["far"]), (90, v["plus"]), (200, v["plus"])):
        mm[m], mp[m] = v["spare"], to
    a, b, c = (np.zeros(512, dtype=np.int32) for _ in range(3))
    s, valid = np.ones(512, dtype=np.float32), np.zeros(512, dtype=bool)
    for m, to in ((140, v["far"]), (300, v["plus"])):
        a[m], b[m], c[m], valid[m] = v["spare"], to, v["empty"], True
    return leaves, X, (mm, mp), (a, b, c, s, valid)


def tie_tensors(device):
    """The tie case's ScoringTensors, X, hx, scores and catalogues on `device`."""
    leaves, X, moves, moves3 = tie_case()
    st = ScoringTensors.from_numpy(num_vars=256, num_residual_rows=1, int8_ok=True, x_ub_max=3.0, device=device,
                                   **leaves)
    X = torch.as_tensor(X).to(device)
    scores, hx = score_rows_plain(st, X, want_hx=True)

    def index(a):
        t = torch.as_tensor(a)
        return (t.to(torch.int64) if t.dtype == torch.int32 else t).to(device)

    return st, X, hx, scores, tuple(index(a) for a in moves), tuple(index(a) for a in moves3)


def kicked_population(prog, x_ub, n, seed):
    """n candidates shaped like the search's: the seeded population, each
    member but the first kicked at 4 variables by +-1/+-2, clipped."""
    from ambigram_tpu_torch.solver.host import _seed_case

    X, _ = _seed_case(prog, len(x_ub), x_ub, n, seed)
    rng = np.random.default_rng(seed)
    for b in range(1, n):
        np.add.at(X[b], rng.integers(0, prog.num_vars, size=4), rng.choice([-2.0, -1.0, 1.0, 2.0], size=4))
    return np.clip(X, 0.0, x_ub).astype(np.float32)


def stacked_start(progs, device, B=32):
    """stack_cases of `progs` on `device` with a kicked population per
    case, and its exact hx and scores (plain, integer targets)."""
    st = stack_cases(progs, device)
    x_ub = st.x_ub.cpu().numpy()
    X = np.stack([kicked_population(p, x_ub[g], B, seed=g) for g, p in enumerate(progs)])
    X = torch.as_tensor(X).to(device)
    scores, hx = score_rows_plain(st, X, want_hx=True)
    return st, X, hx, scores


SWEEP_CATALOGUE = {"delta": lambda moves, moves3: (), "moves": lambda moves, moves3: moves,
                   "moves3": lambda moves, moves3: moves3}


@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("kind", ["delta", "moves", "moves3"])
def test_sweep_kernel_lockstep_with_plain(cuda_device, tmp_path, kind, G):
    """Each sweep kind through the kernel against its plain version on G
    case-stacked integer-target programs (S=24, noise 0, one interval),
    eight sweeps in lockstep: X', hx', scores' and the per-case improved
    flags bitwise equal after every one."""
    from ambigram_tpu_torch.solver import sweeps

    progs = [simulated_prog(tmp_path, seed=s, n_segments=24, mode="nested") for s in range(G)]
    st, X, hx, scores = stacked_start(progs, cuda_device)
    cat = SWEEP_CATALOGUE[kind](*search._device_moves(progs[0], cuda_device))
    plain = sweeps.PLAIN_SWEEPS[kind]
    before = sweeps.launch_sweep.by_kind[sweeps.KINDS.index(kind)]
    n_improved = 0
    for step in range(8):
        want = plain(st, X, hx, scores, *cat)
        got = sweeps.sweep_kernel(kind, st, X, hx, scores, *cat)
        torch.cuda.synchronize()
        for name, a, b in zip(("X", "hx", "scores", "improved"), got, want):
            assert torch.equal(a, b), "%s G=%d step %d: %s differs" % (kind, G, step, name)
        n_improved += int(want[3].sum())
        X, hx, scores = want[:3]
    assert n_improved >= 1
    assert sweeps.launch_sweep.by_kind[sweeps.KINDS.index(kind)] == before + 8


def test_sweep_kernel_move_scores_on_the_noisy_s48_case(cuda_device, tmp_path):
    """On the noisy S=48 seed-0 case (fractional targets: the f32 hinges
    round, and the kernel sums the rows in another order than the plain
    version) every move's hinge sum of each sweep kind within rtol 1e-5
    of the plain one, at the search's population (B=32)."""
    from ambigram_tpu_torch.solver import sweeps

    prog = simulated_prog(tmp_path, 0, 48, rounds=5, coverage=30.0, mode="process", noise=0.05)
    st, X, hx, scores = stacked_start([prog], cuda_device)
    moves, moves3 = search._device_moves(prog, cuda_device)
    for kind in sweeps.KINDS:
        cat = SWEEP_CATALOGUE[kind](moves, moves3)
        *_, got = sweeps.sweep_kernel(kind, st, X, hx, scores, *cat, want_move_scores=True)
        want = sweeps.move_scores_plain(kind, st, hx, *cat)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
        assert rel <= 1e-5, "%s: rel %g" % (kind, rel)


def test_sweep_kernel_takes_no_move_from_a_converged_noisy_state(cuda_device, tmp_path):
    """Accepts are strictly improving on noisy targets too. On the noisy
    S=48 seed-0 case the plain sweeps (dense sums) descend until no tier
    takes a move; from there one kernel sweep of each kind takes none:
    with the members' scores as the plain descent left them, with each
    raised by 16 ulps (a score that rounded above the member's dense
    hinge sum, as K1's or a last move's base + change can), and doubled.
    The kernel tests a move against the member's base, the sum its score
    was formed from, so the score it is handed admits no move that does
    not lower that sum; a test against the score would take the best
    move whenever the score lies above base + its change. Any move the
    kernel takes must lower the member's hinge sum computed in f64."""
    from ambigram_tpu_torch.solver import sweeps

    prog = simulated_prog(tmp_path, 0, 48, rounds=5, coverage=30.0, mode="process", noise=0.05)
    st, X, hx, scores = stacked_start([prog], cuda_device, B=8)
    moves, moves3 = search._device_moves(prog, cuda_device)
    cats = {kind: SWEEP_CATALOGUE[kind](moves, moves3) for kind in sweeps.KINDS}
    for _ in range(600):
        for kind in sweeps.KINDS:
            X, hx, scores, improved = sweeps.PLAIN_SWEEPS[kind](st, X, hx, scores, *cats[kind])
            if bool(improved.any()):
                break
        else:
            break
    else:
        raise AssertionError("the plain descent did not converge in 600 iterations")
    H64, lb, ub = st.H[0].double(), st.lb[0].double(), st.ub[0].double()

    def hinge_sum64(X):
        v = X[0].double() @ H64.T
        return ((v - ub).clamp(min=0.0) + (lb - v).clamp(min=0.0)).sum(dim=-1)

    raised = scores.clone()
    for _ in range(16):
        raised = torch.nextafter(raised, torch.full_like(raised, float("inf")))
    for kind in sweeps.KINDS:
        for label, s_in in (("as left", scores), ("raised 16 ulps", raised), ("doubled", 2.0 * scores)):
            X2, _, _, improved = sweeps.sweep_kernel(kind, st, X, hx, s_in, *cats[kind])
            moved = (X2 != X).any(dim=-1)[0]
            change = (hinge_sum64(X2) - hinge_sum64(X))[moved].tolist()
            assert all(c < 0.0 for c in change), "%s, scores %s: a move that does not improve: %s" % (
                kind, label, change)
            assert not bool(improved.any()) and not bool(moved.any()), (
                "%s, scores %s: the kernel took %d moves from a converged state (f64 changes %s)" % (
                    kind, label, int(moved.sum()), change))


@pytest.mark.parametrize("kind", ["delta", "moves", "moves3"])
def test_sweep_kernel_tie_order(cuda_device, kind):
    """The tie case (`tie_case`): the kernel picks the plain version's
    (JAX's) move: + before - within a delta chunk, the earlier chunk
    across chunks, the first of equal moves within a chunk."""
    from ambigram_tpu_torch.solver import sweeps

    st, X, hx, scores, moves, moves3 = tie_tensors(cuda_device)
    cat = SWEEP_CATALOGUE[kind](moves, moves3)
    plain = sweeps.PLAIN_SWEEPS[kind]
    want = plain(st, X, hx, scores, *cat)
    got = sweeps.sweep_kernel(kind, st, X, hx, scores, *cat)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    v = TIE_VARS
    moved = {"delta": {v["plus"]: 1.0}, "moves": {v["far"]: 1.0, v["spare"]: 0.0},
             "moves3": {v["far"]: 1.0, v["spare"]: 0.0, v["empty"]: 1.0}}[kind]
    for var, value in moved.items():
        assert float(got[0][0, var]) == value, (kind, var)


def test_phase_span_holds_its_sweep_kernel_on_the_traces_clock(cuda_device, tmp_path):
    """Under the benchmark's profiler settings, a phase span around one
    sweep launch and a synchronize holds each of that launch's kernels,
    where the exported trace puts them, within 50 us."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from ambigram_tpu_torch.solver import sweeps
    from ambigram_tpu_torch.utils.profiling import Profiler

    st, X, hx, scores, moves, moves3 = tie_tensors(cuda_device)
    sweeps.sweep_kernel("delta", st, X, hx, scores)
    torch.cuda.synchronize()
    prof = Profiler()
    prof.record_spans(True)
    trace = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trace.__enter__()
    try:
        with prof.phase("score"):
            sweeps.sweep_kernel("delta", st, X, hx, scores)
            torch.cuda.synchronize()
    finally:
        trace.__exit__(None, None, None)
    path = tmp_path / "trace.json"
    trace.export_chrome_trace(str(path))
    with open(path) as f:
        exported = json.load(f)
    base = int(exported["baseTimeNanoseconds"])
    kernels = [e for e in exported["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "kernel" and "sweep_" in e.get("name", "")]
    assert kernels, "the trace holds no sweep kernel"
    (span,) = prof.take_spans()
    lo_us, hi_us = (span.start_ns - base) / 1e3, (span.end_ns - base) / 1e3
    for k in kernels:
        start, end = float(k["ts"]), float(k["ts"]) + float(k["dur"])
        assert lo_us - 50.0 <= start and end <= hi_us + 50.0, (k["name"], start - lo_us, hi_us - end)


def test_gated_off_sweep_changes_nothing(cuda_device, tmp_path):
    """A launch whose gate is off (the loop's budget is spent) leaves X,
    hx and scores as they were and reports no improvement; the next
    gated-on sweep still equals the plain one (the members' keys were
    left clean)."""
    from ambigram_tpu_torch.solver import sweeps

    prog = simulated_prog(tmp_path, seed=1, n_segments=24, mode="nested")
    st, X, hx, scores = stacked_start([prog], cuda_device)
    moves, moves3 = search._device_moves(prog, cuda_device)
    for kind in sweeps.KINDS:
        cat = SWEEP_CATALOGUE[kind](moves, moves3)
        ops = sweeps.SweepOps(st, X, moves, moves3)
        X2, hx2, s2 = X.clone(), hx.clone(), scores.clone()
        spent = sweeps.new_state(0, cuda_device)
        sweeps.launch_sweep(ops, sweeps.KINDS.index(kind), X2, hx2, s2, spent)
        torch.cuda.synchronize()
        assert torch.equal(X2, X) and torch.equal(hx2, hx) and torch.equal(s2, scores)
        assert not bool(ops.imp.any()) and bool((ops.best == -1).all())
        sweeps.launch_sweep(ops, sweeps.KINDS.index(kind), X2, hx2, s2, sweeps.new_state(1, cuda_device))
        want = sweeps.PLAIN_SWEEPS[kind](st, X, hx, scores, *cat)
        assert torch.equal(X2, want[0]) and torch.equal(hx2, want[1]) and torch.equal(s2, want[2])


def test_descend_block_makes_no_host_sync(cuda_device, tmp_path):
    """A block of descent iterations on the card queues its sweeps and
    state folds without one host sync (torch's sync debug mode raises on
    any), and lands where the CPU descent of the same budget lands:
    X, hx, scores and the sweep counts bitwise (integer targets)."""
    from ambigram_tpu_torch.solver import sweeps

    progs = [simulated_prog(tmp_path, seed=s, n_segments=24, mode="nested") for s in (3, 4)]
    st, X, hx, scores = stacked_start(progs, cuda_device)
    moves, moves3 = search._device_moves(progs[0], cuda_device)
    n = search.DESCEND_BLOCK
    ops = sweeps.SweepOps(st, X, moves, moves3)
    state = sweeps.new_state(n, cuda_device)
    Xk, hxk, sk = X.clone(), hx.clone(), scores.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Xk, hxk, sk = search.descend_block(ops, Xk, hxk, sk, state, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    st_cpu = stack_cases(progs, "cpu")
    cpu_moves, cpu_moves3 = search._device_moves(progs[0], torch.device("cpu"))
    want = search.descend_loop(st_cpu, X.cpu(), hx.cpu(), scores.cpu(), n, 128, cpu_moves, cpu_moves3)
    words = state.tolist()
    assert (words[sweeps.S_IT], words[sweeps.S_N_MV], words[sweeps.S_N_M3]) == tuple(want[3:])
    for a, b in zip((Xk, hxk, sk), want[:3]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("block", [1, 8, 64])
def test_descend_loop_on_card_matches_cpu(cuda_device, tmp_path, monkeypatch, block):
    """The whole gated descent of a case-stacked pair on the card, at
    three block sizes, against the CPU descent with the plain sweeps:
    X, hx, scores and the three sweep counts bitwise."""
    progs = [simulated_prog(tmp_path, seed=s, n_segments=24, mode="nested") for s in (5, 6)]
    st, X, hx, scores = stacked_start(progs, cuda_device)
    moves, moves3 = search._device_moves(progs[0], cuda_device)
    monkeypatch.setattr(search, "DESCEND_BLOCK", block)
    got = search.descend_loop(st, X, hx, scores, 64, 128, moves, moves3)
    cpu_moves, cpu_moves3 = search._device_moves(progs[0], torch.device("cpu"))
    want = search.descend_loop(stack_cases(progs, "cpu"), X.cpu(), hx.cpu(), scores.cpu(), 64, 128,
                               cpu_moves, cpu_moves3)
    assert tuple(got[3:]) == tuple(want[3:]) and want[5] >= 1
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b)


def test_windowed_batch_equals_serial_on_card(cuda_device, tmp_path, monkeypatch):
    """`solve_device_batch` with JAX's window of 4 groups in flight, each
    on its own stream, against a window of 1: per case the same x and
    eps (no polish: its wall-clock budget would decide). Six groups, so
    the window fills and drains."""
    progs = [simulated_prog(tmp_path, seed=s, n_segments=n, mode="nested")
             for s, n in ((0, 8), (1, 10), (2, 12), (3, 12), (4, 14), (5, 16), (6, 18))]
    kw = dict(pop=8, rounds=2, max_sweeps=32, polish=False, device=cuda_device)
    windowed = search.solve_device_batch(progs, **kw)
    monkeypatch.setattr(search, "MAX_INFLIGHT", 1)
    serial = search.solve_device_batch(progs, **kw)
    for a, b in zip(windowed, serial):
        assert np.array_equal(a.x, b.x) and a.epsilon_sum == b.epsilon_sum


@pytest.mark.parametrize("G, B", [(1, 1), (1, 33), (2, 33)])
@pytest.mark.parametrize("kind", ["delta", "moves", "moves3"])
def test_sweep_kernel_ragged_members(cuda_device, tmp_path, kind, G, B):
    """Populations that leave lanes of the kernel's warps idle (B = 1, and
    33 = a warp and one member) against the plain sweeps, four sweeps in
    lockstep: X', hx', scores' and the improved flags bitwise."""
    from ambigram_tpu_torch.solver import sweeps

    progs = [simulated_prog(tmp_path, seed=s, n_segments=24, mode="nested") for s in range(G)]
    st, X, hx, scores = stacked_start(progs, cuda_device, B=B)
    if G == 1:  # one case without the case axis
        st, X, hx, scores = st.case(0), X[0], hx[0], scores[0]
    cat = SWEEP_CATALOGUE[kind](*search._device_moves(progs[0], cuda_device))
    for step in range(4):
        want = sweeps.PLAIN_SWEEPS[kind](st, X, hx, scores, *cat)
        got = sweeps.sweep_kernel(kind, st, X, hx, scores, *cat)
        torch.cuda.synchronize()
        for name, a, b in zip(("X", "hx", "scores", "improved"), got, want):
            assert torch.equal(a, b), "%s G=%d B=%d step %d: %s differs" % (kind, G, B, step, name)
        X, hx, scores = want[:3]


@pytest.mark.parametrize("kind", ["delta", "moves", "moves3"])
def test_sweep_kernel_scores_and_visits_match_the_sparse_mirror(cuda_device, tmp_path, kind):
    """Every move's score (none skipped) equals the dense plain one and its
    plain sparse mirror bitwise on an integer-target pair of cases, and
    every move's visited rows are |U_m|, the union of its columns'
    supports."""
    from ambigram_tpu_torch.solver import sweeps

    progs = [simulated_prog(tmp_path, seed=s, n_segments=24, mode="nested") for s in (7, 8)]
    st, X, hx, scores = stacked_start(progs, cuda_device)
    cat = SWEEP_CATALOGUE[kind](*search._device_moves(progs[0], cuda_device))
    *_, got, visits = sweeps.sweep_kernel(kind, st, X, hx, scores, *cat, want_move_scores=True, want_visits=True)
    torch.cuda.synchronize()
    assert torch.equal(got, sweeps.move_scores_plain(kind, st, hx, *cat))
    assert torch.equal(got, sweeps.move_scores_sparse_plain(kind, st, hx, *cat))
    _, U = sweeps.sparse_columns(st).dense()
    if kind == "delta":
        per_col = U.sum(dim=-1).to(torch.int32)  # [G, Vp]
        G, Vp = per_col.shape
        want = per_col.reshape(G, Vp // 128, 1, 128).expand(G, Vp // 128, 2, 128).reshape(G, 2 * Vp)
    elif kind == "moves":
        M = visits.shape[-1]
        mm, mp = (t[:M] for t in cat)
        want = (U[:, mm] | U[:, mp]).sum(dim=-1).to(torch.int32)
    else:
        M = visits.shape[-1]
        a, b, c = (t[:M] for t in cat[:3])
        want = (U[:, a] | U[:, b] | U[:, c]).sum(dim=-1).to(torch.int32)
    assert torch.equal(visits, want)


def test_sweep_kernel_on_the_s96_twin(cuda_device, tmp_path):
    """The big leg's S=96 noise-free twin (Rows 32512, Vp 9344, far past
    the rows of the S=48 programs): one sweep of each kind bitwise against
    plain; the triple sweep on the first 64 chunks of its catalogue, since
    the plain one takes minutes over all of it."""
    from ambigram_tpu_torch.solver import sweeps

    prog = extract_programs(bench.big_case_path(str(tmp_path), 96, 0.0))[0]
    st, X, hx, scores = stacked_start([prog], cuda_device)
    moves, moves3 = search._device_moves(prog, cuda_device)
    cats = {"delta": (), "moves": moves, "moves3": tuple(t[: 64 * 128] for t in moves3)}
    for kind, cat in cats.items():
        want = sweeps.PLAIN_SWEEPS[kind](st, X, hx, scores, *cat)
        got = sweeps.sweep_kernel(kind, st, X, hx, scores, *cat)
        torch.cuda.synchronize()
        for name, a, b in zip(("X", "hx", "scores", "improved"), got, want):
            assert torch.equal(a, b), "S=96 %s: %s differs" % (kind, name)


def test_card_search_matches_the_cpu_search_on_s32(cuda_device, tmp_path):
    """A bounded seeded device search (no LNS, no certificate) on an
    integer-target S=32 program, on the card and on the CPU: the kicks are
    drawn on the host and every sum is exact, so x and the three sweep
    counts come out equal."""
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    prog = simulated_prog(tmp_path, seed=200, n_segments=32, rounds=5, mode="process")
    kw = dict(seed=5, pop=16, rounds=2, max_sweeps=48, certify=False, polish=False)
    counts = []
    results = []
    for device in (cuda_device, torch.device("cpu")):
        GLOBAL.reset()
        results.append(search.solve_device(prog, device=device, **kw))
        counts.append([GLOBAL.counters.get("search.%s_sweeps" % k, 0) for k in ("delta", "move", "move3")])
    assert np.array_equal(results[0].x, results[1].x)
    assert counts[0] == counts[1] and counts[0][0] >= 1


def test_card_descent_never_reads_the_dense_columns(cuda_device, tmp_path, monkeypatch):
    """The card's sweeps read the sparse columns only: a descent with
    `ScoringTensors.columns` made to raise still runs, and lands where the
    CPU descent lands."""
    progs = [simulated_prog(tmp_path, seed=s, n_segments=24, mode="nested") for s in (9, 10)]
    st, X, hx, scores = stacked_start(progs, cuda_device)
    moves, moves3 = search._device_moves(progs[0], cuda_device)
    cpu_moves, cpu_moves3 = search._device_moves(progs[0], torch.device("cpu"))
    want = search.descend_loop(stack_cases(progs, "cpu"), X.cpu(), hx.cpu(), scores.cpu(), 32, 128,
                               cpu_moves, cpu_moves3)

    def refuse(self):
        raise AssertionError("the card's sweeps read the dense H.T")

    monkeypatch.setattr(ScoringTensors, "columns", refuse)
    got = search.descend_loop(st, X, hx, scores, 32, 128, moves, moves3)
    assert tuple(got[3:]) == tuple(want[3:])
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b)


# ------------------------------------------------ K1's int8 path (wgmma)


def int8_tensors(device, rows, vp, G=1, x_ub_max=3.0, seed=0, noisy=False):
    """Random int8-exact scoring tensors of any shape: sparse H8 in
    [-2, 2], hinge weights in {0, 0.5, 1, 1024} (0 as on padding rows),
    integer row bounds near the row values of small candidates (open on
    some rows), so every hinge term is a small multiple of 0.5 and every
    score an exact f32 sum; with a box past 255 (two planes, whose large
    values reach 600 in a row value) the rows weighted 1024 are open, so
    the scores stay below 2^23. `noisy` adds fractional parts to the
    bounds.
    With G > 1 every leaf has a leading case axis, as `stack_cases`
    builds it."""
    from ambigram_tpu_torch.solver.score import _BIG, _expand_f32

    rng = np.random.default_rng(seed)
    shape = (G, rows) if G > 1 else (rows,)
    H8 = rng.choice(np.array([-2, -1, 1, 2], dtype=np.int8), size=shape + (vp,))
    H8 *= (rng.random(shape + (vp,)) < 0.02).astype(np.int8)
    w = rng.choice(np.array([0.0, 0.5, 1.0, 1024.0], dtype=np.float32), size=shape, p=[0.1, 0.3, 0.55, 0.05])
    lb_raw = rng.integers(-2, 6, size=shape).astype(np.float32)
    ub_raw = lb_raw + rng.integers(0, 3, size=shape).astype(np.float32)
    hard = w == 1024.0
    lb_raw[hard], ub_raw[hard] = 0.0, 4.0
    opened = (rng.random(shape) < 0.1) | (hard & (x_ub_max > 255))
    lb_raw[opened], ub_raw[opened] = -_BIG, _BIG
    if noisy:
        frac = rng.random(shape).astype(np.float32) * 0.9
        lb_raw = np.where(opened | hard, lb_raw, lb_raw + frac).astype(np.float32)
        ub_raw = np.where(opened | hard, ub_raw, ub_raw + frac).astype(np.float32)
    t = lambda a: torch.as_tensor(a).to(device)
    H8t, lbr, ubr, wt = t(H8), t(lb_raw), t(ub_raw), t(w)
    H, lb, ub = _expand_f32(H8t, lbr, ubr, wt)
    x_ub = torch.full(shape[:-1] + (vp,), float(x_ub_max), dtype=torch.float32, device=device)
    return ScoringTensors(H=H, lb=lb, ub=ub, x_ub=x_ub, H8=H8t, lb_raw=lbr, ub_raw=ubr, w=wt, num_vars=vp,
                          num_residual_rows=rows, int8_ok=True, x_ub_max=float(x_ub_max))


def int8_candidates(device, G, B, vp, planes, seed=1):
    """Small sparse candidates in [0, 3]; with two planes each also holds
    one value in [256, 300], so both bytes carry."""
    rng = np.random.default_rng(seed)
    X = (rng.integers(0, 4, size=(G, B, vp)) * (rng.random((G, B, vp)) < 0.1)).astype(np.float32)
    if planes == 2:
        X[:, np.arange(B), rng.integers(0, vp, size=B)] = rng.integers(256, 301, size=(G, B))
    return torch.as_tensor(X if G > 1 else X[0]).to(device)


def check_k1_int8(st, X, want_hx, exact=True):
    """One launch of K1's int8 path against its plain version (bitwise on
    integer targets, rel 1e-5 otherwise) and against the CPU mirror of
    its arithmetic and summation order (bitwise, noisy targets too)."""
    from ambigram_tpu_torch.solver.score import score_rows_int8_plain

    before, before_i8 = score_rows.launches, score_rows.int8_launches
    s_k, hx_k = score_rows(st, X, want_hx=want_hx)
    assert score_rows.launches == before + 1 and score_rows.int8_launches == before_i8 + 1
    s_p, hx_p = score_rows_plain(st, X, want_hx=True)
    torch.cuda.synchronize()
    if want_hx:
        assert torch.equal(hx_k, hx_p)
    else:
        assert hx_k is None
    if exact:
        assert float(s_p.max()) < 2.0**23
        assert torch.equal(s_k, s_p)
    else:
        assert float(((s_k - s_p).abs() / s_p.abs().clamp(min=1.0)).max()) <= 1e-5
    s_m, _ = score_rows_int8_plain(st.to("cpu"), X.cpu())
    assert torch.equal(s_k.cpu(), s_m)
    return s_k, hx_k


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("want_hx", [True, False])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("B", [1, 31, 32, 33, 1000])
def test_k1_int8_wgmma_matches_plain(cuda_device, B, planes, want_hx, G):
    """K1's int8 path (one wgmma launch) at the search's and the large
    batches, one and two planes, with and without hx, one case and a
    case axis of 8 (each case bitwise equal to its own launch)."""
    rows, vp = 1536, 1152
    st = int8_tensors(cuda_device, rows, vp, G=G, x_ub_max=3.0 if planes == 1 else 300.0, seed=B + 7 * planes)
    assert k1_planes(st) == planes
    X = int8_candidates(cuda_device, G, B, vp, planes, seed=B)
    s_k, hx_k = check_k1_int8(st, X, want_hx)
    if G > 1:
        for g in (0, G - 1):
            s_g, hx_g = score_rows(st.case(g), X[g].contiguous(), want_hx=want_hx)
            assert torch.equal(s_g, s_k[g])
            if want_hx:
                assert torch.equal(hx_g, hx_k[g])


@pytest.mark.parametrize("B", [32, 33, 1000])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("rows, vp", [(1344, 576), (64, 64), (8256, 2432)])
def test_k1_int8_ragged_rows_and_vp(cuda_device, rows, vp, planes, B):
    """Rows and Vp that are 64 more than a multiple of 128 (a half TMA
    box past the edge, zero-filled), the smallest shape, and S=48's
    width with one ragged row tile."""
    st = int8_tensors(cuda_device, rows, vp, x_ub_max=3.0 if planes == 1 else 300.0, seed=rows + B)
    assert k1_planes(st) == planes
    check_k1_int8(st, int8_candidates(cuda_device, 1, B, vp, planes, seed=vp + B), want_hx=True)


@pytest.mark.parametrize("B, rows, vp, planes, G, variant", [
    (1000, 1024, 3328, 1, 1, ("cands", False, 16)),  # candidate-stationary, 32 a block
    (1000, 1024, 2432, 1, 1, ("cands", False, 32)),  # 64 a block
    (1000, 1024, 1152, 1, 1, ("cands", False, 64)),  # 128 a block
    (1000, 1024, 1664, 2, 1, ("cands", False, 32)),  # two planes: 32 a block
    (1000, 1024, 1152, 2, 1, ("cands", False, 64)),
    (1000, 1024, 640, 2, 1, ("cands", False, 128)),
    (32, 2048, 640, 1, 8, ("rows", True, 32)),  # row-streaming, two row tiles a block
    (64, 2048, 640, 1, 1, ("rows", True, 64)),
    (32, 2048, 640, 2, 8, ("rows", True, 64)),
    (64, 2048, 640, 2, 1, ("rows", True, 128)),
    (32, 2048, 640, 1, 1, ("rows", False, 16)),  # row-streaming, two halves of the candidates
    (32, 2048, 640, 2, 2, ("rows", False, 32)),
])
def test_k1_int8_every_instantiation(cuda_device, B, rows, vp, planes, G, variant):
    """Each of the kernel's twelve built variants (loop order x
    candidates a warpgroup x planes) once, through the plan that picks
    it, bitwise against plain."""
    from ambigram_tpu_torch.solver.score import k1_int8_plan

    plan = k1_int8_plan(B, rows, vp, planes, G)
    assert (plan.order, plan.split_rows, plan.nw) == variant
    st = int8_tensors(cuda_device, rows, vp, G=G, x_ub_max=3.0 if planes == 1 else 300.0, seed=vp + rows)
    check_k1_int8(st, int8_candidates(cuda_device, G, B, vp, planes, seed=B + rows), want_hx=True)


@pytest.mark.parametrize("planes", [1, 2])
def test_k1_int8_noisy_targets_follow_the_mirror(cuda_device, planes):
    """Fractional row bounds (the noisy cases): the scores within rel
    1e-5 of plain, and bitwise equal to the mirror of the kernel's
    summation order, in both loop orders and with split rows."""
    for B, rows, vp, G in ((32, 2048, 1152, 1), (1000, 2048, 1152, 1), (32, 1536, 640, 4)):
        st = int8_tensors(cuda_device, rows, vp, G=G, x_ub_max=3.0 if planes == 1 else 300.0, seed=B, noisy=True)
        check_k1_int8(st, int8_candidates(cuda_device, G, B, vp, planes, seed=rows), want_hx=True, exact=False)


def test_k1_int8_on_a_row_shard(cuda_device):
    """The sharded step's row-shard launch: 73,760 candidates against
    1920 rows x 1152 (candidate-stationary, one block walking every row
    of its 128 candidates), bitwise against plain; then the same call
    again on the stream (the tickets are left at zero)."""
    from ambigram_tpu_torch.solver.score import k1_int8_plan

    rows, vp, B = 1920, 1152, 73760
    st = int8_tensors(cuda_device, rows, vp, seed=11)
    assert k1_int8_plan(B, rows, vp, 1).direct
    X = int8_candidates(cuda_device, 1, B, vp, 1, seed=12)
    s_k, _ = check_k1_int8(st, X, want_hx=False)
    s_again, _ = score_rows(st, X)
    assert torch.equal(s_again, s_k)


def test_k1_int8_splits_reuse_the_tickets(cuda_device):
    """Launches whose rows are split between blocks (the last block of
    a candidate tile sums the partials) many times over on one stream,
    and on a second stream: every result bitwise the first."""
    st = int8_tensors(cuda_device, 8192, 640, seed=3)
    X = int8_candidates(cuda_device, 1, 1000, 640, 1, seed=4)
    s0, _ = check_k1_int8(st, X, want_hx=False)
    outs = [score_rows(st, X)[0] for _ in range(20)]
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        outs += [score_rows(st, X)[0] for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, s0) for o in outs)
