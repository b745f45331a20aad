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
