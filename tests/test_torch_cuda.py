"""Card-only checks of the port: K1 and K2 on the GPU, the int8 scorer,
the search and the batch path on cuda.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither jax nor a test module that does, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

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


@pytest.mark.parametrize("path", ["f32", "int8_two_planes"])
def test_score_rows_kernel_other_paths_match_plain(cuda_device, tmp_path, path):
    """K1's f32 FFMA path on rows that are not int8-exact (a 0.25
    coefficient), and its int8 path with two candidate planes (a box past
    255): hx bitwise equal to the plain version. The scores are bitwise
    equal wherever they stay on the exact f32 lattice (below 2^23); the
    large loop counts push some past it, where the two versions' f32 row
    sums round in different orders (rel 1e-6)."""
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
    B, Vp, T = 300, st.H.shape[1], len(prog.pairs)
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
