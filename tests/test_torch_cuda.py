"""Card-only checks of the port: K1 on the GPU and the search on cuda.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither jax nor a test module that does, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from ambigram_tpu.engine.pipeline import extract_programs
from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case
from ambigram_tpu_torch.solver import search
from ambigram_tpu_torch.solver.score import score_rows, score_rows_plain, scoring_tensors

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
    """K1 against its plain version for ragged batches of sparse
    candidates on a noise-free case (integer targets, scores below 2^22:
    every f32 sum is exact), so hx and scores are bitwise equal."""
    prog = simulated_prog(tmp_path, seed=2, n_segments=24, mode="nested")
    st = scoring_tensors(prog, cuda_device)
    rng = np.random.default_rng(B)
    Vp = st.H.shape[1]
    X = np.zeros((B, Vp), dtype=np.float32)
    X[:, : prog.num_vars] = np.minimum(rng.integers(0, 3, size=(B, prog.num_vars)), prog.x_ub)
    X *= rng.random((B, Vp)) < 0.05
    X = torch.as_tensor(X).to(cuda_device)
    before = score_rows.launches
    s_k, hx_k = score_rows(st, X, want_hx=True)
    assert score_rows.launches == before + 1
    s_p, hx_p = score_rows_plain(st, X, want_hx=True)
    torch.cuda.synchronize()
    assert float(s_p.max()) < 2.0**22
    assert torch.equal(hx_k, hx_p)
    assert torch.equal(s_k, s_p)
    s_only, no_hx = score_rows(st, X)
    assert no_hx is None and torch.equal(s_only, s_k)


def test_search_on_cuda_follows_the_cpu_trajectory(cuda_device, monkeypatch):
    """The kicks come from a CPU generator and every sum is exact on
    egfr6, so the search takes the same path on cuda as on the CPU."""
    monkeypatch.setenv("AMBIGRAM_SEARCH_POP", "8")
    monkeypatch.setenv("AMBIGRAM_SEARCH_ROUNDS", "3")
    prog = extract_programs(os.path.join(DATA, "egfr6.lh"))[0]
    d_gpu = search._dispatch_single(prog, cuda_device)
    d_cpu = search._dispatch_single(prog, "cpu")
    assert np.array_equal(d_gpu["best_x"].cpu().numpy(), d_cpu["best_x"].numpy())
    assert d_gpu["best_s"] == d_cpu["best_s"]
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
