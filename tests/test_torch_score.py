"""The port's scoring tensors and scorers against the JAX package.

Inputs come from numpy (`default_rng`) and feed both sides. Every H
entry, bound and candidate here is a small integer or a multiple of 0.5
with integer targets, so f32 sums are exact in any order and the
comparisons are bitwise. The CUDA kernel's own checks are in
test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ambigram_tpu.solver import score as jscore
from ambigram_tpu_torch.solver import score as tscore
from test_solver import _egfr_prog, _random_prog

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

LEAVES = ("H", "lb", "ub", "x_ub", "H8", "lb_raw", "ub_raw", "w")
STATIC = ("num_vars", "num_residual_rows", "int8_ok", "x_ub_max")


def small_progs():
    """egfr6 plus four random programs (as tests/test_solver.py builds
    them), by name."""
    progs = {"egfr6": _egfr_prog()}
    for seed in range(4):
        rng = np.random.default_rng(seed)
        progs["rand%d" % seed] = _random_prog(rng, n=rng.integers(4, 8))
    return progs


def port_from_jax(jst, device="cpu"):
    """The port's ScoringTensors holding exactly the JAX tensors."""
    return tscore.ScoringTensors.from_numpy(
        **{k: np.asarray(getattr(jst, k)) for k in LEAVES},
        **{k: getattr(jst, k) for k in STATIC},
        device=device,
    )


def candidates(rng, prog, Vp, B, high=3):
    X = np.zeros((B, Vp), dtype=np.float32)
    X[:, : prog.num_vars] = np.minimum(
        rng.integers(0, high, size=(B, prog.num_vars)), prog.x_ub
    )
    return X


def assert_tensors_equal(tst, jst):
    for k in LEAVES:
        got = getattr(tst, k).numpy()
        want = np.asarray(getattr(jst, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in STATIC:
        assert getattr(tst, k) == getattr(jst, k), k
    assert tst.use_int8 == jst.use_int8


@pytest.mark.parametrize("name", ["egfr6", "rand0", "rand1", "rand2", "rand3"])
def test_scoring_tensors_match_jax(name):
    prog = small_progs()[name]
    jst = jscore.scoring_tensors(prog)
    tst = tscore.scoring_tensors(prog, "cpu")
    assert_tensors_equal(tst, jst)
    # from_numpy carries the JAX tensors across unchanged
    assert_tensors_equal(port_from_jax(jst), jst)


def test_scoring_tensors_match_jax_large_nested_case(tmp_path):
    """The S=46 nested case (V=2162, H of 7680 x 2176): the device
    branch's smallest realistic shape."""
    from ambigram_tpu.engine.pipeline import extract_programs
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

    case = simulate_bfb_case(seed=1, n_segments=46, mode="nested")
    prog = extract_programs(write_case(case, str(tmp_path / "s46"))["lh"])[0]
    assert prog.num_vars == 2162
    jst = jscore.scoring_tensors(prog)
    tst = tscore.scoring_tensors(prog, "cpu")
    assert tuple(tst.H.shape) == (7680, 2176)
    assert_tensors_equal(tst, jst)


def test_scoring_tensors_host_f32_assembly_matches_jax():
    """A fractional coefficient makes the int8 form inexact: both
    packages then assemble the f32 form on the host."""
    prog = _egfr_prog()
    prog.A_fbi = prog.A_fbi * 0.75
    jst = jscore.scoring_tensors(prog)
    tst = tscore.scoring_tensors(prog, "cpu")
    assert not tst.int8_ok
    assert_tensors_equal(tst, jst)


def test_expand_f32_keeps_clamp_and_padding_rule():
    """+-BIG bounds on PENALTY rows overflow w * bound to +-inf; both
    sides clamp back to +-3e38, and padding rows (w == 0) keep open
    bounds."""
    big = np.float32(3.0e38)
    H8 = np.array([[1, -2, 0], [2, 1, 1], [0, 0, 0], [1, 1, -1]], dtype=np.int8)
    lb_raw = np.array([3.0, -big, -big, 0.0], dtype=np.float32)
    ub_raw = np.array([3.0, 2.0, big, big], dtype=np.float32)
    w = np.array([1.0, 1024.0, 0.0, 0.5], dtype=np.float32)
    want = jscore._expand_f32(H8, lb_raw, ub_raw, w)
    got = tscore._expand_f32(*(torch.as_tensor(a) for a in (H8, lb_raw, ub_raw, w)))
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert np.isfinite(got[1].numpy()).all() and np.isfinite(got[2].numpy()).all()
    assert got[1][2] == -big and got[2][2] == big


@pytest.mark.parametrize("use_int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("name", ["egfr6", "rand0", "rand1", "rand2", "rand3"])
def test_score_batch_matches_jax(name, use_int8):
    prog = small_progs()[name]
    jst = jscore.scoring_tensors(prog)
    if not use_int8:
        jst = dataclasses.replace(jst, int8_ok=False)
    tst = port_from_jax(jst)
    assert tst.use_int8 == use_int8
    X = candidates(np.random.default_rng(7), prog, tst.H.shape[1], 64)
    want = np.asarray(jscore.score_batch_jit(jst, X))
    got = tscore.score_batch(tst, torch.as_tensor(X)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["egfr6", "rand1", "rand3"])
def test_score_rows_plain_matches_pallas_scorer(name):
    """K1's plain version against the Pallas scorer in interpret mode
    (as tests/test_solver.py runs it on the CPU), plus hx against a
    float64 product."""
    prog = small_progs()[name]
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    X = candidates(np.random.default_rng(1), prog, tst.H.shape[1], 512, high=2)
    want = np.asarray(jscore.score_batch_pallas(jst, X, block_b=256))
    scores, hx = tscore.score_rows(tst, torch.as_tensor(X), want_hx=True)
    np.testing.assert_array_equal(scores.numpy(), want)
    hx64 = X.astype(np.float64) @ np.asarray(jst.H, dtype=np.float64).T
    np.testing.assert_array_equal(hx.numpy(), hx64.astype(np.float32))
    no_hx = tscore.score_rows(tst, torch.as_tensor(X))
    assert no_hx[1] is None
    np.testing.assert_array_equal(no_hx[0].numpy(), want)


def test_score_rows_cpu_tensors_never_launch_the_kernel():
    tst = tscore.scoring_tensors(_egfr_prog(), "cpu")
    before = tscore.score_rows.launches
    tscore.score_rows(tst, torch.zeros((4, tst.H.shape[1])))
    assert tscore.score_rows.launches == before


def test_score_rows_rejects_bad_inputs():
    tst = tscore.scoring_tensors(_egfr_prog(), "cpu")
    Vp = tst.H.shape[1]
    with pytest.raises(ValueError):
        tscore.score_rows(tst, torch.zeros((4, Vp + 1)))
    with pytest.raises(TypeError):
        tscore.score_rows(tst, torch.zeros((4, Vp), dtype=torch.float64))
    with pytest.raises(ValueError):
        tscore.score_rows(tst.to("meta"), torch.zeros((4, Vp), device="meta"))

