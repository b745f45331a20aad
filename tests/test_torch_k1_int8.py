"""The arithmetic of K1's int8 tensor-core path, on the CPU.

K1 reads H8 and w instead of H whenever the program's rows are
int8-exact (`k1_planes`): the candidates as one or two u8 planes, an
int32 product per plane, hx = w * float(256 hi + lo), then the f32
hinges. `score_rows_int8_plain` is that arithmetic in plain PyTorch;
here it is held bitwise against the JAX package's Pallas scorer in
interpret mode and against K1's plain f32 version, with one plane and
with two. The dispatch rule is checked on programs that fail it. The
kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ambigram_tpu.solver import score as jscore
from ambigram_tpu_torch.parallel.mesh import stack_cases
from ambigram_tpu_torch.solver import score as tscore
from test_solver import _egfr_prog, _random_prog
from test_torch_score import candidates, port_from_jax, small_progs

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)


def wide_box_prog(x_max=400, seed=5, n=6):
    """A random program whose loop box reaches past 255, so K1 needs the
    candidates' high byte too."""
    prog = _random_prog(np.random.default_rng(seed), n)
    prog.x_ub = prog.x_ub.copy()
    prog.x_ub[len(prog.pairs):] = x_max
    return prog


@pytest.mark.parametrize("name", ["egfr6", "rand1", "rand3"])
def test_int8_mirror_one_plane_matches_pallas_and_plain(name):
    prog = small_progs()[name]
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    assert tscore.k1_planes(tst) == 1
    X = candidates(np.random.default_rng(3), prog, tst.H.shape[1], 256, high=4)
    scores, hx = tscore.score_rows_int8_plain(tst, torch.as_tensor(X), want_hx=True)
    s_plain, hx_plain = tscore.score_rows_plain(tst, torch.as_tensor(X), want_hx=True)
    assert torch.equal(hx, hx_plain)
    hx64 = X.astype(np.float64) @ np.asarray(jst.H, dtype=np.float64).T
    np.testing.assert_array_equal(hx.numpy(), hx64.astype(np.float32))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscore.score_batch_pallas(jst, X, block_b=256)))
    assert torch.equal(scores, s_plain)


@pytest.mark.parametrize("seed", [5, 6])
def test_int8_mirror_two_planes_matches_pallas_and_plain(seed):
    """Candidates up to 400: the high byte is a second plane, and
    256 * hx_hi + hx_lo is still the exact product. Each candidate holds
    one loop count above 255 and a few small ones, so its score stays
    below 2^23 and every f32 sum is exact."""
    prog = wide_box_prog(seed=seed)
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    assert tst.x_ub_max == 400 and tscore.k1_planes(tst) == 2
    rng = np.random.default_rng(seed)
    B, Vp, T = 128, tst.H.shape[1], len(prog.pairs)
    X = np.zeros((B, Vp), dtype=np.float32)
    X[:, : prog.num_vars] = np.minimum(rng.integers(0, 2, size=(B, prog.num_vars)), prog.x_ub)
    X[np.arange(B), T + rng.integers(0, T, size=B)] = rng.integers(256, 401, size=B)
    assert X.max() > 255
    scores, hx = tscore.score_rows_int8_plain(tst, torch.as_tensor(X), want_hx=True)
    s_plain, hx_plain = tscore.score_rows_plain(tst, torch.as_tensor(X), want_hx=True)
    assert torch.equal(hx, hx_plain)
    hx64 = X.astype(np.float64) @ np.asarray(jst.H, dtype=np.float64).T
    np.testing.assert_array_equal(hx.numpy(), hx64.astype(np.float32))
    assert float(s_plain.max()) < 2.0**23
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscore.score_batch_pallas(jst, X, block_b=128)))
    assert torch.equal(scores, s_plain)


def test_int8_mirror_takes_the_case_axis():
    progs = [_random_prog(np.random.default_rng(40 + k), n) for k, n in enumerate((5, 7, 6))]
    st = stack_cases(progs, "cpu")
    assert tscore.k1_planes(st) == 1
    rng = np.random.default_rng(1)
    G, _, Vp = st.H.shape
    X = np.zeros((G, 64, Vp), dtype=np.float32)
    for g, prog in enumerate(progs):
        X[g, :, : prog.num_vars] = np.minimum(rng.integers(0, 3, size=(64, prog.num_vars)), prog.x_ub)
    s_i8, hx_i8 = tscore.score_rows_int8_plain(st, torch.as_tensor(X), want_hx=True)
    s_p, hx_p = tscore.score_rows_plain(st, torch.as_tensor(X), want_hx=True)
    assert torch.equal(hx_i8, hx_p) and torch.equal(s_i8, s_p)


def test_int8_mirror_truncates_like_the_kernel():
    """The kernel converts X with __float2int_rz: the mirror truncates
    the same way (the search's candidates are integers anyway)."""
    prog = small_progs()["egfr6"]
    tst = tscore.scoring_tensors(prog, "cpu")
    X = candidates(np.random.default_rng(2), prog, tst.H.shape[1], 16, high=3)
    _, hx = tscore.score_rows_int8_plain(tst, torch.as_tensor(X + 0.75 * (X > 0)), want_hx=True)
    _, hx_int = tscore.score_rows_plain(tst, torch.as_tensor(X), want_hx=True)
    assert torch.equal(hx, hx_int)


def test_k1_dispatch_rule_on_programs_that_fail_it():
    """A 0.25 coefficient leaves the rows inexact in int8 (f32 path); so
    does a box whose row values could reach 2^24, a box past 2^16, and
    rows or widths that are not multiples of 64."""
    egfr = _egfr_prog()
    assert tscore.k1_planes(tscore.scoring_tensors(egfr, "cpu")) == 1
    quarter = dataclasses.replace(egfr, A_fbi=egfr.A_fbi * 0.5)
    st_q = tscore.scoring_tensors(quarter, "cpu")
    assert not st_q.int8_ok and tscore.k1_planes(st_q) == 0
    with pytest.raises(ValueError, match="int8-exact"):
        tscore.score_rows_int8_plain(st_q, torch.zeros((2, st_q.H.shape[1])))
    # the CPU wrapper still scores it, with the plain f32 version
    s, _ = tscore.score_rows(st_q, torch.zeros((2, st_q.H.shape[1])))
    assert s.shape == (2,)

    st = tscore.scoring_tensors(_random_prog(np.random.default_rng(12), 14), "cpu")
    Vp = st.H8.shape[1]
    amax = st.h8_absmax()
    edge = (2**24 - 1) // (amax * Vp)  # the largest box below 2^24
    assert 255 < edge < 2**16
    assert tscore.k1_planes(dataclasses.replace(st, x_ub_max=float(edge))) == 2
    assert tscore.k1_planes(dataclasses.replace(st, x_ub_max=float(edge + 1))) == 0
    assert tscore.k1_planes(dataclasses.replace(st, x_ub_max=255.0)) == 1
    assert tscore.k1_planes(dataclasses.replace(st, x_ub_max=255.5)) == 2
    assert tscore.k1_planes(dataclasses.replace(st, x_ub_max=float(2**16))) == 0

    rows = st.H8.shape[0]
    odd = dataclasses.replace(st, H8=st.H8[:, : Vp - 32], H=st.H[:, : Vp - 32])
    assert tscore.k1_planes(odd) == 0
    short = dataclasses.replace(st, H8=st.H8[: rows - 8], H=st.H[: rows - 8])
    assert tscore.k1_planes(short) == 0
