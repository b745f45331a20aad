"""K1's f32 path on the CPU: the int8 gate that sends rows to it, and
the wrapper's checks on what only it takes.

`k1_planes` sends a program to the f32 path when its box could carry a
row value past 2^24. On an int8-exact, integer-target program with only
its box bound raised, the f32 plain version must then score bitwise as
the int8 arithmetic does on the original tensors, and as the JAX
package's Pallas scorer (in interpret mode) does. The kernel itself runs
only on the card (tests/test_torch_cuda.py).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ambigram_tpu.engine.pipeline import extract_programs
from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case
from ambigram_tpu.solver import score as jscore
from ambigram_tpu_torch.parallel.mesh import stack_cases
from ambigram_tpu_torch.solver import score as tscore
from test_torch_cuda import dyadic_rows
from test_torch_score import candidates, port_from_jax

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)


def proxy_prog(tmp_path, seed):
    """A case of the bench proxy's recipe (S=16, 4 rounds, process mode,
    noise 0): int8-exact rows, integer targets."""
    case = simulate_bfb_case(seed=seed, n_segments=16, rounds=4, mode="process", noise=0.0)
    return extract_programs(write_case(case, str(tmp_path / ("sp%d" % seed)))["lh"])[0]


def past_the_gate(st):
    """`st` with only its box bound raised to the least x_ub_max whose
    ceiling times max|H8| times Vp reaches 2^24."""
    amax, vp = st.h8_absmax(), st.H8.shape[-1]
    wide = dataclasses.replace(st, x_ub_max=float(math.ceil(2**24 / (amax * vp))))
    assert math.ceil(wide.x_ub_max) * amax * vp >= 2**24 > (math.ceil(wide.x_ub_max) - 1) * amax * vp
    return wide


@pytest.mark.parametrize("seed", [400, 401])
def test_gate_sends_rows_past_2_24_to_the_f32_path(tmp_path, seed):
    prog = proxy_prog(tmp_path, seed)
    jst = jscore.scoring_tensors(prog)
    st = port_from_jax(jst)
    assert st.int8_ok and tscore.k1_planes(st) == 1
    wide = past_the_gate(st)
    assert wide.int8_ok and wide.x_ub_max < 2**16
    assert tscore.k1_planes(wide) == 0
    B, Vp = 64, st.H.shape[1]
    X = candidates(np.random.default_rng(seed), prog, Vp, B, high=4)
    s_f32, hx_f32 = tscore.score_rows(wide, torch.as_tensor(X), want_hx=True)
    s_i8, hx_i8 = tscore.score_rows_int8_plain(st, torch.as_tensor(X), want_hx=True)
    assert torch.equal(hx_f32, hx_i8) and torch.equal(s_f32, s_i8)
    rows = st.H.shape[0]
    pallas = jscore.score_batch_pallas(jst, X, block_b=B, block_r=math.gcd(rows, 512))
    np.testing.assert_array_equal(s_f32.numpy(), np.asarray(pallas))
    s_only, no_hx = tscore.score_rows(wide, torch.as_tensor(X))
    assert no_hx is None and torch.equal(s_only, s_f32)


def test_gate_sends_a_stacked_group_past_2_24_to_the_f32_path(tmp_path):
    """A case-stacked group takes the f32 path as a whole when its
    widest box passes the gate, and scores as one call per case."""
    progs = [proxy_prog(tmp_path, seed) for seed in (402, 403, 404)]
    st = stack_cases(progs, "cpu")
    assert tscore.k1_planes(st) == 1
    wide = past_the_gate(st)
    assert tscore.k1_planes(wide) == 0
    rng = np.random.default_rng(7)
    X = torch.as_tensor(np.stack([candidates(rng, p, st.H.shape[-1], 16, high=3) for p in progs]))
    s, hx = tscore.score_rows(wide, X, want_hx=True)
    s_i8, hx_i8 = tscore.score_rows_int8_plain(st, X, want_hx=True)
    assert torch.equal(s, s_i8) and torch.equal(hx, hx_i8)
    for g in range(len(progs)):
        s_g, hx_g = tscore.score_rows(wide.case(g), X[g], want_hx=True)
        assert torch.equal(s_g, s[g]) and torch.equal(hx_g, hx[g])


@pytest.mark.parametrize("rows, vp, B", [(1000, 999, 7), (777, 1284, 65), (130, 66, 1)])
def test_f32_path_takes_ragged_shapes(rows, vp, B):
    """Rows and Vp that the int8 path refuses: the scores and hx of a
    float64 product, exact on the 0.25 lattice."""
    st = dyadic_rows(np.random.default_rng(0), rows, vp, "cpu")
    assert tscore.k1_planes(st) == 0
    X = np.random.default_rng(B).integers(0, 4, size=(B, vp)).astype(np.float32)
    s, hx = tscore.score_rows(st, torch.as_tensor(X), want_hx=True)
    hx64 = X.astype(np.float64) @ st.H.numpy().astype(np.float64).T
    want = (np.maximum(hx64 - st.ub.numpy(), 0) + np.maximum(st.lb.numpy() - hx64, 0)).sum(axis=1)
    assert hx.shape == (B, rows) and s.shape == (B,)
    np.testing.assert_array_equal(hx.numpy(), hx64.astype(np.float32))
    np.testing.assert_array_equal(s.numpy(), want.astype(np.float32))


def _bad_call(kind):
    st = dyadic_rows(np.random.default_rng(0), 64, 32, "cpu")
    X = torch.zeros((4, 32))
    if kind == "x_float64":
        return st, X.double(), TypeError, "float32"
    if kind == "h_float16":
        return dataclasses.replace(st, H=st.H.half()), X, TypeError, "float32"
    if kind == "x_width":
        return st, torch.zeros((4, 31)), ValueError, "does not match"
    if kind == "x_one_dim":
        return st, torch.zeros(32), ValueError, "does not match"
    if kind == "cases_without_case_axis":
        return st, torch.zeros((2, 4, 32)), ValueError, "does not match"
    if kind == "case_count":
        stacked = dataclasses.replace(st, H=st.H.expand(3, 64, 32), lb=st.lb.expand(3, 64), ub=st.ub.expand(3, 64))
        return stacked, torch.zeros((2, 4, 32)), ValueError, "does not match"
    if kind == "bounds_shape":
        return dataclasses.replace(st, lb=st.lb[:63]), X, ValueError, "lb/ub"
    if kind == "devices":
        return st, X.to("meta"), ValueError, "one device"
    if kind == "meta_device":
        return st.to("meta"), X.to("meta"), ValueError, "cpu or cuda"
    raise AssertionError(kind)


@pytest.mark.parametrize(
    "kind",
    ["x_float64", "h_float16", "x_width", "x_one_dim", "cases_without_case_axis", "case_count", "bounds_shape",
     "devices", "meta_device"],
)
def test_score_rows_refuses_what_the_f32_path_cannot_take(kind):
    """The wrapper's checks, made before it picks a path or a device:
    the same calls on a CUDA tensor raise before any launch."""
    st, X, exc, match = _bad_call(kind)
    with pytest.raises(exc, match=match):
        tscore.score_rows(st, X)
