"""The port's int8 scorer and benchmark chain (K2's plain version) against
the JAX package.

Inputs come from numpy (`default_rng`) and feed both sides. On the small
programs every sum is an integer below 2^24, so the comparisons are
bitwise. On the bench program a candidate's score is about 5e7, above
2^24: its f32 row sum rounds, two summation orders may differ in the
last bits, and a different score can flip a later bump, so there the
checksums are held to rel 1e-5 (the bar bench.py's layout sweep uses).
The CUDA kernel's own checks are in test_torch_cuda.py.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ambigram_tpu.solver import score as jscore
from ambigram_tpu_torch.solver import score as tscore
from test_solver import _random_prog
from test_torch_score import candidates, port_from_jax, small_progs

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def jax_chain(jst, X, iters):
    """bench.py's XLA `chained` loop, also returning the final X."""

    def body(i, carry):
        X, acc = carry
        s = jscore.score_batch(jst, X)
        return jscore.chained_mutate(X, s, i, jst.x_ub), acc + jnp.sum(s)

    X, acc = jax.jit(
        lambda jst, X0: jax.lax.fori_loop(0, iters, body, (X0, jnp.float32(0)))
    )(jst, jnp.asarray(X))
    return np.asarray(X), float(acc)


def small_chain_case():
    """The small program and candidates of tests/test_solver.py's chain
    test: int8 scoring, every sum exact."""
    rng = np.random.default_rng(2)
    prog = _random_prog(rng, 10)
    prog.x_ub = np.minimum(prog.x_ub, 127)
    jst = jscore.scoring_tensors(prog)
    assert jst.use_int8
    X = np.zeros((256, jst.H.shape[1]), dtype=np.float32)
    X[:, : prog.num_vars] = rng.integers(0, 2, size=(256, prog.num_vars))
    return prog, jst, X


@pytest.mark.parametrize("name", ["egfr6", "rand0", "rand1", "rand2", "rand3"])
def test_int8_score_batch_is_bitwise_jax(name):
    """The repaired int8 scorer (one exact f32 product of the int8
    values) against the JAX int8 path with its int32 accumulator."""
    prog = small_progs()[name]
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    assert tst.use_int8 and tst.int8_hx_exact()
    X = candidates(np.random.default_rng(11), prog, tst.H.shape[1], 96, high=6)
    want = np.asarray(jscore.score_batch_jit(jst, X))
    got = tscore.score_batch(tst, torch.as_tensor(X)).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_score_batch_truncates_like_the_int8_cast():
    """Fractional candidate values (a fractional x_ub can clip a bumped
    lane to one) score as their truncation, as JAX's int8 cast does."""
    prog = small_progs()["egfr6"]
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    X = candidates(np.random.default_rng(4), prog, tst.H.shape[1], 32, high=4)
    X[:, : prog.num_vars] += 0.5 * (X[:, : prog.num_vars] > 0)
    want = np.asarray(jscore.score_batch_jit(jst, X))
    np.testing.assert_array_equal(tscore.score_batch(tst, torch.as_tensor(X)).numpy(), want)


def test_int8_score_batch_refuses_an_inexact_product():
    """127 * 127 * 1152 >= 2^24: a row of 127s could sum past 2^24 in
    f32, so the scorer (and K2) refuse the program."""
    rows, Vp = 256, 1152
    H8 = np.zeros((rows, Vp), dtype=np.int8)
    H8[0] = 127
    zeros, ones = np.zeros(rows, dtype=np.float32), np.ones(rows, dtype=np.float32)
    st = tscore.ScoringTensors.from_numpy(
        H=H8.astype(np.float32), lb=zeros, ub=zeros, x_ub=np.ones(Vp, dtype=np.float32),
        H8=H8, lb_raw=zeros, ub_raw=zeros, w=ones,
        num_vars=Vp, num_residual_rows=rows, int8_ok=True, x_ub_max=1.0,
    )
    assert st.use_int8 and not st.int8_hx_exact()
    with pytest.raises(ValueError, match="2\\^24"):
        tscore.score_batch(st, torch.zeros((2, Vp)))
    with pytest.raises(ValueError, match="2\\^24"):
        tscore.chained_score(st, torch.zeros((64, Vp)), 1)


@pytest.mark.parametrize("it", [0, 3, 199])
def test_chained_mutate_is_bitwise_jax_above_2_24(it):
    """At s ~ 5e7 (ulp 4) every add of the bump test rounds; the port
    keeps JAX's order of the adds, so the bumps and heads agree."""
    rng = np.random.default_rng(it)
    B, Vp = 64, 256
    s = (np.float32(5e7) + np.arange(B, dtype=np.float32) / 2).astype(np.float32)
    X = rng.integers(0, 3, size=(B, Vp)).astype(np.float32)
    x_ub = np.concatenate([rng.integers(1, 4, size=128), np.zeros(Vp - 128)]).astype(np.float32)
    x_ub[::7] = 2.5  # a fractional bound clips a bumped lane to 2.5
    want = np.asarray(jscore.chained_mutate(jnp.asarray(X), jnp.asarray(s), it, jnp.asarray(x_ub)))
    got = tscore.chained_mutate(torch.as_tensor(X), torch.as_tensor(s), it, torch.as_tensor(x_ub)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != X).any()


def test_chained_score_plain_matches_xla_loop_and_pallas():
    """K2's plain version against bench.py's XLA loop (final X bitwise,
    checksum rel 1e-6) and against the Pallas kernel in interpret mode,
    on tests/test_solver.py's small program."""
    _, jst, X = small_chain_case()
    tst = port_from_jax(jst)
    want_x, want_acc = jax_chain(jst, X, 5)
    acc, got_x = tscore.chained_score_plain(tst, torch.as_tensor(X), 5, want_x=True)
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    assert float(acc) == pytest.approx(want_acc, rel=1e-6)
    pallas = float(jscore.chained_score_pallas(jst, jnp.asarray(X), 5, block_b=128))
    assert float(acc) == pytest.approx(pallas, rel=1e-6)
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = tscore.chained_score.launches
    acc_w, x_w = tscore.chained_score(tst, torch.as_tensor(X), 5, want_x=True)
    assert tscore.chained_score.launches == before
    assert float(acc_w) == float(acc) and torch.equal(x_w, got_x)


def test_chained_score_rejects_what_the_kernel_does_not_take():
    prog, jst, X = small_chain_case()
    tst = port_from_jax(jst)
    with pytest.raises(ValueError, match="divisible"):
        tscore.chained_score(tst, torch.as_tensor(X[:100]), 2)
    with pytest.raises(ValueError, match="block_b"):
        tscore.chained_score(tst, torch.as_tensor(X), 2, block_b=48)
    with pytest.raises(ValueError, match="int8"):
        tscore.chained_score(port_from_jax(dataclasses.replace(jst, int8_ok=False)), torch.as_tensor(X), 2)


def test_bench_program_chain_matches_xla_loop():
    """The bench program at full width (3840 x 1152). build_workload's
    tensors equal bench.py's. The port's first-round scores are the
    exact hinge sums rounded once to f32 (checked against float64), and
    XLA's f32 row sums are within 2 ulp (8 at s ~ 5e7) of them. Those
    rounding differences flip bumps, so the chains drift apart: at B=64
    and 3 rounds the checksums differ by rel 5e-5, at B=4096 by less
    than 1e-5, the bar bench.py holds its layouts to."""
    import bench as jbench

    from ambigram_tpu_torch import bench as tbench

    B, iters = 4096, 3
    _, jst, jX = jbench.build_workload(batch=B)
    prog, tst, X = tbench.build_workload(batch=B)
    np.testing.assert_array_equal(X, jX)
    for k in ("H", "lb", "ub", "x_ub", "H8", "lb_raw", "ub_raw", "w"):
        np.testing.assert_array_equal(getattr(tst, k).numpy(), np.asarray(getattr(jst, k)), err_msg=k)
    assert tuple(tst.H8.shape) == (3840, 1152) and tst.use_int8

    s = tscore.score_batch(tst, torch.as_tensor(X[:256])).numpy()
    hx = X[:256].astype(np.float64) @ np.asarray(jst.H8, dtype=np.float64).T
    w, lb, ub = (np.asarray(getattr(jst, k), dtype=np.float64) for k in ("w", "lb_raw", "ub_raw"))
    exact = (w * (np.maximum(hx - ub, 0.0) + np.maximum(lb - hx, 0.0))).sum(axis=-1)
    assert exact.min() > 2.0**24
    np.testing.assert_array_equal(s, exact.astype(np.float32))
    s_xla = np.asarray(jscore.score_batch_jit(jst, X[:256]))
    assert np.abs(s_xla - s).max() <= 8.0

    _, want = jax_chain(jst, X, iters)
    got = float(tscore.chained_score_plain(tst, torch.as_tensor(X), iters))
    assert got == pytest.approx(want, rel=1e-5)
