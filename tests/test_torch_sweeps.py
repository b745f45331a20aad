"""The port's sweeps against the JAX ones, in lockstep.

Both sides get identical (X, hx, scores, catalogue) and take about ten
consecutive sweeps; after every one, X, hx, scores and the `improved`
flag must be bitwise equal. The programs have integer targets and the
candidates stay near-feasible, so every f32 sum is exact and equality is
the right test. Programs of more than one 128-chunk (in variables and in
moves) exercise the cross-chunk strict-improvement fold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ambigram_tpu.solver import score as jscore
from ambigram_tpu.solver import search as jsearch
from ambigram_tpu_torch.solver import host, sweeps
from ambigram_tpu_torch.solver.score import score_from_hx
from test_solver import _egfr_prog, _random_prog
from test_torch_score import port_from_jax

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

STEPS = 10


def lockstep_prog(name):
    if name == "egfr6":
        return _egfr_prog()
    return _random_prog(np.random.default_rng(5), n=14)  # V=210: 2 variable chunks


def start_state(prog, jst, seed, B=16):
    """Seeded population, each member but the first kicked at 4
    variables by +-1/+-2, clipped to the box; hx and scores exact."""
    Vp = jst.H.shape[1]
    x_ub = np.asarray(jst.x_ub)
    X, _ = host._seed_case(prog, Vp, x_ub, B, seed)
    rng = np.random.default_rng(seed)
    for b in range(1, B):
        np.add.at(X[b], rng.integers(0, prog.num_vars, size=4), rng.choice([-2.0, -1.0, 1.0, 2.0], size=4))
    X = np.clip(X, 0.0, x_ub).astype(np.float32)
    hx = (X.astype(np.float64) @ np.asarray(jst.H, dtype=np.float64).T).astype(np.float32)
    scores = np.array(jsearch._score_from_hx(jst, jnp.asarray(hx)))
    return X, hx, scores


def catalogues(prog, kind):
    if kind == "delta":
        return ()
    if kind == "moves":
        return host.slide_transfer_moves(prog)
    return host.split_merge_moves(prog)


JAX_SWEEPS = {
    "delta": jsearch._sweep_delta,
    "moves": jsearch._sweep_moves,
    "moves3": jsearch._sweep_moves3,
}
PORT_SWEEPS = {
    "delta": sweeps.sweep_delta,
    "moves": sweeps.sweep_moves,
    "moves3": sweeps.sweep_moves3,
}


def as_port_index(a):
    t = torch.as_tensor(a)
    return t.to(torch.int64) if t.dtype == torch.int32 else t


@pytest.mark.parametrize("kind", ["delta", "moves", "moves3"])
@pytest.mark.parametrize("name", ["egfr6", "rand14"])
def test_sweep_lockstep_with_jax(name, kind):
    prog = lockstep_prog(name)
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    X, hx, scores = start_state(prog, jst, seed=3)
    cat = catalogues(prog, kind)
    if kind == "moves3":
        assert len(cat[0]) > 128  # several chunks
    jcat = tuple(jnp.asarray(a) for a in cat)
    tcat = tuple(as_port_index(a) for a in cat)
    jX, jhx, js = jnp.asarray(X), jnp.asarray(hx), jnp.asarray(scores)
    tX, thx, ts = torch.as_tensor(X), torch.as_tensor(hx), torch.as_tensor(scores)
    np.testing.assert_array_equal(score_from_hx(tst, thx).numpy(), scores)
    n_improved = 0
    for step in range(STEPS):
        jX, jhx, js, jimp = JAX_SWEEPS[kind](jst, jX, jhx, js, *jcat)
        tX, thx, ts, timp = PORT_SWEEPS[kind](tst, tX, thx, ts, *tcat)
        msg = "%s %s step %d" % (name, kind, step)
        np.testing.assert_array_equal(tX.numpy(), np.asarray(jX), err_msg=msg)
        np.testing.assert_array_equal(thx.numpy(), np.asarray(jhx), err_msg=msg)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=msg)
        assert bool(timp) == bool(jimp), msg
        n_improved += bool(timp)
    assert n_improved >= 1  # the steps did apply moves
    # hx stays the exact row values of X
    hx64 = tX.numpy().astype(np.float64) @ np.asarray(jst.H, dtype=np.float64).T
    np.testing.assert_array_equal(thx.numpy(), hx64.astype(np.float32))


def test_invalid_moves_never_win():
    """At X = 0 every minus move leaves the box and scores as the
    current score, so it is never applied, whatever its hinge sum."""
    prog = _egfr_prog()
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    B, Vp = 4, jst.H.shape[1]
    X = torch.zeros((B, Vp))
    hx = torch.zeros((B, jst.H.shape[0]))
    s = score_from_hx(tst, hx)
    X2, _, s2, _ = sweeps.sweep_delta(tst, X, hx, s)
    assert (X2 >= 0).all() and (X2 <= tst.x_ub).all()
    assert (s2 <= s).all()
