"""The port's gated descent against the JAX package's device loops.

On the card the descent's while_loop carry and its lax.cond tier gates
are state words that every sweep launch reads, and the host queues
blocks of iterations (solver/search.py `descend_loop`, solver/sweeps.py
`SweepOps`). Here the same loop runs on the CPU with the plain sweeps,
gated on the host from the same words. From identical inputs on
integer-target programs (the 0.5 lattice, where every f32 sum is exact)
it must land bitwise where JAX's `_descend_loop` and the descent of
`_batch_search` land, with the same three sweep counts, whatever the
block size: an iteration after convergence or past the budget is a
no-op. A program built so that moves tie shows that the port's sweeps
pick JAX's move.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ambigram_tpu.parallel import mesh as jmesh
from ambigram_tpu.solver import score as jscore
from ambigram_tpu.solver import search as jsearch
from ambigram_tpu_torch.solver import host, search, sweeps
from test_solver import _random_prog
from test_torch_batch import start_states
from test_torch_cuda import TIE_VARS, tie_case
from test_torch_score import port_from_jax
from test_torch_sweeps import as_port_index, lockstep_prog, start_state

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

_jax_descend = jax.jit(jsearch._descend_loop, static_argnames=("max_sweeps", "chunk"))


def _catalogues(prog):
    moves, moves3 = host.slide_transfer_moves(prog), host.split_merge_moves(prog)
    return (
        tuple(jnp.asarray(a) for a in moves),
        tuple(jnp.asarray(a) for a in moves3),
        tuple(as_port_index(a) for a in moves),
        tuple(as_port_index(a) for a in moves3),
    )


def _single_descents(name, max_sweeps, block, monkeypatch):
    prog = lockstep_prog(name)
    jst = jscore.scoring_tensors(prog)
    X, hx, scores = start_state(prog, jst, seed=9)
    jm, jm3, tm, tm3 = _catalogues(prog)
    want = _jax_descend(jst, jnp.asarray(X), jnp.asarray(hx), jnp.asarray(scores), max_sweeps=max_sweeps, chunk=128,
                        moves=jm, moves3=jm3)
    monkeypatch.setattr(search, "DESCEND_BLOCK", block)
    got = search.descend_loop(port_from_jax(jst), torch.as_tensor(X), torch.as_tensor(hx), torch.as_tensor(scores),
                              max_sweeps, 128, tm, tm3)
    return got, want


def _assert_same(got, want):
    for t, j in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tuple(got[3:]) == tuple(int(v) for v in want[3:])


@pytest.mark.parametrize("block", [1, 3, 8, 1000])
@pytest.mark.parametrize("name", ["egfr6", "rand14"])
def test_gated_descent_matches_jax_descend_loop(name, block, monkeypatch):
    """One case: X, hx, scores and (n_delta, n_moves, n_moves3) bitwise
    equal to JAX's `_descend_loop` at a budget the descent does not
    reach, for block sizes below, at and far above its length."""
    got, want = _single_descents(name, 64, block, monkeypatch)
    _assert_same(got, want)
    assert got[3] < 64 and got[4] >= 1 and got[5] >= 1  # converged, every tier ran


@pytest.mark.parametrize("max_sweeps", [0, 1, 5])
def test_gated_descent_stops_at_the_budget_mid_block(max_sweeps, monkeypatch):
    """A budget that ends inside a block of 8: the iterations past it are
    no-ops and count nothing, as JAX's while_loop stops there."""
    got, want = _single_descents("rand14", max_sweeps, 8, monkeypatch)
    _assert_same(got, want)
    assert got[3] == max_sweeps


def _stacked_progs(G):
    """G integer-target programs of one interval (V = 210)."""
    return [_random_prog(np.random.default_rng(5 + g), 14) for g in range(G)]


@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_gated_descent_matches_jax_batch_search(G, block, monkeypatch):
    """A case-stacked group through one round of the batch search: the
    descent of `_batch_search` with its batch-global gates (tier 2 unless
    every case improved at tier 1, tier 3 only when none improved at
    tiers 1 and 2). Each case's round best (x and score) and the three
    sweep counts are bitwise JAX's; the kicks come after the fold, so
    they do not enter."""
    progs = _stacked_progs(G)
    jst = jmesh.stack_cases(progs)
    X, _ = start_states(progs, jst)
    jm, jm3, tm, tm3 = _catalogues(progs[0])
    keys = jnp.stack([jax.random.PRNGKey(k) for k in range(G)])
    jbest_x, jbest_s, jsweeps, _ = jsearch._batch_search(
        jst, jnp.asarray(X), keys, jm, jm3, rounds=1, max_sweeps=64, targets=jnp.zeros(G, jnp.float32), patience=2
    )
    monkeypatch.setattr(search, "DESCEND_BLOCK", block)
    gens = [torch.Generator().manual_seed(k) for k in range(G)]
    best_x, best_s, counts, _ = search.batch_search(port_from_jax(jst), torch.as_tensor(X), gens, tm, tm3, rounds=1,
                                                    max_sweeps=64)
    np.testing.assert_array_equal(best_x.numpy(), np.asarray(jbest_x))
    np.testing.assert_array_equal(best_s.numpy(), np.asarray(jbest_s))
    assert tuple(counts) == tuple(int(v) for v in jsweeps)
    assert counts[1] >= 1 and counts[2] >= 1


def _jax_tie_tensors():
    leaves, X, moves, moves3 = tie_case()
    jst = jscore.ScoringTensors(**{k: jnp.asarray(v) for k, v in leaves.items()}, num_vars=256, num_residual_rows=1,
                                int8_ok=True, x_ub_max=3.0)
    hx = (X.astype(np.float64) @ leaves["H"].astype(np.float64).T).astype(np.float32)
    scores = np.array(jsearch._score_from_hx(jst, jnp.asarray(hx)))
    return jst, X, hx, scores, moves, moves3


@pytest.mark.parametrize("kind", ["delta", "moves", "moves3"])
def test_tie_order_matches_jax(kind):
    """Moves that tie (`test_torch_cuda.tie_case`): + and - within a
    delta chunk, equal moves in two chunks, equal moves within one chunk.
    The port's sweep picks JAX's move: + first, the earlier chunk, the
    first within a chunk."""
    jst, X, hx, scores, moves, moves3 = _jax_tie_tensors()
    cat = {"delta": (), "moves": moves, "moves3": moves3}[kind]
    jfn = {"delta": jsearch._sweep_delta, "moves": jsearch._sweep_moves, "moves3": jsearch._sweep_moves3}[kind]
    tfn = sweeps.PLAIN_SWEEPS[kind]
    want = jfn(jst, jnp.asarray(X), jnp.asarray(hx), jnp.asarray(scores), *(jnp.asarray(a) for a in cat))
    got = tfn(port_from_jax(jst), torch.as_tensor(X), torch.as_tensor(hx), torch.as_tensor(scores),
              *(as_port_index(a) for a in cat))
    for t, j in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert bool(got[3]) == bool(want[3]) is True
    v = TIE_VARS
    moved = {"delta": {v["plus"]: 1.0, v["minus"]: 1.0}, "moves": {v["far"]: 1.0, v["spare"]: 0.0},
             "moves3": {v["far"]: 1.0, v["spare"]: 0.0, v["empty"]: 1.0}}[kind]
    for var, value in moved.items():
        assert float(got[0][0, var]) == value, (kind, var)


@pytest.mark.parametrize("G", [1, 2, 3])
def test_state_words_follow_the_jax_predicates(G):
    """`sweep_gate` and `settle_state` (the kernel's gate and state fold,
    on host words) against JAX's `_batch_search` predicates written out,
    for every pattern of per-case flags over one iteration: tier 2 runs
    unless all cases improved at tier 1, tier 3 only when none improved
    at tiers 1 and 2; improved is any of the three; it advances by one."""
    for imp1, imp2, imp3 in itertools.product(itertools.product([False, True], repeat=G), repeat=3):
        words = sweeps.new_state(10, "cpu").tolist()
        words[sweeps.S_IT] = 4
        assert sweeps.sweep_gate(words, 0)
        sweeps.settle_state(words, 0, list(imp1), last=False)
        run2 = sweeps.sweep_gate(words, 1)
        assert run2 == (not all(imp1))
        any2 = run2 and any(imp2)
        if run2:
            sweeps.settle_state(words, 1, list(imp2), last=False)
        run3 = sweeps.sweep_gate(words, 2)
        assert run3 == (not (any(imp1) or any2))
        any3 = run3 and any(imp3)
        sweeps.settle_state(words, 2, list(imp3) if run3 else [], last=True)
        assert words[sweeps.S_IMPROVED] == int(any(imp1) or any2 or any3)
        assert (words[sweeps.S_IT], words[sweeps.S_N_MV], words[sweeps.S_N_M3]) == (5, int(run2), int(run3))
        assert words[sweeps.S_ANY1] == words[sweeps.S_ALL1] == words[sweeps.S_ANY2] == words[sweeps.S_ANY3] == 0


def test_state_words_freeze_once_inactive():
    """After convergence (improved 0) or at the budget (it = max_sweeps)
    every gate is off and settling changes no word: the no-op iterations
    of a block count nothing."""
    for improved, it in ((0, 3), (1, 10)):
        words = sweeps.new_state(10, "cpu").tolist()
        words[sweeps.S_IMPROVED], words[sweeps.S_IT] = improved, it
        frozen = list(words)
        for kind in (0, 1, 2):
            assert not sweeps.sweep_gate(words, kind)
            sweeps.settle_state(words, kind, [True], last=kind == 2)
        assert words == frozen


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel's wrappers run on CUDA tensors only: on the CPU the
    descent takes the plain sweeps through `SweepOps`, and the wrappers
    raise rather than run them in the kernel's place."""
    jst, X, hx, scores, moves, moves3 = _jax_tie_tensors()
    tst = port_from_jax(jst)
    tX, thx, ts = torch.as_tensor(X), torch.as_tensor(hx), torch.as_tensor(scores)
    with pytest.raises(ValueError, match="CUDA"):
        sweeps.sweep_kernel("delta", tst, tX, thx, ts)
    ops = sweeps.SweepOps(tst, tX)
    assert not ops.cuda and ops.tiers == [0]
    with pytest.raises(ValueError, match="CUDA"):
        sweeps.launch_sweep(ops, 0, tX, thx, ts, sweeps.new_state(1, "cpu"))
