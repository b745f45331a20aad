"""JAX's in-flight window in the port's `solve_device_batch`, on the CPU.

The batch keeps up to `search.MAX_INFLIGHT` (4, JAX's `max_inflight`)
case-stacked groups seeded, stacked and searching at once, in JAX's
order (-cases x variables), and drains the oldest first. A group's
search depends only on its own cases and seeds (each case has its own
kick generator), so every case's x and eps must be those of a window of
1. Seven small integer-target programs make six groups (one of two
cases), so the window fills, slides and drains. Without polish no
wall-clock budget enters, and the comparison is exact.
"""

import threading

import numpy as np
import pytest
import torch

from ambigram_tpu_torch.solver import search
from test_solver import _random_prog

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

SIZES = (4, 5, 6, 6, 7, 8, 9)  # one program each; the two n = 6 share a group
BUDGETS = dict(pop=8, rounds=2, max_sweeps=32, polish=False, device="cpu")


def window_progs():
    return [_random_prog(np.random.default_rng(20 + k), n) for k, n in enumerate(SIZES)]


def run_batch(window: int):
    """solve_device_batch with the window set to `window`, recording the
    groups in flight (dispatched and not yet drained) as each group
    starts, and the order in which the groups are drained."""
    progs = window_progs()
    lock = threading.Lock()
    state = {"started": 0, "drained": 0, "max_inflight": 0, "order": []}
    real_dispatch, real_drain, real_window = search._dispatch, search._block_and_account, search.MAX_INFLIGHT

    def dispatch(group, *args, **kw):
        with lock:
            state["started"] += 1
            state["max_inflight"] = max(state["max_inflight"], state["started"] - state["drained"])
        return real_dispatch(group, *args, **kw)

    def drain(d):
        with lock:
            state["drained"] += 1
            state["order"].append(tuple(d["idxs"]))
        return real_drain(d)

    search._dispatch, search._block_and_account, search.MAX_INFLIGHT = dispatch, drain, window
    try:
        results = search.solve_device_batch(progs, **BUDGETS)
    finally:
        search._dispatch, search._block_and_account, search.MAX_INFLIGHT = real_dispatch, real_drain, real_window
    return progs, results, state


@pytest.fixture(scope="module")
def runs():
    return run_batch(search.MAX_INFLIGHT), run_batch(1)


def test_window_is_jax_max_inflight():
    assert search.MAX_INFLIGHT == 4


def test_windowed_batch_equals_a_window_of_one(runs):
    """Per case, the same x and eps with 4 groups in flight as with 1."""
    (progs, windowed, _), (_, serial, _) = runs
    assert len(windowed) == len(serial) == len(progs)
    for k, (a, b) in enumerate(zip(windowed, serial)):
        np.testing.assert_array_equal(a.x, b.x, err_msg="case %d" % k)
        assert a.epsilon_sum == b.epsilon_sum, k
        assert a.status == b.status, k
        assert float(progs[k].hard_violation(a.x.astype(np.float64))) == 0.0


def test_window_holds_at_most_four_groups(runs):
    """Six groups: more than one is in flight at once, never more than
    4; with a window of 1, one at a time."""
    (_, _, windowed), (_, _, serial) = runs
    assert windowed["started"] == windowed["drained"] == 6
    assert 2 <= windowed["max_inflight"] <= 4
    assert serial["max_inflight"] == 1


def test_window_drains_in_jax_order(runs):
    """The groups are drained oldest first, in JAX's order: most cases x
    variables first (n=9; the pair of n=6; then n=8, 7, 5, 4)."""
    (progs, _, windowed), (_, _, serial) = runs
    want = [(6,), (2, 3), (5,), (4,), (1,), (0,)]
    assert windowed["order"] == serial["order"] == want
    sizes = [len(g) * progs[g[0]].num_vars for g in want]
    assert sizes == sorted(sizes, reverse=True)
