"""The reader of the seeding LP's iterations (`lp_iterations_per_case`)
on given counters: the count over the window's cases, and None on a
program that counts no LP."""

from types import SimpleNamespace

import pytest

from bfbbench import run


def window(counters=None, cases=8):
    return SimpleNamespace(cases=cases, phases={"solve.lp_bound": 9.6}, counters=dict(counters or {}))


def read(ctx):
    return run.load_reader("lp_iterations_per_case").read(ctx)


def test_iterations_over_the_cases():
    assert read(window({"lp.solves": 9.0, "lp.iterations": 12557.0})) == pytest.approx(12557.0 / 8)
    assert read(window({"lp.solves": 8.0, "lp.iterations": 0.0})) == 0.0


def test_none_without_the_counter():
    """A program that times the LP's phase but counts no LP solve."""
    assert read(window({"lns.probes": 7.0})) is None
    assert read(window()) is None
    assert read(window({"lp.solves": 1.0, "lp.iterations": 30.0}, cases=0)) is None
