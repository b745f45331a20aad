"""The readers of the LNS tail's full polish, eps gain and capped MILPs
(`lns_full_s_per_case`, `lns_eps_gain_per_case`,
`lns_milp_capped_share`) on given phases (seconds by name, as
`run_window` keeps them) and counters: their numbers, 0 included, and
None on a program that counts no probe and times no full polish."""

from types import SimpleNamespace

import pytest

from bfbbench import run

READERS = ("lns_full_s_per_case", "lns_eps_gain_per_case", "lns_milp_capped_share")


def window(phases=None, counters=None, cases=8):
    return SimpleNamespace(cases=cases, phases=dict(phases or {}), counters=dict(counters or {}))


def read(name, ctx):
    return run.load_reader(name).read(ctx)


def test_values_from_phases_and_counters():
    ctx = window(
        {"solve.lns": 6.0, "solve.lns.probe": 2.0, "solve.lns.full": 3.2},
        {"lns.probes": 3.0, "lns.escalations": 1.0, "lns.milps": 4.0, "lns.milp_capped": 3.0, "lns.eps_gain": 0.4},
    )
    assert read("lns_full_s_per_case", ctx) == pytest.approx(0.4)
    assert read("lns_eps_gain_per_case", ctx) == pytest.approx(0.05)
    assert read("lns_milp_capped_share", ctx) == pytest.approx(0.75)


def test_probes_alone_read_zero():
    """Probes that escalated nothing and gained nothing read 0, not None;
    a loss reads below 0."""
    ctx = window({"solve.lns": 1.5, "solve.lns.probe": 1.5}, {"lns.probes": 3.0, "lns.milps": 3.0, "lns.eps_gain": 0.0})
    assert read("lns_full_s_per_case", ctx) == 0.0
    assert read("lns_eps_gain_per_case", ctx) == 0.0
    assert read("lns_milp_capped_share", ctx) == 0.0
    loss = window({"solve.lns": 2.0, "solve.lns.full": 2.0}, {"lns.eps_gain": -1.6})
    assert read("lns_eps_gain_per_case", loss) == pytest.approx(-0.2)


def test_no_milp_reads_no_capped_share():
    ctx = window({"solve.lns": 0.1, "solve.lns.probe": 0.1}, {"lns.probes": 1.0, "lns.eps_gain": 0.0})
    assert read("lns_milp_capped_share", ctx) is None
    assert read("lns_full_s_per_case", ctx) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_none_on_a_program_that_counts_nothing(name):
    """A program without these phases and counters: its LNS tail times
    `solve.lns` and counts neighbourhoods, but no probe and no full
    polish."""
    parent = window({"solve.lns": 4.0, "solve.lns.milp": 3.0}, {"lns.neighbourhoods": 15.0, "lns.improved": 0.0})
    assert read(name, parent) is None
    assert read(name, window()) is None
