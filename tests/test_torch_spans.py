"""The profiler's spans (`utils/profiling.Profiler.record_spans`): off,
a phase keeps none; on, every phase of every thread keeps one, on the
unix clock of torch.profiler's chrome traces, nested as the phases ran
and summing per name to the accumulators. Also the single-cell entries'
`parse` and `program_build` phases and the LNS tail's counters."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ambigram_tpu_torch.engine import sc as tsc
from ambigram_tpu_torch.scripts.simulate import simulate_sc_case, write_sc_clones
from ambigram_tpu_torch.solver import search
from ambigram_tpu_torch.utils.profiling import GLOBAL, Profiler

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)


@pytest.fixture
def recording():
    """GLOBAL reset and recording spans, and off again afterwards."""
    GLOBAL.reset()
    GLOBAL.record_spans(True)
    yield GLOBAL
    GLOBAL.record_spans(False)
    GLOBAL.reset()


@pytest.fixture
def small_search(monkeypatch):
    monkeypatch.setenv("AMBIGRAM_SEARCH_POP", "8")
    monkeypatch.setenv("AMBIGRAM_SEARCH_ROUNDS", "2")
    monkeypatch.setenv("AMBIGRAM_SEARCH_SWEEPS", "64")
    monkeypatch.setenv("AMBIGRAM_LNS_BUDGET", "60")


@pytest.fixture
def phase_threads(monkeypatch):
    """The OS ids of the threads that enter a phase of GLOBAL, seen from
    outside the profiler."""
    seen = set()
    phase = Profiler.phase

    def spy(self, name):
        seen.add(threading.get_native_id())
        return phase(self, name)

    monkeypatch.setattr(Profiler, "phase", spy)
    return seen


def sample(tmp_path, seed, n_clones, n_segments, topology="chain"):
    sc = simulate_sc_case(seed=seed, n_clones=n_clones, n_segments=n_segments, topology=topology)
    d = tmp_path / ("s%d" % seed)
    d.mkdir()
    names, edges = write_sc_clones(sc, str(d / "clone"))
    return {"lh_paths": ",".join(names), "edges": edges}


def assert_spans_agree(prof, spans):
    """Each thread's spans nest (one holds another whole, or they are
    disjoint), and per name they sum to the accumulator's seconds."""
    by_thread = {}
    for s in spans:
        assert s.start_ns <= s.end_ns
        by_thread.setdefault(s.thread, []).append(s)
    for tid, own in by_thread.items():
        open_ = []  # the spans that hold the current one, outermost first
        for s in sorted(own, key=lambda s: (s.start_ns, -s.end_ns)):
            while open_ and open_[-1].end_ns <= s.start_ns:
                open_.pop()
            assert not open_ or s.end_ns <= open_[-1].end_ns, "thread %d: %s crosses %s" % (tid, s, open_[-1])
            open_.append(s)
    for name, stats in prof.phases.items():
        mine = [s for s in spans if s.name == name]
        assert len(mine) == stats.calls, name
        assert sum(s.end_ns - s.start_ns for s in mine) * 1e-9 == pytest.approx(stats.seconds, rel=1e-6, abs=1e-12)


def test_spans_off_keep_nothing_and_the_accumulators_run_as_before():
    prof = Profiler()
    for _ in range(3):
        with prof.phase("outer"):
            with prof.phase("inner"):
                time.sleep(0.002)
    assert prof._spans is None and prof.take_spans() == []
    assert prof.phases["outer"].calls == prof.phases["inner"].calls == 3
    assert prof.phases["outer"].seconds >= prof.phases["inner"].seconds >= 0.006
    prof.record_spans(True)
    with prof.phase("outer"):
        pass
    prof.record_spans(False)
    assert prof.take_spans() == [] and prof.phases["outer"].calls == 4


def test_spans_from_many_threads_lose_none():
    """More threads than cores, a short switch interval: every phase of
    every thread keeps its span, nested as it ran."""
    prof = Profiler()
    prof.record_spans(True)
    n_threads, n_calls = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_calls):
                with prof.phase("outer"):
                    with prof.phase("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = prof.take_spans()
    assert len(spans) == 2 * n_threads * n_calls
    assert len({s.thread for s in spans}) == n_threads
    assert_spans_agree(prof, spans)
    # a reset drops the spans kept and recording goes on
    with prof.phase("outer"):
        pass
    prof.reset()
    with prof.phase("after"):
        pass
    assert [s.name for s in prof.take_spans()] == ["after"]


def test_run_sc_bfb_spans_and_lns_counters(tmp_path, recording, phase_threads, small_search, monkeypatch):
    """A sample whose search is left short (an all-zero population, one
    sweep) reaches the LNS tail: its spans agree with the accumulators,
    the entry's parse and program build are phases, and LNS counts the
    neighbourhoods it solved and those it accepted."""
    monkeypatch.setenv("AMBIGRAM_SEARCH_ROUNDS", "1")
    monkeypatch.setenv("AMBIGRAM_SEARCH_SWEEPS", "1")
    seed_case = search._seed_case

    def zero_population(prog, Vp, x_ub, pop, seed):
        X, lb = seed_case(prog, Vp, x_ub, pop, seed)
        return np.zeros_like(X), lb

    monkeypatch.setattr(search, "_seed_case", zero_population)
    s = sample(tmp_path, 5, 3, 10, "star")
    tsc.run_sc_bfb(s["lh_paths"], solver="device", device="cpu", edges=s["edges"])
    spans = recording.take_spans()
    assert {"parse", "program_build", "solve", "solve.measure", "solve.lns", "replay"} <= {s.name for s in spans}
    assert {s.thread for s in spans} == phase_threads
    assert_spans_agree(recording, spans)
    tried = recording.counters["lns.neighbourhoods"]
    assert tried >= 1 and 1 <= recording.counters["lns.improved"] <= tried


def test_run_sc_bfb_many_spans_come_from_every_thread(tmp_path, recording, phase_threads, small_search):
    samples = [sample(tmp_path, seed, 2, 10) for seed in (0, 1)]
    tsc.run_sc_bfb_many(samples, solver="device", device="cpu")
    spans = recording.take_spans()
    threads = {s.thread for s in spans}
    assert threads == phase_threads and len(threads) > 1
    assert threading.get_native_id() in threads
    names = {s.name for s in spans}
    assert {"parse", "program_build", "score", "replay"} <= names
    # the cohort parses and builds every sample on the main thread, then
    # again in each sample's replay on the pool
    main = threading.get_native_id()
    assert sum(s.name == "parse" and s.thread == main for s in spans) == 2
    assert any(s.name == "parse" and s.thread != main for s in spans)
    assert_spans_agree(recording, spans)


def test_spans_share_the_chrome_traces_clock(tmp_path):
    """A span opened inside a record_function marker on the main thread
    lies where the exported trace puts the marker, within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = Profiler()
    prof.record_spans(True)
    with record_function("warm-up"):
        pass
    trace = profile(activities=[ProfilerActivity.CPU], acc_events=True)
    with trace:
        time.sleep(0.005)
        with record_function("marker"):
            with prof.phase("span"):
                time.sleep(0.005)
    path = tmp_path / "trace.json"
    trace.export_chrome_trace(str(path))
    with open(path) as f:
        exported = json.load(f)
    base = int(exported["baseTimeNanoseconds"])
    marker = next(e for e in exported["traceEvents"] if e.get("name") == "marker" and e.get("ph") == "X")
    (span,) = prof.take_spans()
    start_us, end_us = (span.start_ns - base) / 1e3, (span.end_ns - base) / 1e3
    assert abs(start_us - float(marker["ts"])) < 1000.0
    assert abs(end_us - (float(marker["ts"]) + float(marker["dur"]))) < 1000.0
