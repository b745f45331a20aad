"""The span arithmetic (`spans.py`) and the LNS counter's reader on
synthetic spans, intervals and counters: threads that overlap count
once, a gap with no phase says so, labels keep their "after <op>" and
their length; and `spanrun.py` on the CPU at a size a test holds."""

import dataclasses
import json
from types import SimpleNamespace

import pytest

from bfbbench import run, spans

# two threads in the LNS tail at once, a parse on the main thread, a
# `solve` phase (no layer of its own) around the tail
SPANS = [
    ("parse", 1, 0.0, 1.0),
    ("solve", 1, 2.0, 8.0),
    ("solve.lns", 2, 3.0, 6.0),
    ("solve.lns", 3, 4.0, 7.0),
    ("solve.lns.milp", 3, 4.5, 5.0),
    ("replay", 1, 9.0, 9.5),
]
INTERVALS = [("k", 1.0, 1.5), ("Memcpy DtoH (Device -> Pageable)", 1.5, 2.0), ("k2", 8.5, 9.0)]
WINDOW = (0.0, 10.0)


def test_union_and_cover():
    assert spans.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]
    assert spans.cover([(0, 2), (1, 3), (5, 6)], 1.5, 5.5) == pytest.approx(2.0)
    assert spans.cover([], 0, 1) == 0.0


def test_innermost_span_of_each_thread():
    assert spans.innermost(SPANS, 4.7) == {1: "solve", 2: "solve.lns", 3: "solve.lns.milp"}
    assert spans.innermost(SPANS, 8.2) == {}


def test_unlayered_idle_counts_overlapping_threads_once():
    # covered: parse 0-1, device 1-2, lns 3-7 (two threads, once), device
    # 8.5-9, replay 9-9.5; idle and in no layer phase: 2-3, 7-8.5, 9.5-10
    assert spans.unlayered_idle_pct(SPANS, INTERVALS, WINDOW) == pytest.approx(30.0)
    assert spans.unlayered_idle_pct([], [], WINDOW) == pytest.approx(100.0)


def test_lns_wall_is_a_union_over_threads():
    assert spans.lns_wall_pct(SPANS, WINDOW) == pytest.approx(40.0)
    assert spans.lns_wall_pct(SPANS, (5.0, 10.0)) == pytest.approx(40.0)
    assert spans.lns_wall_pct([], WINDOW) == 0.0


def test_unlayered_time_by_the_phases_open():
    got = spans.unlayered_by_phase(SPANS, INTERVALS, WINDOW)
    assert got == pytest.approx({"solve": 2.0, "no phase": 1.0})


def test_gap_labels_name_the_host_work_under_each():
    gaps = spans.labelled_gaps(INTERVALS, SPANS)
    # the gaps: 2.0-8.5 after the copy; none before the first interval
    assert len(gaps) == 1
    label, secs = gaps[0]
    assert secs == pytest.approx(6.5)
    assert label == "host in solve.lns 62% (2 threads); after Memcpy DtoH (Device -> Pageable)"
    assert spans.gap_label(SPANS, 0.2, 0.8, "k") == "host in parse 100%; after k"
    assert spans.gap_label(SPANS, 7.0, 8.5, "k") == "host in no phase; after k"
    several = spans.gap_label(SPANS + [("score", 4, 6.5, 9.2)], 5.5, 9.3, "x" * 300)
    assert several.startswith("host in score 71%, solve.lns 39% (2 threads), replay 8%; after xxx")
    assert len(several) == spans.LABEL_CHARS


def test_spans_on_the_traces_clock():
    base = 1_790_000_000_000_000_000
    got = spans.on_trace_clock([("score", 7, base + 1_500_000_000, base + 2_000_000_000)], base)
    assert got == [("score", 7, pytest.approx(1.5), pytest.approx(2.0))]


def test_lns_improved_share_reader():
    read = run.load_reader("lns_improved_share").read
    assert read(SimpleNamespace(counters={"lns.neighbourhoods": 8.0, "lns.improved": 2.0})) == pytest.approx(0.25)
    assert read(SimpleNamespace(counters={"lns.neighbourhoods": 3.0})) == 0.0
    # a parent that counts nothing, or a window with no neighbourhood
    assert read(SimpleNamespace(counters={})) is None
    assert read(SimpleNamespace(counters={"lns.neighbourhoods": 0.0})) is None


def test_measure_reader():
    read = run.load_reader("measure_s_per_case").read
    assert read(SimpleNamespace(cases=4, phases={"solve.measure": 0.6})) == pytest.approx(0.15)
    # a parent without the phase reports nothing, not 0
    assert read(SimpleNamespace(cases=4, phases={"solve.lns": 1.0})) is None
    assert "solve.measure" in spans.LAYER_PHASES


def test_spans_imports_nothing_of_the_program():
    import ast
    import os

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "spans.py")) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in mods if m.split(".")[0].startswith(("ambigram", "jax", "__graft", "torch"))]


@pytest.mark.parametrize("workload", ["sc_k3_single", "sc_k3_cohort"])
def test_spanrun_on_the_cpu(workload, tmp_path, capsys, monkeypatch):
    pytest.importorskip("ambigram_tpu_torch.engine.sc")
    from bfbbench import spanrun

    bench, cell = run.load_cell(workload)
    recipe = dict(cell.config["generator"], n_segments=8)
    tiny = dataclasses.replace(cell, config=dict(cell.config, generator=recipe))
    monkeypatch.setattr(run, "load_cell", lambda name: (bench, tiny))
    assert spanrun.main(["--workload", workload, "--seeds", "3", "--seconds", "0.2", "--device", "cpu",
                         "--spans", "0,1", "--keep", str(tmp_path)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["spans"] for x in lines] == [0, 1]
    for line in lines:
        assert line["correct"] and line["trace"] == 1
        m = line["metrics"]
        assert {"host_build_s_per_case", "lns_wall_pct", "unlayered_idle_pct"} <= set(m)
        # no device on the CPU: no interval, so the layer phases alone cover
        assert 0.0 <= m["unlayered_idle_pct"] <= 100.0
    off, on = lines
    assert off["spans_kept"] == 0 and off["metrics"]["unlayered_idle_pct"] == pytest.approx(100.0)
    assert on["spans_kept"] > 0 and on["metrics"]["unlayered_idle_pct"] < 100.0
    # parse and program_build count in the engine's metric now
    assert on["phases_s"]["parse"] > 0 and on["phases_s"]["program_build"] > 0
    assert len(list(tmp_path.glob("*.json.gz"))) == 2
