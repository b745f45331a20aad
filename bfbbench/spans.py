"""The program's phase spans laid over the device's timeline.

A span is (name, thread, start_s, end_s): one phase of
`ambigram_tpu_torch.utils.profiling.GLOBAL` as one thread ran it, in
seconds on the time base of `trace.device_intervals` (the chrome
trace's `ts`, counted from its `baseTimeNanoseconds`), so that spans and
device intervals can be compared. `on_trace_clock` puts the program's
spans (unix nanoseconds) there.

The layer phases are those the per-layer metrics read (`LAYER_PHASES`).
From them and the device's intervals this module computes the share of
a window in no layer phase while the device is idle, the wall share of
the LNS tail over all threads, and labels for the device's idle gaps
that name the host work under each.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

# the phases read by the per-layer metrics host_build_s_per_case,
# tensors_s_per_case, lp_seed_s_per_case, search_s_per_case,
# measure_s_per_case and lns_s_per_case
LAYER_PHASES = ("parse", "program_build", "replay", "solve.tensors", "solve.lp_bound", "score", "solve.measure",
                "solve.lns")
LNS_PHASE = "solve.lns"
LABEL_CHARS = 120

Span = Tuple[str, int, float, float]
Pair = Tuple[float, float]


def on_trace_clock(spans: Iterable, base_ns: int) -> List[Span]:
    """The program's spans (name, thread, start_ns, end_ns on the unix
    clock) in seconds from the trace's `baseTimeNanoseconds`."""
    return [(name, tid, (t0 - base_ns) * 1e-9, (t1 - base_ns) * 1e-9) for name, tid, t0, t1 in spans]


def union(pairs: Iterable[Pair]) -> List[Pair]:
    """The union of (start, end) pairs as disjoint pairs, by start."""
    out: List[List[float]] = []
    for a, b in sorted(pairs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def cover(pairs: Iterable[Pair], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the union of the pairs covers."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(pairs))


def innermost(spans: Sequence[Span], t: float) -> Dict[int, str]:
    """The innermost span open at time t on each thread, by name: the one
    that started last among those holding t (a thread's phases nest)."""
    best: Dict[int, Tuple[float, str]] = {}
    for name, tid, a, b in spans:
        if a <= t < b and (tid not in best or a >= best[tid][0]):
            best[tid] = (a, name)
    return {tid: name for tid, (_, name) in best.items()}


def _layer_pairs(spans: Iterable[Span]) -> List[Pair]:
    return [(a, b) for name, _, a, b in spans if name in LAYER_PHASES]


def unlayered_idle_pct(spans: Sequence[Span], intervals: Sequence, window: Pair) -> float:
    """100 x the share of the window in which the device runs nothing and
    no thread is inside a layer phase."""
    lo, hi = window
    busy = [(a, b) for _, a, b in intervals] + _layer_pairs(spans)
    return 100.0 * (1.0 - cover(busy, lo, hi) / (hi - lo))


def lns_wall_pct(spans: Sequence[Span], window: Pair) -> float:
    """100 x the share of the window in which at least one thread is
    inside the LNS tail: wall time, not the threads' summed time."""
    lo, hi = window
    return 100.0 * cover([(a, b) for name, _, a, b in spans if name == LNS_PHASE], lo, hi) / (hi - lo)


def unlayered_by_phase(spans: Sequence[Span], intervals: Sequence, window: Pair) -> Dict[str, float]:
    """The seconds of the window in which the device is idle and no thread
    is in a layer phase, by the innermost phases open on any thread then
    ("no phase" where none is): what the layer metrics leave out, and in
    which code."""
    lo, hi = window
    others = [s for s in spans if s[0] not in LAYER_PHASES]
    free, t = [], lo
    for a, b in union([(a, b) for _, a, b in intervals] + _layer_pairs(spans)):
        if a > t:
            free.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        free.append((t, hi))
    out: Dict[str, float] = {}
    for a, b in free:
        if b <= a:
            continue
        inside = [s for s in others if s[2] < b and s[3] > a]
        cuts = sorted({a, b} | {x for s in inside for x in s[2:] if a < x < b})
        for c0, c1 in zip(cuts, cuts[1:]):
            key = "+".join(sorted(set(innermost(inside, 0.5 * (c0 + c1)).values()))) or "no phase"
            out[key] = out.get(key, 0.0) + (c1 - c0)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def gaps(intervals: Sequence) -> List[Tuple[float, float, str]]:
    """(start, end, the operation that ended last before it) of every gap
    between device activity."""
    out = []
    end, name = None, ""
    for op, start, stop in sorted(intervals, key=lambda iv: iv[1]):
        if end is not None and start > end:
            out.append((end, start, name))
        if end is None or stop > end:
            end, name = stop, op
    return out


def gap_label(spans: Sequence[Span], start: float, end: float, after: str) -> str:
    """"host in <phase> <share>% (<n> threads), ...; after <op>": up to
    three layer phases by the share of the gap they cover, and how many
    threads ran each where more than one did; "no phase" where none is
    open. At most LABEL_CHARS characters."""
    share: Dict[str, List] = {}
    for name, tid, a, b in spans:
        if name in LAYER_PHASES and a < end and b > start:
            pairs, threads = share.setdefault(name, [[], set()])
            pairs.append((a, b))
            threads.add(tid)
    parts = []
    ranked = sorted(((cover(p, start, end) / (end - start), name, len(t)) for name, (p, t) in share.items()),
                    key=lambda r: -r[0])
    for frac, name, n in ranked[:3]:
        parts.append("%s %d%%%s" % (name, max(1, round(100.0 * frac)), " (%d threads)" % n if n > 1 else ""))
    head = "host in %s; after " % (", ".join(parts) or "no phase")
    return (head + after)[:LABEL_CHARS]


def labelled_gaps(intervals: Sequence, spans: Sequence[Span], k: int = 10) -> List[List]:
    """[label, seconds] of the k longest idle gaps of the device, each
    labelled by `gap_label`."""
    longest = sorted(gaps(intervals), key=lambda g: g[0] - g[1])[:k]
    return [[gap_label(spans, a, b, after), b - a] for a, b, after in longest]
