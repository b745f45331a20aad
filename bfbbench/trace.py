"""Device activity from a `torch.profiler` chrome trace: the kernels and
copies as (name, start, end) intervals in seconds, their union (streams
that overlap count once), the operations that took most device time and
the longest gaps in which the device ran nothing."""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[str, float, float]


def device_intervals(trace_file: str) -> List[Interval]:
    """(name, start_s, end_s) of every kernel, copy and memset, by start."""
    with open(trace_file) as f:
        events = json.load(f).get("traceEvents", [])
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            start = float(e["ts"]) * 1e-6
            out.append((str(e.get("name", "?")), start, start + float(e.get("dur", 0.0)) * 1e-6))
    out.sort(key=lambda iv: iv[1])
    return out


def merged(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals as disjoint (start, end) spans."""
    spans: List[List[float]] = []
    for _, start, end in sorted(intervals, key=lambda iv: iv[1]):
        if spans and start <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], end)
        else:
            spans.append([start, end])
    return [(a, b) for a, b in spans]


def busy_seconds(intervals: List[Interval]) -> float:
    return sum(b - a for a, b in merged(intervals))


def top_ops(intervals: List[Interval], k: int = 10) -> List[List]:
    """[name, seconds] of the k operations with the most device time."""
    total: Dict[str, float] = {}
    for name, start, end in intervals:
        total[name] = total.get(name, 0.0) + (end - start)
    return [[name[:120], secs] for name, secs in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(intervals: List[Interval], k: int = 10) -> List[List]:
    """[label, seconds] of the k longest gaps between device activity,
    each labelled by the operation that ended last before it."""
    gaps = []
    end, name = None, ""
    for op, start, stop in sorted(intervals, key=lambda iv: iv[1]):
        if end is not None and start > end:
            gaps.append(("host, after %s" % name[:100], start - end))
        if end is None or stop > end:
            end, name = stop, op
    gaps.sort(key=lambda g: -g[1])
    return [[label, secs] for label, secs in gaps[:k]]
