"""Per-phase timing.

Copy of ambigram_tpu/utils/profiling.py, so the port's counters and
phases are its own: named phase timers with a candidates-scored counter.
The copy leaves out `device_trace`, the jax.profiler context, which has
no caller; on the card torch.profiler does that work. It adds spans: while
`record_spans(True)` is on, every phase of every thread also keeps its
start and end on the unix clock that torch.profiler's chrome traces are
exported in, so the program's phases can be laid over the device's
timeline.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple


@dataclass
class PhaseStats:
    seconds: float = 0.0
    calls: int = 0


class Span(NamedTuple):
    """One phase as one thread ran it: nanoseconds on the unix clock
    (`time.time_ns`), which a torch.profiler chrome trace exports as
    `baseTimeNanoseconds` + 1000 x `ts`."""

    name: str
    thread: int  # the OS thread id, as the trace's `tid`
    start_ns: int
    end_ns: int


class Profiler:
    """Accumulating named phase timers + counters.

    Thread-safe accumulation: the batch pipeline runs solver stages on
    thread pools, and the += updates are read-modify-write. Note that
    overlapping phases from concurrent threads legitimately sum to more
    than wall-clock (they report CPU-occupancy-style totals)."""

    def __init__(self) -> None:
        self.phases: Dict[str, PhaseStats] = {}
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()
        # (name, thread, perf_counter_ns at start, at end) while spans are
        # recorded, else None; `_origin` pairs perf_counter_ns with
        # time_ns, taken once when recording starts
        self._spans: Optional[List[Tuple[str, int, int, int]]] = None
        self._origin = (0, 0)

    def reset(self) -> None:
        with self._lock:
            self.phases.clear()
            self.counters.clear()
            if self._spans is not None:
                self._spans = []

    def record_spans(self, on: bool = True) -> None:
        """Start keeping a span for every phase that ends from now on, on
        every thread, or stop and drop those kept. Off by default."""
        with self._lock:
            if on and self._spans is None:
                self._origin = (time.perf_counter_ns(), time.time_ns())
                self._spans = []
            elif not on:
                self._spans = None

    def take_spans(self) -> List[Span]:
        """The spans kept since recording started, the last `reset` or the
        last take, by start; recording goes on."""
        with self._lock:
            raw = self._spans or []
            if self._spans is not None:
                self._spans = []
            perf0, unix0 = self._origin
        shift = unix0 - perf0
        spans = [Span(name, tid, t0 + shift, t1 + shift) for name, tid, t0, t1 in raw]
        return sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            with self._lock:
                stats = self.phases.setdefault(name, PhaseStats())
                stats.seconds += (t1 - t0) * 1e-9
                stats.calls += 1
                if self._spans is not None:
                    self._spans.append((name, threading.get_native_id(), t0, t1))

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def candidates_per_second(self) -> Optional[float]:
        scored = self.counters.get("candidates_scored", 0.0)
        secs = self.phases.get("score", PhaseStats()).seconds
        if scored and secs:
            return scored / secs
        return None

    def report(self) -> str:
        lines = []
        for name in sorted(self.phases):
            s = self.phases[name]
            lines.append("%-20s %8.3fs  x%d" % (name, s.seconds, s.calls))
        for name in sorted(self.counters):
            lines.append("%-20s %g" % (name, self.counters[name]))
        cps = self.candidates_per_second()
        if cps:
            lines.append("%-20s %.1f/s" % ("candidates_scored", cps))
        return "\n".join(lines)


GLOBAL = Profiler()
