"""Windows of a cell with the program's phase spans recorded, many seeds in
one process (one CUDA context, one warm-up):

    python3 bfbbench/spanrun.py --workload <name> --seeds 11,12,13 --seconds 51 --trace 1 [--spans 1] [--keep DIR]

Each window runs as `run.py` runs it, with `GLOBAL.record_spans(True)`
where `--spans` says so. `--spans 0,1` runs each seed twice, without and
with spans, in turns (the order flips from seed to seed), to read what
recording costs. Under `--trace 1` the window also runs under the
profiler with run.py's settings, and its JSON line adds to the cell's
per-layer metrics the ones the spans give (`spans.py`): the share of the
window idle and in no layer phase, the LNS tail's wall share, the idle
time in no layer phase by the phases open then, the number of threads
that ran the tail, and the device's longest idle gaps labelled by the
host work under them. `--keep DIR` writes each traced window's spans and
device intervals there (gzipped JSON).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import tempfile
import time
import warnings
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from bfbbench import run, spans  # noqa: E402
from bfbbench import trace as device_trace  # noqa: E402


def window_line(cell, entry, cycle, seconds, sync, on_card, traced, with_spans, keep, tag) -> dict:
    """One window as run.py runs it, spans recorded where `with_spans`,
    under the profiler where `traced`: its rate, whether every answer is
    correct, and, traced, the numbers of `traced_numbers`."""
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    prof = None
    workdir = tempfile.mkdtemp(prefix="bfbbench_spanrun_")
    try:
        if traced:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=activities, acc_events=True)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                prof.__enter__()
        GLOBAL.record_spans(with_spans)
        lo = time.time_ns()
        window = run.run_window(cell, entry, cycle, seconds, sync)
        hi = time.time_ns()
        kept = GLOBAL.take_spans()
        GLOBAL.record_spans(False)
        if prof is not None:
            prof.__exit__(None, None, None)
            trace_file = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(trace_file)
            del prof
            with open(trace_file) as f:
                base = int(json.load(f)["baseTimeNanoseconds"])
            intervals = device_trace.device_intervals(trace_file)
            laid = spans.on_trace_clock(kept, base)
            bounds = ((lo - base) * 1e-9, (hi - base) * 1e-9)
            if keep:
                os.makedirs(keep, exist_ok=True)
                with gzip.open(os.path.join(keep, tag + ".json.gz"), "wt") as f:
                    json.dump({"window": bounds, "spans": laid, "intervals": intervals}, f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _, numbers, failed = run.judge(window, cell.limits)
    line = {
        "spans": int(with_spans),
        "trace": int(traced),
        "correct": bool(window.answers) and all(numbers[k] <= cell.limits[k] for k in numbers),
        "failed": failed,
        "cases": len(window.answers),
        "window_s": window.seconds,
        "cases_per_min": 60.0 * len(window.answers) / window.seconds,
    }
    if traced:
        line.update(traced_numbers(cell, window, intervals, laid, bounds))
    return line


def traced_numbers(cell, window, intervals, laid, bounds) -> dict:
    """The cell's per-layer metrics as run.py reads them, the metrics the
    spans give, and what the spans say of the idle time."""
    bench, _ = run.load_cell(cell.name)
    ctx = SimpleNamespace(cases=len(window.answers), window_s=window.seconds, phases=window.phases,
                          counters=window.counters, intervals=intervals, verdicts=[])
    metrics = {}
    for m in run.cell_metrics(bench, cell.name, True):
        value = run.load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = value
    metrics["unlayered_idle_pct"] = spans.unlayered_idle_pct(laid, intervals, bounds)
    metrics["lns_wall_pct"] = spans.lns_wall_pct(laid, bounds)
    return {
        "metrics": metrics,
        "spans_kept": len(laid),
        "lns_threads": len({tid for name, tid, _, _ in laid if name == spans.LNS_PHASE}),
        "unlayered_idle_by_phase_s": spans.unlayered_by_phase(laid, intervals, bounds),
        "idle_gaps": spans.labelled_gaps(intervals, laid),
        "phases_s": dict(sorted(window.phases.items())),
        "counters": {k: v for k, v in sorted(window.counters.items()) if k.startswith(("lns.", "solve."))},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", default="1", help="0, 1 or 0,1 (each seed without and with spans, in turns)")
    ap.add_argument("--keep", default="", help="a directory for each traced window's spans and intervals")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    modes = [bool(int(v)) for v in args.spans.split(",")]
    _, cell = run.load_cell(args.workload)
    import torch

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        print("card: %s" % run.card_line(), file=sys.stderr)
    recorder = run.SolutionRecorder()
    with recorder:
        entry = run.make_entry(cell, args.device, recorder)
        for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
            workdir = tempfile.mkdtemp(prefix="bfbbench_spanrun_cases_")
            try:
                cycle = run.make_cases(cell, seed, workdir)
                if k == 0:
                    entry(run.first_unit(cell, cycle))
                    sync()
                for with_spans in modes if k % 2 == 0 else modes[::-1]:
                    tag = "%s_%d_spans%d" % (args.workload, seed, with_spans)
                    line = window_line(cell, entry, cycle, args.seconds, sync, on_card, bool(args.trace),
                                       with_spans, args.keep, tag)
                    print(json.dumps(dict(workload=args.workload, seed=seed, **line)), flush=True)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
