"""Run one cell of the benchmark once, and print its one result line.

    python3 bfbbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is a `workloads` entry of BENCHMARK.json: a configuration
(`configs/<name>.json`: the sample generator's recipe and the entry
users call) under a traffic mix (`traffic/<name>.json`: what one unit of
work is, which of the recipe's samples a cycle holds, in what order).
The run generates the cycle's samples into a fresh directory under
TMPDIR, warms the program up with one unit of them (the first listed
sample, or the manifest), then runs whole units back to back, closed
loop, through the program's own entry (`run_sc_bfb` or
`run_sc_bfb_many`, solver "auto" on the card), until the first end of a
cycle after `--seconds` have passed. The reference (`reference.py`) then judges
every answer, and each metric's reader (`metrics/<name>.py`) computes
its number: with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, the window then run under
torch.profiler. The numbers compared, each beside its limit
(`limits/<workload>.json`), close standard error and the result line.
"""

from __future__ import annotations

import time

_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import warnings  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from bfbbench import gen, reference  # noqa: E402
from bfbbench import trace as device_trace  # noqa: E402

# top-level module names no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "ambigram_tpu", "__graft_entry__")


def forbidden_modules(names) -> List[str]:
    """The forbidden top-level names among module names, compared whole
    (`ambigram_tpu_torch` is not `ambigram_tpu`)."""
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict


def load_cell(workload: str) -> Tuple[dict, Cell]:
    """BENCHMARK.json and the cell `workload`, its files found by name."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit("no workload %r in BENCHMARK.json" % workload)
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return bench, Cell(
        name=workload,
        chips=int(w["chips"]),
        config=load_json(os.path.join(ROOT, configs[w["config"]]["file"])),
        traffic=load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=load_json(os.path.join(HERE, "limits", workload + ".json")),
    )


# ------------------------------------------------------------------ cases


@dataclass
class Case:
    key: str
    lh: List[str]  # one LH file a clone
    listed: int  # its place in the traffic's list


def _write(recipe: dict, case_seed: int, index: int, prefix: str) -> List[str]:
    """The sample the configuration's recipe makes from `case_seed` (its
    `index` in the traffic's list picks the clones' topology)."""
    if recipe["kind"] != "sc":
        raise ValueError("unknown generator kind %r" % recipe["kind"])
    topologies = recipe["topologies"]
    sc = gen.simulate_sc_case(
        seed=case_seed,
        n_clones=recipe["n_clones"],
        n_segments=recipe["n_segments"],
        coverage=recipe["coverage"],
        noise=recipe["noise"],
        topology=topologies[index % len(topologies)],
    )
    return gen.write_sc_clones(sc, prefix + "_c")


def make_cases(cell: Cell, seed: int, workdir: str) -> List[Case]:
    """The cycle's cases, in the order the window runs them: the
    traffic's listed `cases` (the recipe's own seeds), so that every
    seed offers the same work, in an order drawn from `seed` where the
    traffic's `order` is "seed", in the listed order where it is
    "listed"."""
    recipe, traffic = cell.config["generator"], cell.traffic
    n = int(traffic["cycle"])
    listed = traffic["cases"]
    if len(listed) != n:
        raise ValueError("traffic lists %d cases for a cycle of %d" % (len(listed), n))
    order = range(n)
    if traffic["order"] == "seed":
        order = [int(j) for j in np.random.default_rng([seed, 0]).permutation(n)]
    return [
        Case("c%d" % i, _write(recipe, int(listed[j]), j, os.path.join(workdir, "c%d" % i)), j)
        for i, j in enumerate(order)
    ]


def first_unit(cell: Cell, cycle: List[Case]) -> List[Case]:
    """The unit the warm-up runs: the manifest, or the first listed case,
    whatever the seed's order."""
    if cell.traffic["unit"] == "manifest":
        return cycle
    return [min(cycle, key=lambda c: c.listed)]


# ---------------------------------------------------------------- entries


@dataclass
class Answer:
    """What the program returned for one sample: the element counts x of
    every clone, the epsilon it reports and one path a clone. x is None
    where it returned no solution."""

    x: Optional[np.ndarray]
    eps: float = float("nan")
    paths: Tuple[str, ...] = ()


class SolutionRecorder:
    """The single-cell entries return paths only. To judge the epsilon
    of their answers, this keeps what `pipeline._solve` and
    `pipeline.solve_programs_batch` return to them, passing every call
    and result through untouched."""

    def __init__(self):
        from ambigram_tpu_torch.engine import pipeline

        missing = [name for name in ("_solve", "solve_programs_batch") if not hasattr(pipeline, name)]
        if missing:
            raise RuntimeError(
                "the single-cell answers cannot be kept: ambigram_tpu_torch.engine.pipeline has no %s"
                % ", ".join(missing)
            )
        self._pipeline = pipeline
        self._solve = pipeline._solve
        self._batch = pipeline.solve_programs_batch
        self._lock = threading.Lock()
        self.solves: List[object] = []
        self.batches: List[Dict] = []

    def __enter__(self):
        def solve(*args, **kwargs):
            sol = self._solve(*args, **kwargs)
            with self._lock:
                self.solves.append(sol)
            return sol

        def batch(*args, **kwargs):
            sols = self._batch(*args, **kwargs)
            with self._lock:
                self.batches.append(sols)
            return sols

        self._pipeline._solve = solve
        self._pipeline.solve_programs_batch = batch
        return self

    def __exit__(self, *exc):
        self._pipeline._solve = self._solve
        self._pipeline.solve_programs_batch = self._batch

    def take(self):
        with self._lock:
            solves, batches = self.solves, self.batches
            self.solves, self.batches = [], []
        return solves, batches


def _sc_answer(res, sol) -> Answer:
    if sol is None or len(res.path_strings) == 0 or any(len(p) != 1 for p in res.path_strings):
        return Answer(None)
    return Answer(np.asarray(sol.x), float(sol.objective), tuple(p[0] for p in res.path_strings))


def make_entry(cell: Cell, device: str, recorder: Optional[SolutionRecorder]):
    """The program's entry for this cell, as users call it: a function of
    one unit's cases that returns one Answer a case."""
    op, unit = cell.config["op"], cell.traffic["unit"]
    common = dict(solver="auto", device=device, ledger_dir=None)
    if op == "sc_bfb":
        from ambigram_tpu_torch.engine.sc import run_sc_bfb, run_sc_bfb_many

        edges = cell.config["edges"]
        if unit == "case":

            def one(cases):
                recorder.take()
                res = run_sc_bfb(",".join(cases[0].lh), edges=edges, **common)
                solves, _ = recorder.take()
                if len(solves) != 1:
                    raise RuntimeError("run_sc_bfb made %d calls of pipeline._solve, not 1" % len(solves))
                return [_sc_answer(res, solves[0])]

            return one

        def many(cases):
            recorder.take()
            results = run_sc_bfb_many([{"lh_paths": ",".join(c.lh), "edges": edges} for c in cases], **common)
            _, batches = recorder.take()
            if len(batches) != 1:
                raise RuntimeError("run_sc_bfb_many made %d calls of solve_programs_batch, not 1" % len(batches))
            sols = batches[0]
            return [_sc_answer(r, sols.get((i, 0))) for i, r in enumerate(results)]

        return many
    raise ValueError("unknown op %r" % op)


# ----------------------------------------------------------------- window


@dataclass
class Window:
    seconds: float
    units: int
    answers: List[Tuple[Case, Answer]]
    phases: Dict[str, float]
    counters: Dict[str, float]


def run_window(cell: Cell, entry, cycle: List[Case], seconds: float, synchronize) -> Window:
    """Whole units back to back from now, the cycle's cases in turn; no
    unit starts after `seconds` once the cycle is whole, so the window
    always holds whole cycles, the same work whatever the order. The
    program's phases and counters are reset at the start, so they cover
    the window alone."""
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    per_unit = len(cycle) if cell.traffic["unit"] == "manifest" else 1
    units_a_cycle = len(cycle) // per_unit
    GLOBAL.reset()
    t0 = time.perf_counter()
    units, answers = 0, []
    while units == 0 or units % units_a_cycle or time.perf_counter() - t0 < seconds:
        k = (units % units_a_cycle) * per_unit
        cases = cycle[k : k + per_unit]
        got = list(entry(cases))[: len(cases)]
        got += [Answer(None)] * (len(cases) - len(got))
        answers += list(zip(cases, got))
        units += 1
    synchronize()
    wall = time.perf_counter() - t0
    phases = {name: s.seconds for name, s in GLOBAL.phases.items()}
    return Window(wall, units, answers, phases, dict(GLOBAL.counters))


# -------------------------------------------------------------- judgement


def judge(window: Window, limits: dict) -> Tuple[List[Optional[reference.Verdict]], Dict[str, float], int]:
    """Judge every answer of the window with the reference; returns the
    verdicts (None for a missing answer), the numbers compared, and how
    many answers fail one of their limits."""
    programs: Dict[str, Tuple[reference.Program, float]] = {}
    verdicts: List[Optional[reference.Verdict]] = []
    for case, ans in window.answers:
        if case.key not in programs:
            texts = []
            for fn in case.lh:
                with open(fn) as f:
                    texts.append(f.read())
            prog = reference.Program([reference.parse_lh(t) for t in texts])
            programs[case.key] = (prog, prog.lp_bound())
        prog, lp = programs[case.key]
        if ans.x is None:
            verdicts.append(None)
            continue
        # the program reports its epsilon after the bias
        verdicts.append(reference.judge(prog, lp, ans.x, ans.eps + prog.bias, None, ans.paths))
    found = [v for v in verdicts if v is not None]

    def worst(attr):
        return max((getattr(v, attr) for v in found), default=0.0)

    numbers = {
        "missing": float(len(verdicts) - len(found)),
        "hard_violation": worst("violation"),
        "cn_mismatch": worst("cn_mismatch"),
        "path_faults": float(sum(v.path_faults for v in found)),
        "eps_gap": worst("eps_gap"),
    }
    failed = len(verdicts) - len(found)
    for v in found:
        own = {
            "hard_violation": v.violation,
            "cn_mismatch": v.cn_mismatch,
            "path_faults": v.path_faults,
            "eps_gap": v.eps_gap,
        }
        failed += any(own[k] > limits[k] for k in own)
    return verdicts, numbers, failed


# ----------------------------------------------------------------- metrics


def load_reader(name: str):
    """The reader of metric `name`: `metrics/<name>.py`, whose
    `read(ctx)` gives the number or None where it finds nothing."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bfbbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics this cell reports: its end-to-end ones untraced, its
    per-layer ones traced."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [
        m
        for m in bench["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.splitlines()[0] if out else "nvidia-smi reported no GPU"


def run_cell(
    workload: str,
    seed: int,
    seconds: float,
    traced: bool,
    device: str = "cuda",
    cell: Optional[Cell] = None,
    log=sys.stderr,
) -> dict:
    """One run of a cell; returns the result line's object. `device`
    other than "cuda" skips the look for a card, and `cell` replaces the
    cell's files (the CPU tests)."""
    bench, loaded = load_cell(workload)
    cell = cell or loaded
    import torch

    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        raise SystemExit("the cell needs %d CUDA device(s); this host has %d"
                         % (cell.chips, torch.cuda.device_count() if torch.cuda.is_available() else 0))
    synchronize = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        print("card: %s" % card_line(), file=log)

    workdir = tempfile.mkdtemp(prefix="bfbbench_")
    try:
        cycle = make_cases(cell, seed, workdir)
        recorder = SolutionRecorder()
        with recorder:
            entry = make_entry(cell, device, recorder)
            entry(first_unit(cell, cycle))
            synchronize()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            prof = None
            if traced:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
                prof = profile(activities=activities, acc_events=True)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    prof.__enter__()
            setup_s = time.perf_counter() - _PROCESS_START
            window = run_window(cell, entry, cycle, seconds, synchronize)
            intervals = None
            if prof is not None:
                prof.__exit__(None, None, None)
                trace_file = os.path.join(workdir, "trace.json")
                prof.export_chrome_trace(trace_file)
                intervals = device_trace.device_intervals(trace_file)
                del prof
        peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
        if on_card:
            torch.cuda.empty_cache()
        verdicts, numbers, failed = judge(window, cell.limits)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    ctx = SimpleNamespace(
        setup_s=setup_s,
        window_s=window.seconds,
        cases=len(window.answers),
        verdicts=verdicts,
        phases=window.phases,
        counters=window.counters,
        intervals=intervals,
    )
    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {
        "platform": "gpu" if on_card else device,
        "kind": torch.cuda.get_device_name(0) if on_card else device,
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    result = {
        "correct": bool(window.answers) and all(numbers[k] <= cell.limits[k] for k in numbers),
        "attempted": len(window.answers),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if traced:
        dev["busy_s"] = device_trace.busy_seconds(intervals or [])
        dev["window_s"] = window.seconds
        result["breakdown"] = {
            "device_ops": device_trace.top_ops(intervals or []),
            "idle_gaps": device_trace.idle_gaps(intervals or []),
        }
    result["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in numbers}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules(sys.modules)
    if found:
        print("forbidden modules loaded: %s" % ", ".join(found), file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print("check %s %r limit %r" % (name, check["value"], check["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
