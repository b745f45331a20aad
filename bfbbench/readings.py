"""The readings that the limits on `correct` are set from, many seeds in
one process (one CUDA context, one warm-up):

    python3 bfbbench/readings.py --workload <name> --seeds 11,12,13 --seconds 20 [--control lns_off]

For each seed it generates that seed's cases, runs a window of
`--seconds` through the cell's entry exactly as `run.py` does, judges
every answer with the reference, and prints one JSON line: the numbers
compared, the window's rate and epsilon ratio, and each case's wall,
epsilon and LP bound. `--control` reads a control instead (see
CONTROLS), which a run of the benchmark never does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from bfbbench import run  # noqa: E402

# the controls: `eps_f32` puts the reference in the program's place for
# the epsilon, computed in float32, the precision below the
# configuration's float64; `chain_edges` runs a sample with the
# program's own `edges` option coupling a chain of clones instead of
# every pair; `lns_off` switches the program's LNS tail off through its
# own setting
CONTROLS = ("eps_f32", "chain_edges", "lns_off")


def f32_reports(window, cell):
    """The window with each answer's reported epsilon replaced by the
    reference's float32 epsilon of its x, less the bias, each case read
    as the cell's generator kind reads it."""
    kind = run.cell_kind(cell)
    programs = {}
    answers = []
    for case, ans in window.answers:
        if ans.x is not None:
            if case.key not in programs:
                programs[case.key] = run.case_program(kind, case)[0]
            prog = programs[case.key]
            ans = dataclasses.replace(ans, eps=prog.eps32(ans.x) - prog.bias)
        answers.append((case, ans))
    return dataclasses.replace(window, answers=answers)


def readings(workload: str, seeds, seconds: float, control: str = "", device: str = "cuda", cell=None, out=sys.stdout):
    _, loaded = run.load_cell(workload)
    cell = cell or loaded
    if control == "chain_edges":
        k = cell.config["generator"]["n_clones"]
        chain = ",".join("%d:%d" % (i, i + 1) for i in range(1, k))
        cell = dataclasses.replace(cell, config=dict(cell.config, edges=chain))
    import torch

    on_card = device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    recorder = run.SolutionRecorder()
    lines = []
    with recorder:
        entry = run.make_entry(cell, device, recorder)
        walls = []

        def timed(cases):
            t0 = time.perf_counter()
            answers = entry(cases)
            walls.append(time.perf_counter() - t0)
            return answers

        for k, seed in enumerate(seeds):
            workdir = tempfile.mkdtemp(prefix="bfbbench_readings_")
            try:
                cycle = run.make_cases(cell, seed, workdir)
                if k == 0:
                    entry(run.first_unit(cell, cycle))
                    sync()
                    if control == "lns_off":
                        os.environ["AMBIGRAM_LNS_BUDGET"] = "0"
                walls.clear()
                window = run.run_window(cell, timed, cycle, seconds, sync)
                if control == "eps_f32":
                    window = f32_reports(window, cell)
                verdicts, numbers, failed = run.judge(window, cell)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            found = [v for v in verdicts if v is not None]
            line = {
                "workload": workload,
                "seed": seed,
                "control": control,
                "numbers": numbers,
                "failed": failed,
                "cases": len(window.answers),
                "window_s": window.seconds,
                "cases_per_min": 60.0 * len(window.answers) / window.seconds,
                "lp_excess": max((v.lp_ratio - 1.0 for v in found), default=None),
                "eps_lp_ratio": sum(v.lp_ratio for v in found) / len(found) if found else None,
                "unit_walls": walls[:],
                "per_case": [
                    [c.key, v.eps if v else None, v.lp_ratio if v else None] for (c, _), v in zip(window.answers, verdicts)
                ],
                "phases": window.phases,
            }
            if out is not None:
                print(json.dumps(line), file=out, flush=True)
            lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", choices=CONTROLS, default="")
    args = ap.parse_args(argv)
    readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds, args.control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
