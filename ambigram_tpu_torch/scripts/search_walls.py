"""Walls of the device search's main paths on one card.

    python -m ambigram_tpu_torch.scripts.search_walls [--legs slice,manifest,batch16] [--label NAME]

Each leg goes through the entry points a user calls, on cuda:

- slice: the S=48 seed-0 case of the repo's 4xS48 suite (noise 0.05)
  through `python -m ambigram_tpu_torch.cli --op bfb --solver auto`;
- manifest: the first four cases of the bench's batch recipe (seeds
  200-203, S=32/48) through `--op bfb --manifest --solver device`;
- batch16: the bench's 16-case batch leg (`bench.batch_device_leg`).

It prints one JSON line per leg: the wall, the `score` phase (the device
search; summed over threads where groups search at once), the other
phases, the sweep counts and the eps, beside the card's name and power
limit.

It uses only functions that every tree of the port since its batch path
has (the CLI's `run`, `bench.batch_case_paths`, `bench.batch_device_leg`,
`bench.card_line`), so this file copied into an older checkout's
`ambigram_tpu_torch/scripts/` measures that tree: run both trees in one
call, in turns, to compare them.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

LEGS = ("slice", "manifest", "batch16")
SUITE = dict(n_segments=48, rounds=5, coverage=30.0, mode="process")


def _phases() -> dict:
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    return {
        "phases": {k: round(v.seconds, 3) for k, v in sorted(GLOBAL.phases.items())},
        "counters": {k: v for k, v in sorted(GLOBAL.counters.items()) if k.startswith(("search.", "solve."))},
    }


def _run_cli(argv) -> tuple:
    import torch

    from ambigram_tpu_torch import cli
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    GLOBAL.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = cli.run(argv)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def leg_slice(workdir: str) -> dict:
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

    lh = write_case(simulate_bfb_case(seed=0, noise=0.05, **SUITE), os.path.join(workdir, "s48"))["lh"]
    res, wall = _run_cli(["--op", "bfb", "--in_lh", lh, "--solver", "auto", "--device", "cuda", "--no-ledgers"])
    return dict(wall_s=round(wall, 3), eps=res.ilp_error, **_phases())


def leg_manifest(workdir: str) -> dict:
    from ambigram_tpu_torch import bench

    paths = bench.batch_case_paths(workdir, n_cases=4)
    manifest = os.path.join(workdir, "batch.manifest")
    with open(manifest, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    results, wall = _run_cli(
        ["--op", "bfb", "--manifest", "--in_lh", manifest, "--solver", "device", "--device", "cuda", "--no-ledgers"]
    )
    return dict(wall_s=round(wall, 3), eps=[r.ilp_error for r in results],
                max_hard_violation=max(bench.case_violations(paths, results), default=0.0), **_phases())


def leg_batch16(workdir: str) -> dict:
    from ambigram_tpu_torch import bench

    return bench.batch_device_leg(bench.batch_case_paths(workdir, n_cases=16))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", default="slice,manifest", help="comma-separated, of %s" % ",".join(LEGS))
    ap.add_argument("--label", default="", help="a name for this tree in the output lines")
    args = ap.parse_args(argv)
    legs = [leg for leg in args.legs.split(",") if leg]
    if any(leg not in LEGS for leg in legs):
        ap.error("unknown leg in %r (legs: %s)" % (args.legs, ", ".join(LEGS)))
    if not torch.cuda.is_available():
        print("search_walls: no CUDA device available", file=sys.stderr)
        return 1
    from ambigram_tpu_torch.bench import card_line

    card = card_line()
    fns = {"slice": leg_slice, "manifest": leg_manifest, "batch16": leg_batch16}
    for leg in legs:
        workdir = tempfile.mkdtemp(prefix="search_walls_")
        try:
            out = fns[leg](workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"leg": leg, "label": args.label, "card": card, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
