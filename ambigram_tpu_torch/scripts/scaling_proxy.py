"""Weak-scaling proxy: orchestration overhead vs mesh size.

Port of ambigram_tpu/scripts/scaling_proxy.py. It runs the SAME stacked
case-sharded pass (parallel.mesh.solve_cases_sharded, the batch
pipeline's mid-size device stage) over logical meshes of 1/2/4/8 shards
of ONE device, so the work and the hardware stay constant: the ideal
result is a flat wall time, and any slowdown against the 1-shard run is
the cost of splitting the cases and rows over the mesh (more launches,
more copies, the per-shard sums), the only part of multi-device scaling
one card can show.

Run as a subprocess per mesh size, as the bench's proxy leg does:

    python -m ambigram_tpu_torch.scripts.scaling_proxy \\
        --cases <dir-with-lh-files> --mesh 4 [--device cuda]

Prints one JSON line: {"mesh": N, "seconds": t, "eps_sum": e,
"solved": k, ...}.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def run_proxy(case_dir: str, mesh_size: int, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from ambigram_tpu_torch.engine.pipeline import extract_programs
    from ambigram_tpu_torch.parallel.mesh import make_mesh, solve_cases_sharded
    from ambigram_tpu_torch.solver.search import resolve_device

    dev = resolve_device(device)
    lh_paths = sorted(glob.glob(os.path.join(case_dir, "*.lh")))
    progs = []
    for p in lh_paths:
        progs += [pr for pr in extract_programs(p) if pr is not None]
    mesh = make_mesh(devices=[dev] * mesh_size)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the warm-up runs the IDENTICAL call, so the measured run pays no
    # first-use cost (the kernel build, the allocator's first requests)
    t0 = time.perf_counter()
    solve_cases_sharded(progs, mesh=mesh)
    sync()
    compile_plus_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    best = solve_cases_sharded(progs, mesh=mesh)
    sync()
    seconds = time.perf_counter() - t0
    eps = 0.0
    solved = 0
    for prog, x in zip(progs, best):
        if float(prog.hard_violation(x.astype(np.float64))) == 0.0:
            eps += float(prog.residual_objective(x.astype(np.float64)))
            solved += 1
    return {
        "mesh": mesh_size,
        "seconds": round(seconds, 2),
        "compile_plus_first_run_seconds": round(compile_plus_first, 2),
        "eps_sum": round(eps, 2),
        "solved": solved,
        "n_programs": len(progs),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", required=True)
    ap.add_argument("--mesh", type=int, required=True)
    ap.add_argument("--device", default="cuda", help="the one device every shard of the mesh sits on")
    args = ap.parse_args(argv)
    print(json.dumps(run_proxy(args.cases, args.mesh, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
