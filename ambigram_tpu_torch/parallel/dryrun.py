"""Multi-device dry run of the port: the sharded search step and the
batch pipeline under an n-device mesh, checked against a single-device
solve.

Port of `dryrun_multichip` (the repo's __graft_entry__.py):

    python -m ambigram_tpu_torch.parallel.dryrun 4            # on the card
    python -m ambigram_tpu_torch.parallel.dryrun 4 --device cpu

Where the JAX dry run always targets a virtual CPU mesh, this one runs on
`device`: with `cuda` it takes n distinct cards when that many are
visible, else a logical mesh of n shards on the first card; with `cpu`
a mesh of the labels cpu:0 .. cpu:n-1.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import torch


def mesh_devices(n_devices: int, device: str = "cuda"):
    """The n devices of the dry run's mesh on `device`'s kind: distinct
    cards where there are enough, else n shards of the first card; CPU
    labels on the CPU."""
    from ambigram_tpu_torch.parallel.mesh import cpu_devices, visible_devices

    if torch.device(device).type == "cpu":
        return cpu_devices(n_devices)
    cards = visible_devices()
    return cards[:n_devices] if len(cards) >= n_devices else [cards[0]] * n_devices


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the sharded search over an n-device mesh: cases data-parallel
    over the "case" axis, the scoring rows split over the "model" axis
    (summed per candidate), candidate pools per case. Two program classes
    run, as in the JAX dry run:

    1. small programs through the stacked sharded step
       (`solve_cases_sharded` under the mesh);
    2. the batch pipeline (`run_bfb_many`) on a case list with one
       program of more than 2048 variables, so the per-case round-robin
       device branch and the LNS polish leg run under the mesh too;

    and the sharded small-case result is held against a single-device
    solve. Sets the search's budget knobs to tiny values, as the JAX dry
    run does: it checks that everything runs, not solution quality."""
    os.environ["AMBIGRAM_SEARCH_POP"] = "4"
    os.environ["AMBIGRAM_SEARCH_ROUNDS"] = "1"
    os.environ["AMBIGRAM_SEARCH_SWEEPS"] = "8"
    os.environ["AMBIGRAM_LNS_BUDGET"] = "5"

    from ambigram_tpu_torch.bench import _demo_program
    from ambigram_tpu_torch.engine.pipeline import extract_programs, run_bfb_many
    from ambigram_tpu_torch.parallel.mesh import make_mesh, solve_cases_sharded
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case
    from ambigram_tpu_torch.solver.search import solve_device

    devices = mesh_devices(n_devices, device)
    mesh = make_mesh(devices=devices)
    progs = [_demo_program(6), _demo_program(8)]
    best = solve_cases_sharded(progs, mesh=mesh, pop=4, steps=2)
    if len(best) != 2 or best[0].shape[0] != progs[0].num_vars:
        raise AssertionError("solve_cases_sharded returned %r" % (best,))

    td = tempfile.mkdtemp(prefix="dryrun_multichip_")
    try:
        paths = []
        for i, n_seg in enumerate((8, 46)):
            case = simulate_bfb_case(seed=i, n_segments=n_seg, mode="nested")
            paths.append(write_case(case, os.path.join(td, "d%d" % i))["lh"])
        big_prog = extract_programs(paths[1])[0]
        if big_prog.num_vars <= 2048:
            raise AssertionError("the second case must reach the round-robin branch")
        results = run_bfb_many(paths, solver="device", device=devices[0], mesh=mesh)
        if len(results) != 2 or not all(r.path_strings for r in results):
            raise AssertionError("run_bfb_many under the mesh printed no path")

        # the sharded solve of the small case equals the single-device solve
        prog_small = extract_programs(paths[0])[0]
        single = solve_device(prog_small, device=devices[0])
        if abs(results[0].ilp_error - single.objective) >= 1e-6:
            raise AssertionError(
                "sharded result (%g) != single-device solve (%g)" % (results[0].ilp_error, single.objective)
            )
    finally:
        shutil.rmtree(td, ignore_errors=True)
    print(
        "dryrun_multichip ok: mesh=%s on %s; sharded small programs + run_bfb_many round-robin/LNS leg "
        "(V=%d) executed; sharded == single-device on the small case"
        % (mesh.shape, ",".join(str(d) for d in mesh.flat()), big_prog.num_vars)
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
