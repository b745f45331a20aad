"""The port's multi-host execution, two processes on one host.

Port of tests/test_multihost.py: two real OS processes join a gloo
process group over a localhost coordinator (the JAX package's
environment variables name it), take their `host_shard` of a shared case
list and run the port's pipeline on the CPU. The parent checks that the
shards are disjoint and cover every case with the expected paths, and
that a worker's death mid-batch is recovered through the result store:
a rerun recomputes only what the dead worker left.
"""

import json
import os
import socket
import subprocess
import sys

import torch

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = "1+2+3+4+5+6+|6-5-4-3-2-|2+3+4+|4-3-|3+4+|4-3-2-|2+3+4+5+6+|6-5-4-3-2-1-"
FORBIDDEN = ("jax", "ambigram_tpu", "__graft_entry__")

PRELUDE = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from ambigram_tpu_torch.parallel.distributed import host_shard, initialize, process_count, process_index
initialize()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in %r)
cases = sys.argv[1].split(",")
mine = host_shard(cases)
""" % (FORBIDDEN,)

WORKER = PRELUDE + r"""
from ambigram_tpu_torch.engine.pipeline import run_bfb
out = {}
for path in mine:
    out[path] = run_bfb(path, solver="exact", device="cpu").path_strings
print("RESULT " + json.dumps({"pid": process_index(), "n": process_count(), "out": out, "loaded": loaded}))
"""

WORKER_CRASH = PRELUDE + r"""
store = sys.argv[2]
from ambigram_tpu_torch.engine.pipeline import run_bfb_many
if process_index() == 1:
    # complete exactly one of this worker's cases, then die mid-batch
    run_bfb_many(mine[:1], solver="exact", device="cpu", result_store=store)
    print("RESULT " + json.dumps({"pid": 1, "done": mine[:1]}), flush=True)
    os._exit(17)
run_bfb_many(mine, solver="exact", device="cpu", result_store=store)
print("RESULT " + json.dumps({"pid": 0, "done": mine}), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(code, args):
    env = dict(os.environ)
    env["JAX_COORDINATOR_ADDRESS"] = "localhost:%d" % _free_port()
    env["JAX_NUM_PROCESSES"] = "2"
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for pid in range(2):
        penv = dict(env, JAX_PROCESS_ID=str(pid))
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", code, *args], env=penv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
        )
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        outs.append((p.returncode, stdout, stderr))
    return outs


def _results(stdout):
    return [json.loads(line[len("RESULT ") :]) for line in stdout.splitlines() if line.startswith("RESULT ")]


def _cases(tmp_path, seeds, prefix):
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

    cases, truths = [], {}
    for seed in seeds:
        c = simulate_bfb_case(seed=seed, n_segments=6)
        p = write_case(c, str(tmp_path / ("%s%d" % (prefix, seed))))["lh"]
        cases.append(p)
        truths[p] = c.truth_string
    return cases, truths


def test_two_process_host_sharding(tmp_path):
    cases, truths = _cases(tmp_path, (1, 2, 3), "m")
    cases = [os.path.join(DATA, "egfr6.lh")] + cases
    outs = {}
    for rc, stdout, stderr in _launch(WORKER, [",".join(cases)]):
        assert rc == 0, stderr[-2000:]
        for data in _results(stdout):
            outs[data["pid"]] = data
    # both processes reported, in a group of two, with disjoint shards
    # that cover every case; neither loaded jax or the JAX package
    assert set(outs) == {0, 1} and {d["n"] for d in outs.values()} == {2}
    assert set(outs[0]["out"]) | set(outs[1]["out"]) == set(cases)
    assert not (set(outs[0]["out"]) & set(outs[1]["out"]))
    assert sorted(outs[0]["out"]) == sorted(cases[0::2])  # round robin: rank 0 takes 0, 2, ...
    assert outs[0]["loaded"] == outs[1]["loaded"] == []
    merged = {**outs[0]["out"], **outs[1]["out"]}
    assert merged[cases[0]][0] == GOLDEN
    for path, truth in truths.items():
        assert merged[path][0] == truth


def test_worker_death_recovery_via_result_store(tmp_path):
    """A worker dies mid-batch; a rerun over the shared result store
    completes the list: finished cases are served from the store (their
    files untouched), only the dead worker's remainder is recomputed."""
    from ambigram_tpu_torch.engine.pipeline import run_bfb_many

    store = str(tmp_path / "store")
    cases, truths = _cases(tmp_path, (1, 2, 3, 4), "k")
    outs = _launch(WORKER_CRASH, [",".join(cases), store])
    assert outs[1][0] == 17  # the simulated death
    assert outs[0][0] == 0, outs[0][2][-2000:]
    assert _results(outs[0][1])[0]["done"] == cases[0::2]
    done_before = {f: os.path.getmtime(os.path.join(store, f)) for f in os.listdir(store)}
    assert len(done_before) == 3  # rank 0's two cases and rank 1's first

    results = run_bfb_many(cases, solver="exact", device="cpu", result_store=store)
    for path, res in zip(cases, results):
        assert res.path_strings[0] == truths[path]
    for f, mtime in done_before.items():
        assert os.path.getmtime(os.path.join(store, f)) == mtime
    assert len(os.listdir(store)) == len(cases)
