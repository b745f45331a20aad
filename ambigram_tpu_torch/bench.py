"""Benchmark of the PyTorch/CUDA port: candidate BFB structures scored per
second on one NVIDIA GPU.

    python -m ambigram_tpu_torch.bench

Prints ONE JSON line on stdout, in the schema of the JAX package's
bench.py:

  {"metric": ..., "value": N, "unit": "candidates/s", "vs_baseline": N,
   "kernel_path": "cuda-fused-int8", "int8": {...}, "device": ...}

The workload is the JAX bench's: batched scoring of integer candidates
against the S=32 demo program (1056 variables; H8 3840 x 1152 int8),
chained over 200 data-dependent rounds by K2 (csrc/chained_score.cu), on
262,144 candidates, best of 3 after a warm-up, timed with
`torch.cuda.synchronize` around each run. vs_baseline is against the
single-core C++ scorer native/score_baseline.cpp on the unpadded
program.

AMBIGRAM_BENCH_SUITE picks the secondary legs, which go to stderr:
"1" (default) the 4xS48 suite (device, auto and exact modes), the
16-case batch (`run_bfb_many` against a serial exact loop) and the
scaling proxy (`scaling_proxy_overhead`: the stacked case-sharded pass
over logical meshes of 1/2/4/8 shards of one card); "0" none; "kernel"
the K2 layout sweep; "sc" the single-cell batch (`run_sc_bfb_many`
against a serial per-sample loop); "big" one noisy case each at S=64 and
S=96 through the device search against the 60 s host MILP
(`large_s_device_vs_exact`); "mesh" the batch device leg on one card
against a mesh of every visible card, and 1, 2 and 4 threads of
round-robin per-case searches over the cards (`multi_gpu_batch`). Any
other value exits with code 2. A leg that fails makes the bench exit 1.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# H100 SXM dense int8 tensor-core peak (NVIDIA H100 data sheet, without
# sparsity): the roofline the int8 block is stated against
PEAK_INT8_TOPS = 1979.0
SUITE_MODES = ("0", "1", "kernel", "sc", "big", "mesh")
BIG_SEGMENTS = (64, 96)
PROXY_MESH_SIZES = (1, 2, 4, 8)
# a subprocess of the proxy leg may take this long (its S=16 passes take
# seconds); the leg fails past it instead of running on
PROXY_TIMEOUT_S = 600


def _demo_program(n_segments: int = 24):
    """A representative mid-size fitting program built from a synthetic
    BFB copy-number profile (no file I/O). A copy of `_demo_program` in
    the repo's __graft_entry__.py, which builds the JAX bench's
    workload."""
    from ambigram_tpu_torch.engine.enumerate import enumerate_pairs
    from ambigram_tpu_torch.engine.ilp import build_bfb_program

    start, end = 1, n_segments
    pairs = enumerate_pairs(start, end)
    T = len(pairs)
    rng = np.random.default_rng(7)
    x = np.zeros(2 * T)
    for _ in range(5):
        t = int(rng.integers(0, T))
        x[T + t] += int(rng.integers(1, 3))
    seg_cn = np.zeros(n_segments)
    fbi_cn = np.zeros(n_segments)
    for t in range(T):
        i, j = pairs[t]
        if x[T + t] > 0:
            seg_cn[i - 1 : j] += 2 * x[T + t]
            fbi_cn[i - 1] += x[T + t]
            fbi_cn[j - 1] += x[T + t]
    return build_bfb_program(start, end, seg_cn, fbi_cn, max(seg_cn.sum(), 1.0), 1)


def build_workload(batch: int = 262144, device="cpu"):
    """(prog, scoring tensors on `device`, candidates X [batch, Vp] as a
    host array): the JAX bench's workload (the S=32 demo program), from
    the same seeds."""
    from ambigram_tpu_torch.solver.score import scoring_tensors

    prog = _demo_program(32)
    # cap the loop box at int8 range, which qualifies the program for the
    # exact int8 path
    prog.x_ub = np.minimum(prog.x_ub, 127)
    st = scoring_tensors(prog, device)
    rng = np.random.default_rng(0)
    Vp = st.H.shape[1]
    X = np.zeros((batch, Vp), dtype=np.float32)
    X[:, : prog.num_vars] = rng.integers(0, 3, size=(batch, prog.num_vars))
    return prog, st, X


def card_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (the first card's line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out.splitlines()[0]


def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the port's bench measures an NVIDIA GPU and none is available")


def bench_device(st, X, iters: int = 200, block_b: int = 128):
    """Candidates per second of K2's chain on the card: (cand/s,
    checksum, kernel_path). `st` must be on the card; X is moved there
    once, outside the timed region."""
    import torch

    from ambigram_tpu_torch.solver.score import chained_score

    _require_cuda()
    Xd = torch.as_tensor(X).to(st.H8.device)
    B = Xd.shape[0]
    checksum = float(chained_score(st, Xd, iters, block_b=block_b))  # warm-up, kernel build
    # best of 3: the workload is fixed and deterministic, so the spread is
    # system noise and the fastest run is what the kernel sustains
    secs = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checksum = float(chained_score(st, Xd, iters, block_b=block_b))
        torch.cuda.synchronize()
        secs = min(secs, time.perf_counter() - t0)
    return B * iters / secs, checksum, "cuda-fused-int8"


def bench_baseline(prog, X, iters: int = 2) -> float:
    """Compile and run the single-core C++ scorer (native/score_baseline.cpp)
    on the unpadded program with a reduced batch: candidates per second."""
    from ambigram_tpu_torch.solver.score import PENALTY

    src = os.path.join(ROOT, "native", "score_baseline.cpp")
    exe = os.path.join(tempfile.gettempdir(), "ambigram_score_baseline")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-ffast-math", "-funroll-loops", "-o", exe, src], check=True
        )
    big = np.float32(3.0e38)
    A = np.concatenate([prog.A_seg, prog.A_fbi], axis=0).astype(np.float32)
    c = np.concatenate([prog.c_seg, prog.c_fbi]).astype(np.float32)
    H = np.concatenate([A, (PENALTY * prog.G).astype(np.float32)], axis=0)
    lb = np.concatenate([c, np.maximum(PENALTY * prog.g_lb, -big).astype(np.float32)])
    ub = np.concatenate([c, np.minimum(PENALTY * prog.g_ub, big).astype(np.float32)])
    V = prog.num_vars
    B = min(X.shape[0], 256)
    Xb = np.ascontiguousarray(X[:B, :V], dtype=np.float32)
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        f.write(struct.pack("<4i", H.shape[0], V, B, iters))
        for arr in (H, lb, ub, Xb):
            f.write(np.ascontiguousarray(arr, dtype=np.float32).tobytes())
        path = f.name
    try:
        out = subprocess.run([exe, path], check=True, capture_output=True, text=True, timeout=600).stdout.split()
        return float(out[0])
    finally:
        os.unlink(path)


def bench_kernel_sweep(st, X, iters: int = 200) -> dict:
    """K2's layout knob, candidates per CTA: {variant: cand/s}. The
    checksums of all variants must agree to rel 1e-5: each candidate's
    chain is the same, and only the f32 order of the sums over blocks
    differs."""
    from ambigram_tpu_torch.solver.score import K2_BLOCK_B

    out = {}
    checks = []
    for block_b in K2_BLOCK_B:
        cps, checksum, _ = bench_device(st, X, iters=iters, block_b=block_b)
        out["b%d" % block_b] = round(cps, 1)
        checks.append(checksum)
    if (max(checks) - min(checks)) > 1e-5 * max(abs(c) for c in checks):
        out["checksum_mismatch"] = [min(checks), max(checks)]
    return out


def suite_programs():
    """The 4xS48 suite of the JAX bench (noise 0.05, V = 2352 per case)."""
    from ambigram_tpu_torch.engine.pipeline import extract_programs
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

    progs = []
    td = tempfile.mkdtemp(prefix="ambigram_suite_bench_")
    try:
        for seed in range(4):
            case = simulate_bfb_case(seed=seed, n_segments=48, rounds=5, coverage=30.0, mode="process", noise=0.05)
            paths = write_case(case, os.path.join(td, "c%d" % seed))
            progs.append(extract_programs(paths["lh"])[0])
    finally:
        shutil.rmtree(td, ignore_errors=True)
    return progs


def bench_suite() -> dict:
    """Time to solution on the large-case suite (V > 2048 per case, the
    regime auto sends to the device): wall seconds and quality (sum of
    the feasible epsilons, cases solved) per solver mode; `exact` is the
    host MILP at 30 s per case. One warm-up device solve first, reported
    apart: it pays the CUDA context and the kernel build."""
    from ambigram_tpu_torch.solver.exact import solve_exact
    from ambigram_tpu_torch.utils.profiling import GLOBAL
    from ambigram_tpu_torch.engine.pipeline import _solve
    from ambigram_tpu_torch.solver.search import solve_device

    device = "cuda"
    progs = suite_programs()
    t0 = time.perf_counter()
    solve_device(progs[0], device=device)
    warmup_seconds = round(time.perf_counter() - t0, 1)

    def run(mode):
        GLOBAL.reset()
        t0 = time.perf_counter()
        eps, solved = 0.0, 0
        for prog in progs:
            if mode == "exact":
                r = solve_exact(prog, time_limit=30.0)
            elif mode == "device":
                r = solve_device(prog, device=device)
            else:
                r = _solve(prog, "auto", device)
            ok = r.status in ("optimal", "heuristic") and float(prog.hard_violation(r.x.astype(np.float64))) == 0.0
            if ok:
                eps += r.epsilon_sum
                solved += 1
        return {
            "seconds": round(time.perf_counter() - t0, 1),
            "eps_sum": round(eps, 2),
            "solved": solved,
            "stages": {k: round(v.seconds, 1) for k, v in sorted(GLOBAL.phases.items()) if v.seconds >= 0.05},
        }

    out = {
        "cases": "%dxS48 noise=0.05" % len(progs),
        "n_cases": len(progs),
        "warmup_seconds": warmup_seconds,
    }
    for mode in ("device", "auto", "exact"):
        out[mode] = run(mode)
    ex, au = out["exact"]["seconds"], out["auto"]["seconds"]
    out["auto_speedup_vs_exact"] = round(ex / au, 2) if au else 0.0
    return out


def batch_case_paths(workdir: str, n_cases: int = 16):
    """The JAX bench's batch cases: S=32 and S=48 alternating, noise
    0.05, seeds 200, 201, ...; returns their .lh paths."""
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

    paths = []
    for i in range(n_cases):
        case = simulate_bfb_case(
            seed=200 + i, n_segments=32 if i % 2 == 0 else 48, rounds=5, mode="process", noise=0.05
        )
        paths.append(write_case(case, os.path.join(workdir, "b%d" % i))["lh"])
    return paths


def case_violations(lh_paths, results):
    """The hard violation of every solved chromosome of every case, as
    the replayed solution leaves it."""
    from ambigram_tpu_torch.engine.pipeline import extract_programs

    out = []
    for path, r in zip(lh_paths, results):
        for prog, chrom in zip(extract_programs(path), r.chromosomes):
            if prog is not None and chrom.element_cn is not None:
                out.append(float(prog.hard_violation(np.asarray(chrom.element_cn, dtype=np.float64))))
    return out


def batch_device_leg(lh_paths, mesh=None) -> dict:
    """One timed `run_bfb_many(solver="device")` over `lh_paths` on
    `mesh` (None: the one-card route on cuda): wall, cases/min, cases
    solved, eps_sum, the worst hard violation, and the phases and
    counters (summed over threads: the host tails overlap the searches)."""
    from ambigram_tpu_torch.engine.pipeline import run_bfb_many
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    GLOBAL.reset()
    t0 = time.perf_counter()
    res = run_bfb_many(lh_paths, solver="device", device="cuda", mesh=mesh)
    secs = time.perf_counter() - t0
    return {
        "seconds": round(secs, 1),
        "cases_per_min": round(60.0 * len(lh_paths) / secs, 2),
        # a chromosome whose solution does not replay yields an empty path
        "solved": sum(1 for r in res if any(s for s in r.path_strings)),
        "eps_sum": round(sum(r.ilp_error for r in res), 2),
        "max_hard_violation": max(case_violations(lh_paths, res), default=0.0),
        "stages": {k: round(v.seconds, 1) for k, v in sorted(GLOBAL.phases.items()) if v.seconds >= 0.05},
        "counters": dict(sorted(GLOBAL.counters.items())),
    }


def bench_batch() -> dict:
    """Batch throughput: `run_bfb_many(solver="device")` over the mixed
    S=32/S=48 case list on the card, against the serial per-case loop
    of the host MILP (15 s per case) that stands in for the reference's
    one process per sample. One identical warm-up run first, reported
    apart."""
    from ambigram_tpu_torch.engine.pipeline import build_case, replay_case, run_bfb_many
    from ambigram_tpu_torch.solver.exact import solve_exact

    device, n_cases = "cuda", 16
    td = tempfile.mkdtemp(prefix="ambigram_batch_bench_")
    try:
        lh_paths = batch_case_paths(td, n_cases)
        t0 = time.perf_counter()
        run_bfb_many(lh_paths, solver="device", device=device)
        warmup_seconds = round(time.perf_counter() - t0, 1)
        batch = batch_device_leg(lh_paths)

        t0 = time.perf_counter()
        serial_ok, serial_eps = 0, 0.0
        for p in lh_paths:
            case = build_case(p)
            sols = [solve_exact(pr, time_limit=15.0) if pr is not None else None for pr in case.programs]
            r = replay_case(case, sols, io.StringIO())
            serial_ok += bool(any(s for s in r.path_strings))
            serial_eps += r.ilp_error
        serial_secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(td, ignore_errors=True)
    return {
        "cases": "%dx mixed S32/S48 noise=0.05" % n_cases,
        "warmup_seconds": warmup_seconds,
        "batch_device": batch,
        "serial_exact": {
            "seconds": round(serial_secs, 1),
            "cases_per_min": round(60.0 * n_cases / serial_secs, 2),
            "solved": serial_ok,
            "eps_sum": round(serial_eps, 2),
        },
        "batch_speedup": round(serial_secs / batch["seconds"], 2) if batch["seconds"] else 0.0,
    }


def proxy_case_dir(workdir: str, n_cases: int = 8) -> None:
    """Write the JAX bench's proxy cases (S=16, 4 rounds, process mode,
    noise 0, seeds 400, 401, ...) under `workdir`."""
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

    for i in range(n_cases):
        case = simulate_bfb_case(seed=400 + i, n_segments=16, rounds=4, mode="process", noise=0.0)
        write_case(case, os.path.join(workdir, "sp%d" % i))


def bench_scaling_proxy(mesh_sizes=PROXY_MESH_SIZES, n_cases: int = 8) -> dict:
    """The scaling proxy: wall seconds of the stacked case-sharded pass
    (`solve_cases_sharded`, budgets 8/12/2 unless AMBIGRAM_SHARD_* say
    otherwise) over logical meshes of 1/2/4/8 shards of one card, in the
    JAX leg's schema. The work and the hardware are constant across mesh
    sizes, so the delta against mesh1 is the cost of the extra shards'
    launches, copies and sums. Each mesh size runs in its own subprocess
    (`scripts/scaling_proxy.py`, a warm-up on the identical call first),
    under a time limit; a subprocess that fails or runs past it fails
    the leg."""
    _require_cuda()
    td = tempfile.mkdtemp(prefix="ambigram_scaling_proxy_")
    env = dict(os.environ)
    # small shard budgets: the proxy measures the mesh's overhead, not
    # search quality
    env.setdefault("AMBIGRAM_SHARD_POP", "8")
    env.setdefault("AMBIGRAM_SHARD_STEPS", "12")
    env.setdefault("AMBIGRAM_SHARD_ROUNDS", "2")
    legs: dict = {}
    try:
        proxy_case_dir(td, n_cases)
        for m in mesh_sizes:
            out = subprocess.run(
                [sys.executable, "-m", "ambigram_tpu_torch.scripts.scaling_proxy",
                 "--cases", td, "--mesh", str(m), "--device", "cuda"],
                env=env,
                capture_output=True,
                text=True,
                timeout=PROXY_TIMEOUT_S,
                cwd=ROOT,
            )
            line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
            if out.returncode != 0 or not line.startswith("{"):
                raise RuntimeError("scaling proxy at mesh %d exited %d: %s" % (m, out.returncode, out.stderr[-2000:]))
            legs["mesh%d" % m] = json.loads(line)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    base = legs["mesh%d" % mesh_sizes[0]]["seconds"]
    spread = []
    for m in mesh_sizes:
        leg = legs["mesh%d" % m]
        t = leg["seconds"]
        leg["cases_per_min"] = round(60.0 * n_cases / t, 2)
        leg["sharding_overhead_pct_vs_mesh1"] = round(100.0 * (t - base) / base, 1)
        spread.append(t)
    legs["max_abs_spread_pct"] = round(100.0 * (max(spread) - min(spread)) / base, 1)
    legs["interpretation"] = (
        "constant work over constant hardware: every mesh size is that many logical shards of one card (%s). "
        "These S=16 cases give 0.02-0.1 s of device work per pass, so the launches and copies that each extra "
        "shard adds dominate the wall: the delta vs mesh1 is that cost, not a multi-card scaling efficiency, "
        "which needs distinct cards; the cases are independent (no cross-case sums), so on distinct cards "
        "scaling is bounded by per-case skew and by the host thread that launches every shard"
        % legs["mesh%d" % mesh_sizes[0]]["device"]
    )
    return legs


def bench_mesh() -> dict:
    """The multi-card batch legs (AMBIGRAM_BENCH_SUITE=mesh): the 16-case
    batch's device leg on the one-card route (`mesh=None`) and on a mesh
    of every visible card (`make_mesh()`), after one warm-up pass of four
    cases on that mesh (it builds K1 and fills each card's caches); then
    the round-robin leg's work, the 4xS48 suite through `solve_device`
    on cards[k % n] from a pool of 1, 2 and 4 threads: the wall, the
    summed `score` phase and each case's eps. With one card the mesh is
    that card and the round-robin pool shares it."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ambigram_tpu_torch.engine.pipeline import run_bfb_many
    from ambigram_tpu_torch.parallel.mesh import make_mesh, visible_devices
    from ambigram_tpu_torch.solver.search import solve_device
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    _require_cuda()
    cards = visible_devices()
    mesh = make_mesh()
    out: dict = {
        "cards": [torch.cuda.get_device_name(d) for d in cards],
        "mesh": list(mesh.shape),
        "cases": "16x mixed S32/S48 noise=0.05",
    }
    td = tempfile.mkdtemp(prefix="ambigram_mesh_bench_")
    try:
        lh_paths = batch_case_paths(td, 16)
        t0 = time.perf_counter()
        run_bfb_many(lh_paths[:4], solver="device", mesh=mesh)
        out["warmup_seconds"] = round(time.perf_counter() - t0, 1)
        out["one_card"] = batch_device_leg(lh_paths)
        if len(cards) > 1:
            out["all_cards"] = batch_device_leg(lh_paths, mesh=mesh)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    progs = suite_programs()
    rr = {}
    for n_threads in (1, 2, 4):
        GLOBAL.reset()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            res = list(pool.map(lambda kp: solve_device(kp[1], device=cards[kp[0] % len(cards)]), enumerate(progs)))
        for d in cards:
            torch.cuda.synchronize(d)
        rr["threads%d" % n_threads] = {
            "seconds": round(time.perf_counter() - t0, 1),
            "score_seconds_summed": round(GLOBAL.phases["score"].seconds, 1),
            "lns_seconds_summed": round(GLOBAL.phases["solve.lns"].seconds, 1) if "solve.lns" in GLOBAL.phases else 0.0,
            "eps": [round(r.epsilon_sum, 4) for r in res],
        }
    out["round_robin_4xS48"] = rr
    return out


def sc_samples(workdir: str, n_samples: int = 6, n_clones: int = 3, n_segments: int = 24):
    """The JAX bench's single-cell samples: K clones each, seeds 700,
    701, ..., chain and star topologies alternating, the all-pairs
    evolution default; returns [{"lh_paths", "edges"}]."""
    from ambigram_tpu_torch.scripts.simulate import simulate_sc_case, write_sc_clones

    samples = []
    for s in range(n_samples):
        sc = simulate_sc_case(
            seed=700 + s, n_clones=n_clones, n_segments=n_segments, topology="chain" if s % 2 == 0 else "star"
        )
        names, _ = write_sc_clones(sc, os.path.join(workdir, "s%d_c" % s))
        samples.append({"lh_paths": ",".join(names), "edges": ""})
    return samples


def bench_sc(n_samples: int = 6, n_clones: int = 3, n_segments: int = 24) -> dict:
    """Single-cell batch throughput: `run_sc_bfb_many(solver="auto")`
    over simulated K-clone samples on the card (the block programs are
    the largest the engine builds, V = K * 2T) against the serial
    per-sample loop (one `run_sc_bfb` per sample with a 15 s exact
    budget per block program, standing in for one process per sample).
    Before the clock the CUDA context starts and K1 is built, reported
    as `compile_seconds` (the JAX leg warms its XLA compiles there)."""
    import torch

    from ambigram_tpu_torch.engine.sc import build_sc_sample, replay_sc_sample, run_sc_bfb_many
    from ambigram_tpu_torch.solver.exact import solve_exact
    from ambigram_tpu_torch.solver.score import _k1_library

    _require_cuda()
    device = "cuda"
    td = tempfile.mkdtemp(prefix="ambigram_sc_bench_")
    try:
        samples = sc_samples(td, n_samples, n_clones, n_segments)
        t0 = time.perf_counter()
        torch.zeros(1, device=device)
        _k1_library()
        compile_seconds = round(time.perf_counter() - t0, 1)

        def solved(r) -> bool:
            return bool(r.path_strings) and all(any(c) for c in r.path_strings)

        t0 = time.perf_counter()
        batch = run_sc_bfb_many(samples, solver="auto", device=device)
        batch_secs = time.perf_counter() - t0
        batch_ok = sum(1 for r in batch if solved(r))

        t0 = time.perf_counter()
        serial_ok = 0
        for s in samples:
            sample = build_sc_sample(s["lh_paths"], s["edges"])
            sols = [solve_exact(pr, time_limit=15.0) if pr is not None else None for pr in sample.programs]
            r = replay_sc_sample(sample, sols, io.StringIO())
            serial_ok += solved(r)
        serial_secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(td, ignore_errors=True)
    return {
        "cases": "%dx sc (K=%d, S=%d) chain/star" % (n_samples, n_clones, n_segments),
        "block_vars": n_clones * n_segments * (n_segments + 1),
        "compile_seconds": compile_seconds,
        "batch": {
            "seconds": round(batch_secs, 1),
            "samples_per_min": round(60.0 * n_samples / batch_secs, 2),
            "solved": batch_ok,
        },
        "serial": {
            "seconds": round(serial_secs, 1),
            "samples_per_min": round(60.0 * n_samples / serial_secs, 2),
            "solved": serial_ok,
        },
        "batch_speedup": round(serial_secs / batch_secs, 2) if batch_secs else 0.0,
    }


def big_case_path(workdir: str, n_segments: int, noise: float = 0.05) -> str:
    """The JAX bench's large-S case at S=n_segments (seed 300 + S, 6
    rounds, process mode, noise 0.05; V = 4160 at S=64, 9312 at S=96),
    written under `workdir`; returns its .lh path."""
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

    case = simulate_bfb_case(seed=300 + n_segments, n_segments=n_segments, rounds=6, mode="process", noise=noise)
    return write_case(case, os.path.join(workdir, "big%d_noise%g" % (n_segments, noise)))["lh"]


def big_programs() -> dict:
    """The big leg's programs, {S: program} for S in BIG_SEGMENTS."""
    from ambigram_tpu_torch.engine.pipeline import extract_programs

    td = tempfile.mkdtemp(prefix="ambigram_big_bench_")
    try:
        return {n_seg: extract_programs(big_case_path(td, n_seg))[0] for n_seg in BIG_SEGMENTS}
    finally:
        shutil.rmtree(td, ignore_errors=True)


def bench_big() -> dict:
    """The large-S legs: each case through `solve_device` on the card
    against `solve_exact` with a 60 s budget, in the JAX leg's schema
    (`vars`, then `seconds` and `eps` of each solver, eps rounded to two
    decimals and None unless feasible). Each leg adds the device
    search's phases (`score`, `solve.lns`, `solve.lp_bound`,
    `solve.tensors`), its sweep counts, the hard violation, K1's planes
    and launches by path, and `compile_seconds`: before the clock the
    CUDA context starts and K1 is built (the JAX leg compiles there with
    a 1-round search)."""
    import torch

    from ambigram_tpu_torch.solver.exact import solve_exact
    from ambigram_tpu_torch.solver.score import _k1_library, k1_planes, reset_launch_counts, score_rows, scoring_tensors
    from ambigram_tpu_torch.solver.search import solve_device
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    _require_cuda()
    device = "cuda"
    legs = {}
    for n_seg, prog in big_programs().items():

        def feas(r):
            vio = float(prog.hard_violation(r.x.astype(np.float64)))
            ok = r.status in ("optimal", "heuristic") and vio == 0.0
            return (round(r.epsilon_sum, 2) if ok else None), vio

        t0 = time.perf_counter()
        torch.zeros(1, device=device)
        _k1_library()
        compile_seconds = round(time.perf_counter() - t0, 1)
        GLOBAL.reset()
        reset_launch_counts()
        t0 = time.perf_counter()
        rd = solve_device(prog, device=device)
        dev_secs = time.perf_counter() - t0
        dev_eps, dev_vio = feas(rd)
        phases = {k: round(GLOBAL.phases[k].seconds, 3) for k in ("score", "solve.lns", "solve.lp_bound", "solve.tensors")
                  if k in GLOBAL.phases}
        sweeps = {k.split(".")[1]: int(GLOBAL.counters.get(k, 0)) for k in
                  ("search.delta_sweeps", "search.move_sweeps", "search.move3_sweeps")}
        launches = {"int8": score_rows.int8_launches, "f32": score_rows.f32_launches, "all": score_rows.launches}
        t0 = time.perf_counter()
        re = solve_exact(prog, time_limit=60.0)
        ex_secs = time.perf_counter() - t0
        legs["S%d" % n_seg] = {
            "vars": prog.num_vars,
            "device": {
                "seconds": round(dev_secs, 1),
                "eps": dev_eps,
                "status": rd.status,
                "hard_violation": dev_vio,
                "stages": phases,
                "sweeps": sweeps,
            },
            "exact_60s": {"seconds": round(ex_secs, 1), "eps": feas(re)[0], "status": re.status},
            "k1_planes": k1_planes(scoring_tensors(prog, "cpu", need_f32=False)),
            "k1_launches": launches,
            "compile_seconds": compile_seconds,
        }
    return legs


def _secondary(metric: str, fn) -> bool:
    """Run one secondary leg; its JSON line (or its failure) goes to
    stderr so stdout stays the single result line. Returns whether the
    leg finished, so that a failed leg makes the bench exit non-zero."""
    try:
        print(json.dumps({"metric": metric, **fn()}), file=sys.stderr, flush=True)
        return True
    except Exception as e:  # a failed leg must not lose the others
        print("%s failed: %r" % (metric, e), file=sys.stderr, flush=True)
        return False


def main() -> int:
    import torch

    suite_mode = os.environ.get("AMBIGRAM_BENCH_SUITE", "1")
    if suite_mode not in SUITE_MODES:
        print(
            "error: AMBIGRAM_BENCH_SUITE=%s is not a mode of the bench (modes: %s)"
            % (suite_mode, ", ".join(SUITE_MODES)),
            file=sys.stderr,
        )
        return 2
    if not torch.cuda.is_available():
        print("error: the port's bench needs an NVIDIA GPU; none is available", file=sys.stderr)
        return 1
    prog, st, X = build_workload(device="cuda")
    device_cps, _checksum, kernel_path = bench_device(st, X)
    try:
        base_cps = bench_baseline(prog, X)
        vs = device_cps / base_cps
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        print("baseline failed: %s" % e, file=sys.stderr)
        vs = 0.0
    # one candidate's score is one [1, Vp] x [Vp, Rows] int8 product,
    # 2*Vp*Rows operations; the chain's other work is not counted
    Rp, Vp = st.H8.shape
    achieved_tops = device_cps * 2.0 * Vp * Rp / 1e12
    payload = {
        "metric": "bfb_candidates_scored_per_sec_per_chip",
        "value": round(device_cps, 1),
        "unit": "candidates/s",
        "vs_baseline": round(vs, 2),
        "kernel_path": kernel_path,
        "int8": {
            "rows": int(Rp),
            "vars": int(Vp),
            "ops_per_candidate": int(2 * Vp * Rp),
            "achieved_tops": round(achieved_tops, 1),
            "peak_int8_tops": PEAK_INT8_TOPS,
            "utilization_pct": round(100.0 * achieved_tops / PEAK_INT8_TOPS, 1),
        },
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
    }
    # the result line goes out before the secondary legs, which take
    # minutes: a time limit hit during them must not lose it
    print(json.dumps(payload), flush=True)
    legs = {
        "1": [
            ("suite_seconds_large_cases", bench_suite),
            ("batch_throughput_cases_per_min", bench_batch),
            ("scaling_proxy_overhead", bench_scaling_proxy),
        ],
        "kernel": [("kernel_layout_sweep", lambda: bench_kernel_sweep(st, X))],
        "sc": [("sc_batch_throughput", bench_sc)],
        "big": [("large_s_device_vs_exact", bench_big)],
        "mesh": [("multi_gpu_batch", bench_mesh)],
    }.get(suite_mode, [])
    finished = [_secondary(metric, fn) for metric, fn in legs]
    return 0 if all(finished) else 1


if __name__ == "__main__":
    sys.exit(main())
