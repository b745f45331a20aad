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
"1" (default) the 4xS48 suite (device, auto and exact modes) and the
16-case batch (`run_bfb_many` against a serial exact loop); "0" none;
"kernel" the K2 layout sweep. The JAX bench's other modes (the scaling
proxy, "big", "sc") are not yet ported and exit with code 2.
"""

from __future__ import annotations

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
SUITE_MODES = ("0", "1", "kernel")


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


def bench_batch() -> dict:
    """Batch throughput: `run_bfb_many(solver="device")` over the mixed
    S=32/S=48 case list on the card, against the serial per-case loop
    of the host MILP (15 s per case) that stands in for the reference's
    one process per sample. One identical warm-up run first, reported
    apart."""
    from ambigram_tpu_torch.engine.pipeline import extract_programs, run_bfb, run_bfb_many
    from ambigram_tpu_torch.solver.exact import solve_exact
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    device, n_cases = "cuda", 16
    td = tempfile.mkdtemp(prefix="ambigram_batch_bench_")
    try:
        lh_paths = batch_case_paths(td, n_cases)
        t0 = time.perf_counter()
        run_bfb_many(lh_paths, solver="device", device=device)
        warmup_seconds = round(time.perf_counter() - t0, 1)

        GLOBAL.reset()
        t0 = time.perf_counter()
        batch_res = run_bfb_many(lh_paths, solver="device", device=device)
        batch_secs = time.perf_counter() - t0
        stages = {k: round(v.seconds, 1) for k, v in sorted(GLOBAL.phases.items()) if v.seconds >= 0.05}
        counters = dict(sorted(GLOBAL.counters.items()))
        # a chromosome whose solution does not replay yields an empty path
        batch_ok = sum(1 for r in batch_res if any(s for s in r.path_strings))
        batch_eps = round(sum(r.ilp_error for r in batch_res), 2)
        worst_violation = max(case_violations(lh_paths, batch_res), default=0.0)

        t0 = time.perf_counter()
        serial_ok, serial_eps = 0, 0.0
        for p in lh_paths:
            presolved = [solve_exact(pr, time_limit=15.0) if pr is not None else None for pr in extract_programs(p)]
            r = run_bfb(p, solver="exact", device=device, presolved=presolved)
            serial_ok += bool(any(s for s in r.path_strings))
            serial_eps += r.ilp_error
        serial_secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(td, ignore_errors=True)
    return {
        "cases": "%dx mixed S32/S48 noise=0.05" % n_cases,
        "warmup_seconds": warmup_seconds,
        "batch_device": {
            "seconds": round(batch_secs, 1),
            "cases_per_min": round(60.0 * n_cases / batch_secs, 2),
            "solved": batch_ok,
            "eps_sum": batch_eps,
            "max_hard_violation": worst_violation,
            # phases summed over threads: the host tails overlap the searches
            "stages": stages,
            "counters": counters,
        },
        "serial_exact": {
            "seconds": round(serial_secs, 1),
            "cases_per_min": round(60.0 * n_cases / serial_secs, 2),
            "solved": serial_ok,
            "eps_sum": round(serial_eps, 2),
        },
        "batch_speedup": round(serial_secs / batch_secs, 2) if batch_secs else 0.0,
    }


def _secondary(metric: str, fn) -> None:
    """Run one secondary leg; its JSON line (or its failure) goes to
    stderr so stdout stays the single result line."""
    try:
        print(json.dumps({"metric": metric, **fn()}), file=sys.stderr, flush=True)
    except Exception as e:  # a failed leg must not lose the others
        print("%s failed: %r" % (metric, e), file=sys.stderr, flush=True)


def main() -> int:
    import torch

    suite_mode = os.environ.get("AMBIGRAM_BENCH_SUITE", "1")
    if suite_mode not in SUITE_MODES:
        print(
            "error: AMBIGRAM_BENCH_SUITE=%s is not yet ported to ambigram_tpu_torch (ported: %s)"
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
    }
    # the result line goes out before the secondary legs, which take
    # minutes: a time limit hit during them must not lose it
    print(json.dumps(payload), flush=True)
    if suite_mode == "1":
        _secondary("suite_seconds_large_cases", bench_suite)
        _secondary("batch_throughput_cases_per_min", bench_batch)
    elif suite_mode == "kernel":
        _secondary("kernel_layout_sweep", lambda: bench_kernel_sweep(st, X))
    return 0


if __name__ == "__main__":
    sys.exit(main())
