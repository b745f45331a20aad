"""Smoke run of the PyTorch/CUDA port (ambigram_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

It runs these phases in order; a failure in any of them exits non-zero
and prints no result line:

1. the card: nvidia-smi's name and power limit; a CUDA device must exist;
2. build every kernel of the port's paths from csrc/ (nvcc, sm_90a), one
   nvcc per source, all started together;
3. K1 (`score_rows`, csrc/score_rows.cu) against its plain PyTorch
   version on the tensors of the S=48 seed-0 case, at B=32 (the search's
   population) and B=1000 (ragged): hx bitwise equal, scores bitwise
   equal on the noise-free variant of the case (integer targets, so
   every f32 sum is exact) and within rtol 1e-5 on the noisy case
   (fractional targets: the f32 row sum rounds, and the two versions
   sum in different orders); then the times of both;
4. the single-case slice: the S=48 seed-0 case of the repo's 4xS48 suite
   through `python -m ambigram_tpu_torch.cli --op bfb --solver auto` on
   cuda, in process. Its program has more than 2048 variables, so auto
   sends it to the device search; the run must go through K1, print a
   path, and reach a feasible solution with eps <= 8.2245 (+1e-4), the
   value the host MILP and the JAX auto path reach on this case;
5. K2 (`chained_score`, csrc/chained_score.cu) against its plain version:
   on a small random int8 program (B=256, 5 rounds, every sum exact) the
   final candidates bitwise equal and the checksum within rel 1e-6; on
   the bench program at full width (3840 x 1152 int8, B=4096, 20
   rounds) the final candidates bitwise equal (both round each exact
   score once) and the checksum within rel 1e-5; the same at the bench's
   own batch (B=262144, 3 rounds), where the checksum adds 4096 block
   sums; a batch that does not divide into blocks must raise;
6. the bench's chain leg (`ambigram_tpu_torch.bench.bench_device`) at
   B=32768 and 50 rounds, which must launch K2; then the times of K2
   and its plain version at that shape (CUDA events);
7. K1 with a case axis, on a stacked pair of S=48 suite cases and on
   the two groups the batch path below stacks: hx bitwise equal to the
   plain per-case loop and the scores within rtol 1e-5 of it (noisy
   cases), and both bitwise equal to one single-case call per case;
8. the batch path: four cases of the bench's batch recipe (seeds
   200-203, S=32/48 alternating, noise 0.05; two same-shape groups of
   two) through `python -m ambigram_tpu_torch.cli --op bfb --manifest
   --solver device` on cuda, in process: every case prints a path with
   hard violation 0, the search runs as two case-stacked groups, and
   batched K1 launches at least twice;
9. a JSON line describing the kernels, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

SUITE = dict(n_segments=48, rounds=5, coverage=30.0, mode="process")
SEED = 0
EPS_BAR = 8.2245  # host MILP (30 s budget) and the JAX auto path, S=48 seed 0
K1_RTOL = 1e-5
K2_SMALL_RTOL = 1e-6  # exact per-candidate sums: only the checksum's order differs
K2_BENCH_RTOL = 1e-5  # the bar bench.py holds its chain layouts to
K2_TIMED = dict(B=32768, iters=50)
K2_HEADLINE = dict(B=262144, iters=3)  # the bench's batch, a few rounds
DEVICE = "cuda"


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out


def simulate_case(workdir: str, noise: float) -> str:
    """One case of the 4xS48 suite recipe; returns its .lh path."""
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

    case = simulate_bfb_case(seed=SEED, noise=noise, **SUITE)
    return write_case(case, os.path.join(workdir, "s48_seed%d_noise%g" % (SEED, noise)))["lh"]


def population(prog, x_ub, n: int, seed: int):
    """n candidates shaped like the search's: the seeded population, each
    member kicked at 4 random variables by +-1/+-2, clipped to the box."""
    import numpy as np

    from ambigram_tpu_torch.solver.host import _seed_case

    X, _ = _seed_case(prog, len(x_ub), x_ub, n, seed)
    rng = np.random.default_rng(seed)
    for b in range(n):
        v = rng.integers(0, prog.num_vars, size=4)
        np.add.at(X[b], v, rng.choice([-2.0, -1.0, 1.0, 2.0], size=4))
    return np.clip(X, 0.0, x_ub).astype(np.float32)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_k1(progs: dict) -> dict:
    """K1 against its plain version; returns the kernels-line numbers."""
    import numpy as np
    import torch

    from ambigram_tpu_torch.solver.score import score_rows, score_rows_plain, scoring_tensors

    worst = 0.0
    timing = {}
    for label, prog in progs.items():
        st = scoring_tensors(prog, DEVICE)
        x_ub = st.x_ub.cpu().numpy()
        rng = np.random.default_rng(1)
        dense = np.zeros((32, len(x_ub)), dtype=np.float32)
        dense[:, : prog.num_vars] = rng.integers(0, prog.x_ub.astype(np.int64) + 1, size=(32, prog.num_vars))
        sets = {"population": population(prog, x_ub, 1000, seed=2), "dense": dense}
        for kind, X_all in sets.items():
            for B in (32, 1000):
                if B > len(X_all):
                    continue
                X = torch.as_tensor(X_all[:B]).to(DEVICE)
                s_k, hx_k = score_rows(st, X, want_hx=True)
                s_p, hx_p = score_rows_plain(st, X, want_hx=True)
                torch.cuda.synchronize()
                if not torch.equal(hx_k, hx_p):
                    raise AssertionError("K1 hx differs from plain (%s %s B=%d)" % (label, kind, B))
                err = float((s_k - s_p).abs().max())
                exact = label == "noise0" and kind == "population"
                if exact and not torch.equal(s_k, s_p):
                    raise AssertionError("K1 scores not bitwise (%s %s B=%d): %g" % (label, kind, B, err))
                rel = float(((s_k - s_p).abs() / s_p.abs().clamp(min=1.0)).max())
                if rel > K1_RTOL:
                    raise AssertionError("K1 scores off by rel %g (%s %s B=%d)" % (rel, label, kind, B))
                if kind == "population":
                    worst = max(worst, err)
                log(
                    "k1 %s %s B=%d: hx bitwise equal, scores %s, max_abs_err %r, max score %r"
                    % (label, kind, B, "bitwise equal" if torch.equal(s_k, s_p) else "rel %.3g" % rel,
                       err, float(s_p.max()))
                )
        for B in (32, 1000):
            X = torch.as_tensor(sets["population"][:B]).to(DEVICE)
            plain_a = cuda_ms(lambda: score_rows_plain(st, X, want_hx=True))
            kern_a = cuda_ms(lambda: score_rows(st, X, want_hx=True))
            kern_b = cuda_ms(lambda: score_rows(st, X, want_hx=True))
            plain_b = cuda_ms(lambda: score_rows_plain(st, X, want_hx=True))
            kern, plain = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
            timing[(label, B)] = (kern, plain)
            log(
                "k1 time %s B=%d rows=%d vp=%d: kernel %.4f ms (%.4f, %.4f), plain %.4f ms (%.4f, %.4f)"
                % (label, B, st.H.shape[0], st.H.shape[1], kern, kern_a, kern_b, plain, plain_a, plain_b)
            )
        del st
        torch.cuda.empty_cache()
    kern, plain = timing[("noise0.05", 32)]
    return {"max_abs_err": worst, "ms": kern, "plain_ms": plain}


def random_int8_prog(seed: int = 2, n: int = 10):
    """The small random program of tests/test_solver.py's chain test:
    loops stacked on a CN profile plus 0/1 noise, x_ub capped at 127."""
    import numpy as np

    from ambigram_tpu.engine.enumerate import enumerate_pairs
    from ambigram_tpu.engine.ilp import build_bfb_program

    rng = np.random.default_rng(seed)
    pairs = enumerate_pairs(1, n)
    T = len(pairs)
    x = np.zeros(2 * T)
    for _ in range(rng.integers(2, 5)):
        x[T + rng.integers(0, T)] += rng.integers(1, 3)
    seg_cn, fbi_cn = np.zeros(n), np.zeros(n)
    for t, (i, j) in enumerate(pairs):
        if x[T + t] > 0:
            seg_cn[i - 1 : j] += 2 * x[T + t]
            fbi_cn[i - 1] += x[T + t]
            fbi_cn[j - 1] += x[T + t]
    seg_cn += rng.integers(0, 2, size=n)
    prog = build_bfb_program(1, n, seg_cn, fbi_cn, seg_cn.sum(), 1)
    prog.x_ub = np.minimum(prog.x_ub, 127)
    return prog, rng


def check_k2() -> dict:
    """K2 against its plain version, the bench's chain leg (which must
    launch K2) and the times of both; returns the kernels-line numbers."""
    import numpy as np
    import torch

    from ambigram_tpu_torch import bench
    from ambigram_tpu_torch.solver.score import chained_score, chained_score_plain, scoring_tensors

    prog, rng = random_int8_prog()
    st = scoring_tensors(prog, DEVICE)
    X = np.zeros((256, st.H8.shape[1]), dtype=np.float32)
    X[:, : prog.num_vars] = rng.integers(0, 2, size=(256, prog.num_vars))
    X = torch.as_tensor(X).to(DEVICE)
    acc_p, x_p = chained_score_plain(st, X, 5, want_x=True)
    for block_b in (64, 32):
        acc_k, x_k = chained_score(st, X, 5, block_b=block_b, want_x=True)
        torch.cuda.synchronize()
        rel = abs(float(acc_k) / float(acc_p) - 1.0)
        if not torch.equal(x_k, x_p) or rel > K2_SMALL_RTOL:
            raise AssertionError("K2 small program, block_b %d: X equal %s, checksum rel %g"
                                 % (block_b, torch.equal(x_k, x_p), rel))
        log("k2 small V=%d rows=%d B=256 iters=5 block_b=%d: X bitwise equal, checksum %r vs plain %r (rel %.3g)"
            % (prog.num_vars, st.H8.shape[0], block_b, float(acc_k), float(acc_p), rel))

    prog, st, X_all = bench.build_workload(batch=K2_HEADLINE["B"], device=DEVICE)
    bench_rel = 0.0
    for B, iters in ((4096, 20), (K2_HEADLINE["B"], K2_HEADLINE["iters"])):
        X = torch.as_tensor(X_all[:B]).to(DEVICE)
        acc_p, x_p = chained_score_plain(st, X, iters, want_x=True)
        acc_k, x_k = chained_score(st, X, iters, want_x=True)
        torch.cuda.synchronize()
        rel = abs(float(acc_k) / float(acc_p) - 1.0)
        same_x = torch.equal(x_k, x_p)
        log("k2 bench %dx%d B=%d iters=%d: X %s, checksum %r vs plain %r (rel %.3g)"
            % (st.H8.shape[0], st.H8.shape[1], B, iters, "bitwise equal" if same_x else "DIFFERS",
               float(acc_k), float(acc_p), rel))
        if not same_x or rel > K2_BENCH_RTOL:
            raise AssertionError("K2 disagrees with plain at the bench width, B=%d (rel %g)" % (B, rel))
        bench_rel = max(bench_rel, rel)
        del x_p, x_k
    X = X[:4096]
    try:
        chained_score(st, X[:4000], 1)
    except ValueError as e:
        log("k2 B=4000: raised as it must (%s)" % e)
    else:
        raise AssertionError("K2 accepted a batch that does not divide into blocks")

    del X
    torch.cuda.empty_cache()
    B, iters = K2_TIMED["B"], K2_TIMED["iters"]
    X_host = X_all[:B]
    chained_score.launches = 0
    cps, checksum, kernel_path = bench.bench_device(st, X_host, iters=iters)
    launches = chained_score.launches
    log("k2 bench chain leg (%s) B=%d iters=%d: %.1f candidates/s, checksum %r, K2 launches %d"
        % (kernel_path, B, iters, cps, checksum, launches))
    if launches < 1:
        raise AssertionError("the bench's chain leg never launched K2")
    Xd = torch.as_tensor(X_host).to(DEVICE)
    plain_a = cuda_ms(lambda: chained_score_plain(st, Xd, iters), iters=1, warmup=1)
    kern_a = cuda_ms(lambda: chained_score(st, Xd, iters), iters=1, warmup=1)
    kern_b = cuda_ms(lambda: chained_score(st, Xd, iters), iters=1, warmup=0)
    plain_b = cuda_ms(lambda: chained_score_plain(st, Xd, iters), iters=1, warmup=0)
    kern, plain = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    log("k2 time B=%d iters=%d: kernel %.3f ms (%.3f, %.3f) = %.1f candidates/s, plain %.3f ms (%.3f, %.3f) = %.1f candidates/s"
        % (B, iters, kern, kern_a, kern_b, B * iters / kern * 1e3, plain, plain_a, plain_b, B * iters / plain * 1e3))
    del Xd
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": bench_rel, "ms": kern, "plain_ms": plain}


def check_k1_cases(label: str, progs) -> float:
    """K1 with a case axis on a stacked group, at the search's
    population (B=32): hx bitwise equal to the plain per-case loop and
    the scores within K1_RTOL of it (noisy cases: fractional targets
    round in another order), and both bitwise equal to one single-case
    call per case. Returns the largest score difference from plain."""
    import numpy as np
    import torch

    from ambigram_tpu_torch.parallel.mesh import stack_cases
    from ambigram_tpu_torch.solver.score import score_rows, score_rows_plain

    st = stack_cases(progs, DEVICE)
    x_ub = st.x_ub.cpu().numpy()
    X = torch.as_tensor(np.stack([population(p, x_ub[g], 32, seed=g) for g, p in enumerate(progs)])).to(DEVICE)
    s_b, hx_b = score_rows(st, X, want_hx=True)
    s_p, hx_p = score_rows_plain(st, X, want_hx=True)
    torch.cuda.synchronize()
    if not torch.equal(hx_b, hx_p):
        raise AssertionError("batched K1 hx differs from plain (%s)" % label)
    err = float((s_b - s_p).abs().max())
    rel = float(((s_b - s_p).abs() / s_p.abs().clamp(min=1.0)).max())
    if rel > K1_RTOL:
        raise AssertionError("batched K1 scores off plain by rel %g (%s)" % (rel, label))
    for g in range(len(progs)):
        s_g, hx_g = score_rows(st.case(g), X[g].contiguous(), want_hx=True)
        torch.cuda.synchronize()
        if not (torch.equal(s_g, s_b[g]) and torch.equal(hx_g, hx_b[g])):
            raise AssertionError("batched K1 differs from the single-case call for case %d (%s)" % (g, label))
    log("k1 cases %s G=%d B=32 rows=%d vp=%d: hx bitwise equal to plain, scores %s (max_abs_err %r), "
        "both bitwise equal to %d single-case calls"
        % (label, len(progs), st.H.shape[-2], st.H.shape[-1],
           "bitwise equal" if torch.equal(s_b, s_p) else "rel %.3g" % rel, err, len(progs)))
    return err


def batch_groups(paths):
    """The programs of the batch cases, grouped as `solve_device_batch`
    groups them (by interval and variable count)."""
    from ambigram_tpu.engine.pipeline import extract_programs

    groups: dict = {}
    for path in paths:
        prog = extract_programs(path)[0]
        groups.setdefault((prog.start, prog.end, prog.num_vars), []).append(prog)
    return groups


def run_batch(workdir: str, paths) -> dict:
    """The batch path: four cases through the CLI's --manifest on cuda."""
    import numpy as np
    import torch

    from ambigram_tpu.engine.pipeline import extract_programs
    from ambigram_tpu.utils.profiling import GLOBAL
    from ambigram_tpu_torch import bench, cli
    from ambigram_tpu_torch.solver.score import score_rows

    manifest = os.path.join(workdir, "batch.manifest")
    with open(manifest, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    argv = ["--op", "bfb", "--manifest", "--in_lh", manifest, "--solver", "device", "--device", DEVICE, "--no-ledgers"]
    log("batch: python -m ambigram_tpu_torch.cli " + " ".join(argv))
    GLOBAL.reset()
    score_rows.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        results = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = score_rows.launches
    if not results or len(results) != len(paths):
        raise AssertionError("the manifest run returned %r" % (results,))
    lines = buf.getvalue().splitlines()
    violations = bench.case_violations(paths, results)
    for path, r in zip(paths, results):
        prog = extract_programs(path)[0]
        x = np.asarray(r.chromosomes[0].element_cn, dtype=np.float64)
        log("batch case %s: V=%d eps %r, hard_violation %r, certified %s"
            % (os.path.basename(path), prog.num_vars, float(prog.residual_objective(x)),
               float(prog.hard_violation(x)), r.chromosomes[0].certified))
        if not r.path_strings or not all(p and p in lines for p in r.path_strings):
            raise AssertionError("no path printed for %s" % path)
    log("batch: 4 cases, wall %.3f s, %.2f cases/min, K1 launches %d" % (wall, 4 * 60.0 / wall, launches))
    for name in ("solve.tensors", "solve.lp_bound", "score", "solve.lns", "solve.exact", "replay"):
        st = GLOBAL.phases.get(name)
        log("phase %-15s %.3f s x%d" % (name, st.seconds if st else 0.0, st.calls if st else 0))
    for name in sorted(GLOBAL.counters):
        log("counter %-22s %r" % (name, GLOBAL.counters[name]))
    if max(violations) != 0.0:
        raise AssertionError("a batch solution violates hard rows: %r" % violations)
    calls = GLOBAL.counters.get("solve.device_calls", 0.0)
    if calls != 2:
        raise AssertionError("expected two case-stacked searches, got %r device calls" % calls)
    if launches < 2:
        raise AssertionError("batched K1 launched %d times, expected >= 2" % launches)
    return {"launches": launches, "wall": wall}


def run_slice(lh: str) -> dict:
    import numpy as np
    import torch

    from ambigram_tpu.engine.pipeline import AUTO_EXACT_FIRST_MAX_VARS, extract_programs
    from ambigram_tpu.utils.profiling import GLOBAL
    from ambigram_tpu_torch import cli
    from ambigram_tpu_torch.solver.score import score_rows

    prog = extract_programs(lh)[0]
    if prog.num_vars <= AUTO_EXACT_FIRST_MAX_VARS:
        raise AssertionError("case has %d variables: auto would not reach the device" % prog.num_vars)
    argv = ["--op", "bfb", "--in_lh", lh, "--solver", "auto", "--device", DEVICE, "--no-ledgers"]
    log("slice: python -m ambigram_tpu_torch.cli " + " ".join(argv))
    GLOBAL.reset()
    score_rows.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = score_rows.launches
    if res is None:
        raise AssertionError("the CLI rejected its arguments")
    text = buf.getvalue()
    path = res.path_strings[0] if res.path_strings else ""
    if not path or path not in text.splitlines():
        raise AssertionError("no path printed:\n" + text[-2000:])
    x = np.asarray(res.chromosomes[0].element_cn, dtype=np.float64)
    eps = float(prog.residual_objective(x))
    vio = float(prog.hard_violation(x))
    calls = GLOBAL.counters.get("solve.device_calls", 0.0)
    log("slice: V=%d rows=%d wall %.3f s, eps %r, hard_violation %r, certified %s"
        % (prog.num_vars, prog.G.shape[0] + 2 * prog.n, wall, eps, vio, res.chromosomes[0].certified))
    log("slice: path %s" % path)
    for name in ("solve.tensors", "solve.lp_bound", "score", "solve.lns", "solve", "replay"):
        st = GLOBAL.phases.get(name)
        log("phase %-15s %.3f s x%d" % (name, st.seconds if st else 0.0, st.calls if st else 0))
    for name in sorted(GLOBAL.counters):
        log("counter %-22s %r" % (name, GLOBAL.counters[name]))
    score_s = GLOBAL.phases["score"].seconds if "score" in GLOBAL.phases else 0.0
    if score_s:
        log("candidates_scored / score phase: %.1f per s" % (GLOBAL.counters.get("candidates_scored", 0.0) / score_s))
    if calls < 1:
        raise AssertionError("the device search never ran (solve.device_calls = %r)" % calls)
    if launches < 2:
        raise AssertionError("K1 launched %d times in the slice, expected >= 2" % launches)
    if vio != 0.0:
        raise AssertionError("solution violates hard rows: %r" % vio)
    if eps > EPS_BAR + 1e-4:
        raise AssertionError("eps %r above the bar %r" % (eps, EPS_BAR))
    return {"launches": launches, "wall": wall}


def build_kernels() -> None:
    """Build every kernel of the port at once (one nvcc per source)."""
    from concurrent.futures import ThreadPoolExecutor

    from ambigram_tpu_torch import kernels
    from ambigram_tpu_torch.solver.score import _k1_library, _k2_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        for fut in [pool.submit(_k1_library), pool.submit(_k2_library)]:
            fut.result()
    log("build: %.2f s for both kernels" % (time.perf_counter() - t0))
    for name in ("score_rows", "chained_score"):
        info = kernels.BUILD_INFO[name]
        log("build: %s %.2f s in nvcc" % (name, info["seconds"]))
        if info["log"]:
            log(info["log"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    log(card_line())
    log("torch %s, cuda %s, python %s" % (torch.__version__, torch.version.cuda, sys.version.split()[0]))
    build_kernels()

    from ambigram_tpu.engine.pipeline import extract_programs

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        lh = simulate_case(workdir, noise=0.05)
        lh_exact = simulate_case(workdir, noise=0.0)
        prog = extract_programs(lh)[0]
        k1 = check_k1({"noise0.05": prog, "noise0": extract_programs(lh_exact)[0]})
        sl = run_slice(lh)
        k2 = check_k2()
        from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

        case1 = simulate_bfb_case(seed=1, noise=0.05, **SUITE)
        prog1 = extract_programs(write_case(case1, os.path.join(workdir, "s48_seed1"))["lh"])[0]
        k1_err = [check_k1_cases("s48 seeds 0,1", [prog, prog1])]
        from ambigram_tpu_torch import bench

        paths = bench.batch_case_paths(workdir, n_cases=4)
        for key, group in batch_groups(paths).items():
            k1_err.append(check_k1_cases("batch group V=%d" % key[2], group))
        batch = run_batch(workdir, paths)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels_line = {
        "kernels": [
            {
                "name": "score_rows",
                "route": "cuda",
                "source": "ambigram_tpu_torch/csrc/score_rows.cu",
                "replaces": "ambigram_tpu/solver/score.py:435",
                "launches": sl["launches"] + batch["launches"],
                "max_abs_err": max([k1["max_abs_err"]] + k1_err),
                "ms": k1["ms"],
                "plain_ms": k1["plain_ms"],
            },
            {
                "name": "chained_score",
                "route": "cuda",
                "source": "ambigram_tpu_torch/csrc/chained_score.cu",
                "replaces": "ambigram_tpu/solver/score.py:336",
                "launches": k2["launches"],
                "max_abs_err": k2["max_abs_err"],
                "ms": k2["ms"],
                "plain_ms": k2["plain_ms"],
            },
        ]
    }
    print(json.dumps(kernels_line))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
