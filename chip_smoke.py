"""Smoke run of the PyTorch/CUDA port (ambigram_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

It runs these phases in order; a failure in any of them exits non-zero
and prints no result line:

1. the card: nvidia-smi's name and power limit; a CUDA device must exist;
2. build every kernel of the port's paths from csrc/ (nvcc, sm_90a), one
   nvcc per source, all started together; ptxas's register and spill
   report, and the tensor-core instructions in each library's SASS
   (cuobjdump), which must be there;
3. K1 (`score_rows`, csrc/score_rows.cu) against its plain PyTorch
   version on the tensors of the S=48 seed-0 case, on its int8
   tensor-core path, at B=32 (the search's population) and B=1000
   (ragged): hx bitwise equal, scores bitwise equal on the noise-free
   variant of the case (integer targets, so every f32 sum is exact) and
   within rtol 1e-5 on the noisy case (fractional targets: the f32 row
   sum rounds, and the two versions sum in different orders); the same
   on its f32 path, on the noisy case with its FBI coefficients halved
   (rows that are not int8-exact); then the device times of the kernel,
   the plain version and one `torch.matmul(X, H.T)` in f32, each after
   an L2 flush, beside the least time the card could take, and the host
   time each takes to queue a call;
4. the single-case slice: the S=48 seed-0 case of the repo's 4xS48 suite
   through `python -m ambigram_tpu_torch.cli --op bfb --solver auto` on
   cuda, in process. Its program has more than 2048 variables, so auto
   sends it to the device search; the run must go through K1's int8
   path, print a path, and reach a feasible solution with eps <= 8.2245
   (+1e-4), the value the host MILP and the JAX auto path reach;
5. K2 (`chained_score`, csrc/chained_score.cu) against its plain version:
   on a small random int8 program (B=256, 5 rounds, every sum exact) the
   final candidates bitwise equal and the checksum within rel 1e-6; on
   the bench program at full width (3840 x 1152 int8, B=4096, 20
   rounds) the final candidates bitwise equal (both round each exact
   score once) and the checksum within rel 1e-5; the same at the bench's
   own batch (B=262144, 3 rounds), where the checksum adds 2048 block
   sums; a batch that does not divide into blocks must raise;
6. the bench's chain leg (`ambigram_tpu_torch.bench.bench_device`) at
   B=32768 and 50 rounds, which must launch K2; then the times of K2,
   its plain version and 50 `torch._int_mm(X8, H8.t())` at that shape,
   and, when AMBIGRAM_K2_BASELINE_SRC names the source of an earlier K2
   with the dp4a kernel's C interface, that kernel's time beside them;
7. K1 with a case axis, on a stacked pair of S=48 suite cases and on
   the two groups the batch path below stacks: hx bitwise equal to the
   plain per-case loop and the scores within rtol 1e-5 of it (noisy
   cases), and both bitwise equal to one single-case call per case;
8. the batch path: four cases of the bench's batch recipe (seeds
   200-203, S=32/48 alternating, noise 0.05; two same-shape groups of
   two) through `python -m ambigram_tpu_torch.cli --op bfb --manifest
   --solver device` on cuda, in process: every case prints a path with
   hard violation 0, the search runs as two case-stacked groups, and
   batched K1 launches at least twice, on its int8 path;
9. a JSON line describing the kernels, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Every launch count in the kernels line comes from the main paths (the
slice, the chain leg and the manifest), each driven with the counts set
to 0 just before it and read just after.
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
# NVIDIA H100 SXM data sheet (dense, at 700 W): the bounds' peaks
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
L2_FLUSH_BYTES = 128 << 20  # more than the card's 50 MB L2
HOST_LEAD_CYCLES = 1_000_000  # about 0.5 ms of spin, longer than the host takes to queue a call


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
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

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
    """Mean device time of `fn` in back-to-back runs (CUDA events). The
    card spins (torch.cuda._sleep) while the host queues the runs, so
    the events time the device's work, not the host's queueing."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_LEAD_CYCLES * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_FLUSH = []


def cuda_ms_cold(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` with the L2 cache flushed before each
    run, as the search finds it after its sweeps: events bracket `fn`
    alone, queued behind a spin as in `cuda_ms`."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEVICE))
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        _FLUSH[0].zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host time to queue one call of `fn` (the card keeps up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def bound_ms(bytes_moved: float, ops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(st, B: int):
    """K1's int8 path at one case: H8 and the row vectors read once, X
    read once, hx and the scores written once; 2 B Rows Vp int8
    operations."""
    rows, vp = st.H8.shape
    bytes_moved = rows * vp + 3 * rows * 4 + B * vp * 4 + B * rows * 4 + B * 4
    return bound_ms(bytes_moved, 2.0 * B * rows * vp)


def check_k1_case(label, st, X_sets, exact_kind, path):
    """K1 against its plain version on the sets of candidates, through
    the given path; returns the largest score difference from plain."""
    import torch

    from ambigram_tpu_torch.solver.score import score_rows, score_rows_plain

    counter = "int8_launches" if path == "int8" else "f32_launches"
    worst = 0.0
    for kind, X_all in X_sets.items():
        for B in (32, 1000):
            if B > len(X_all):
                continue
            X = torch.as_tensor(X_all[:B]).to(DEVICE)
            before = getattr(score_rows, counter)
            s_k, hx_k = score_rows(st, X, want_hx=True)
            if getattr(score_rows, counter) != before + 1:
                raise AssertionError("K1 did not take its %s path (%s %s B=%d)" % (path, label, kind, B))
            s_p, hx_p = score_rows_plain(st, X, want_hx=True)
            torch.cuda.synchronize()
            if not torch.equal(hx_k, hx_p):
                raise AssertionError("K1 hx differs from plain (%s %s B=%d)" % (label, kind, B))
            err = float((s_k - s_p).abs().max())
            if kind == exact_kind and not torch.equal(s_k, s_p):
                raise AssertionError("K1 scores not bitwise (%s %s B=%d): %g" % (label, kind, B, err))
            rel = float(((s_k - s_p).abs() / s_p.abs().clamp(min=1.0)).max())
            if rel > K1_RTOL:
                raise AssertionError("K1 scores off by rel %g (%s %s B=%d)" % (rel, label, kind, B))
            if kind == "population":
                worst = max(worst, err)
            log(
                "k1 %s path %s %s B=%d: hx bitwise equal, scores %s, max_abs_err %r, max score %r"
                % (path, label, kind, B, "bitwise equal" if torch.equal(s_k, s_p) else "rel %.3g" % rel,
                   err, float(s_p.max()))
            )
    return worst


def time_k1(label, st, X_pop, path):
    """Times at B=32 and B=1000, each after an L2 flush: K1, its plain
    version and one torch.matmul(X, H.T) in f32 (the library call for
    the product alone); {B: (kernel, plain, library, bound, bound_by)}."""
    import torch

    from ambigram_tpu_torch.solver.score import score_rows, score_rows_plain

    out = {}
    for B in (32, 1000):
        X = torch.as_tensor(X_pop[:B]).to(DEVICE)
        H = st.H
        plain_a = cuda_ms_cold(lambda: score_rows_plain(st, X, want_hx=True))
        lib_a = cuda_ms_cold(lambda: torch.matmul(X, H.t()))
        kern_a = cuda_ms_cold(lambda: score_rows(st, X, want_hx=True))
        kern_b = cuda_ms_cold(lambda: score_rows(st, X, want_hx=True))
        lib_b = cuda_ms_cold(lambda: torch.matmul(X, H.t()))
        plain_b = cuda_ms_cold(lambda: score_rows_plain(st, X, want_hx=True))
        warm = cuda_ms(lambda: score_rows(st, X, want_hx=True))
        host_k = host_us(lambda: score_rows(st, X, want_hx=True))
        host_l = host_us(lambda: torch.matmul(X, H.t()))
        kern, plain, lib = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2, (lib_a + lib_b) / 2
        bnd, by = k1_bound(st, B)
        out[B] = (kern, plain, lib, bnd, by)
        log(
            "k1 time %s path %s B=%d rows=%d vp=%d (device, L2 flushed): kernel %.4f ms (%.4f, %.4f; %.4f back to back), "
            "plain %.4f ms (%.4f, %.4f), torch.matmul f32 %.4f ms (%.4f, %.4f), bound %.4f ms (%s); "
            "host time to queue one call: kernel %.1f us, torch.matmul %.1f us"
            % (path, label, B, st.H.shape[0], st.H.shape[1], kern, kern_a, kern_b, warm, plain, plain_a, plain_b,
               lib, lib_a, lib_b, bnd, by, host_k, host_l)
        )
    return out


def check_k1(progs: dict) -> dict:
    """K1 on both paths against its plain version, and its times;
    returns the kernels-line numbers (the int8 path on the noisy S=48
    case at B=32, the search's population)."""
    import dataclasses

    import numpy as np
    import torch

    from ambigram_tpu_torch.solver.score import k1_planes, scoring_tensors

    worst = 0.0
    timing = {}
    for label, prog in progs.items():
        st = scoring_tensors(prog, DEVICE)
        if k1_planes(st) != 1:
            raise AssertionError("the S=48 case should take K1's one-plane int8 path (%s)" % label)
        x_ub = st.x_ub.cpu().numpy()
        rng = np.random.default_rng(1)
        dense = np.zeros((32, len(x_ub)), dtype=np.float32)
        dense[:, : prog.num_vars] = rng.integers(0, prog.x_ub.astype(np.int64) + 1, size=(32, prog.num_vars))
        sets = {"population": population(prog, x_ub, 1000, seed=2), "dense": dense}
        exact_kind = "population" if label == "noise0" else None
        worst = max(worst, check_k1_case(label, st, sets, exact_kind, "int8"))
        if label == "noise0.05":
            timing = time_k1(label, st, sets["population"], "int8")
        del st
        torch.cuda.empty_cache()

    # the f32 path: the noisy case's FBI coefficients halved leave 0.25s,
    # which the int8 representation cannot hold
    prog = progs["noise0.05"]
    halved = dataclasses.replace(prog, A_fbi=prog.A_fbi * 0.5)
    st = scoring_tensors(halved, DEVICE)
    if st.int8_ok or k1_planes(st) != 0:
        raise AssertionError("the halved program should fail int8_ok and take K1's f32 path")
    x_ub = st.x_ub.cpu().numpy()
    pop = population(halved, x_ub, 1000, seed=2)
    worst = max(worst, check_k1_case("noise0.05 halved", st, {"population": pop}, None, "f32"))
    f32_timing = time_k1("noise0.05 halved", st, pop, "f32")
    del st
    torch.cuda.empty_cache()
    kern, plain, lib, bnd, by = timing[32]
    return {
        "max_abs_err": worst,
        "ms": kern,
        "plain_ms": plain,
        "library_ms": lib,
        "bound_ms": bnd,
        "bound_by": by,
        "ms_b1000": timing[1000][0],
        "f32_path_ms": f32_timing[32][0],
    }


def random_int8_prog(seed: int = 2, n: int = 10):
    """The small random program of tests/test_solver.py's chain test:
    loops stacked on a CN profile plus 0/1 noise, x_ub capped at 127."""
    import numpy as np

    from ambigram_tpu_torch.engine.enumerate import enumerate_pairs
    from ambigram_tpu_torch.engine.ilp import build_bfb_program

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


def previous_k2(st, X, iters: int):
    """An earlier K2 (the dp4a kernel: packed, transposed H8 and the
    per-row vectors as separate arguments, 64 candidates a block), built
    from the source AMBIGRAM_K2_BASELINE_SRC names; a function that runs
    it on X for `iters` rounds and returns (checksum, final X). None
    when the variable is unset."""
    import ctypes

    import torch

    from ambigram_tpu_torch import kernels

    src = os.environ.get("AMBIGRAM_K2_BASELINE_SRC")
    if not src:
        return None
    so = os.path.join(kernels.BUILD_DIR, "libk2_baseline.so")
    info = kernels.build(os.path.abspath(src), so)
    log("build: baseline K2 %s %.2f s in nvcc" % (src, info["seconds"]))
    lib = ctypes.CDLL(so)
    fn = lib.chained_score_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    HTw = st.H8.contiguous().view(torch.int32).t().contiguous()
    B, vp = X.shape
    rows = st.H8.shape[0]

    def run():
        X_out = torch.empty_like(X)
        blocks = torch.empty(B // 64, dtype=torch.float32, device=X.device)
        checksum = torch.zeros((), dtype=torch.float32, device=X.device)
        err = fn(HTw.data_ptr(), st.lb_raw.data_ptr(), st.ub_raw.data_ptr(), st.w.data_ptr(),
                 st.x_ub.data_ptr(), X.data_ptr(), X_out.data_ptr(), blocks.data_ptr(), checksum.data_ptr(),
                 B, rows, vp, iters, 64, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("baseline K2 launch failed: cudaError %d" % err)
        return checksum, X_out

    return run


def check_k2() -> dict:
    """K2 against its plain version, the bench's chain leg (which must
    launch K2) and the times of K2, its plain version and the library
    call; returns the kernels-line numbers."""
    import numpy as np
    import torch

    from ambigram_tpu_torch import bench
    from ambigram_tpu_torch.solver.score import (
        K2_BLOCK_B,
        chained_score,
        chained_score_plain,
        reset_launch_counts,
        scoring_tensors,
    )

    prog, rng = random_int8_prog()
    st = scoring_tensors(prog, DEVICE)
    X = np.zeros((256, st.H8.shape[1]), dtype=np.float32)
    X[:, : prog.num_vars] = rng.integers(0, 2, size=(256, prog.num_vars))
    X = torch.as_tensor(X).to(DEVICE)
    acc_p, x_p = chained_score_plain(st, X, 5, want_x=True)
    for block_b in K2_BLOCK_B:
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
    for B, iters, block_bs in ((4096, 20, K2_BLOCK_B), (K2_HEADLINE["B"], K2_HEADLINE["iters"], (128,))):
        X = torch.as_tensor(X_all[:B]).to(DEVICE)
        acc_p, x_p = chained_score_plain(st, X, iters, want_x=True)
        for block_b in block_bs:
            acc_k, x_k = chained_score(st, X, iters, block_b=block_b, want_x=True)
            torch.cuda.synchronize()
            rel = abs(float(acc_k) / float(acc_p) - 1.0)
            same_x = torch.equal(x_k, x_p)
            log("k2 bench %dx%d B=%d iters=%d block_b=%d: X %s, checksum %r vs plain %r (rel %.3g)"
                % (st.H8.shape[0], st.H8.shape[1], B, iters, block_b, "bitwise equal" if same_x else "DIFFERS",
                   float(acc_k), float(acc_p), rel))
            if not same_x or rel > K2_BENCH_RTOL:
                raise AssertionError("K2 disagrees with plain at the bench width, B=%d (rel %g)" % (B, rel))
            bench_rel = max(bench_rel, rel)
            del x_k
        del x_p
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
    reset_launch_counts()
    cps, checksum, kernel_path = bench.bench_device(st, X_host, iters=iters)
    launches = chained_score.launches
    log("k2 bench chain leg (%s) B=%d iters=%d: %.1f candidates/s, checksum %r, K2 launches %d"
        % (kernel_path, B, iters, cps, checksum, launches))
    if launches < 1:
        raise AssertionError("the bench's chain leg never launched K2")
    Xd = torch.as_tensor(X_host).to(DEVICE)
    X8, H8t = Xd.to(torch.int8), st.H8.t()

    def library():
        for _ in range(iters):
            torch._int_mm(X8, H8t)

    baseline = previous_k2(st, Xd, iters)
    if baseline is not None:
        acc_b, x_b = baseline()
        acc_n, x_n = chained_score(st, Xd, iters, want_x=True)
        torch.cuda.synchronize()
        rel = abs(float(acc_b) / float(acc_n) - 1.0)
        log("k2 baseline B=%d iters=%d: X %s, checksum %r vs %r (rel %.3g)"
            % (B, iters, "bitwise equal" if torch.equal(x_b, x_n) else "DIFFERS", float(acc_b), float(acc_n), rel))
        if not torch.equal(x_b, x_n) or rel > K2_BENCH_RTOL:
            raise AssertionError("the baseline K2 and K2 disagree")
        del x_b, x_n
    plain_a = cuda_ms(lambda: chained_score_plain(st, Xd, iters), iters=1, warmup=1)
    lib_a = cuda_ms(library, iters=1, warmup=1)
    base_a = cuda_ms(baseline, iters=1, warmup=0) if baseline else None
    kern_a = cuda_ms(lambda: chained_score(st, Xd, iters), iters=1, warmup=1)
    kern_b = cuda_ms(lambda: chained_score(st, Xd, iters), iters=1, warmup=0)
    base_b = cuda_ms(baseline, iters=1, warmup=0) if baseline else None
    lib_b = cuda_ms(library, iters=1, warmup=0)
    plain_b = cuda_ms(lambda: chained_score_plain(st, Xd, iters), iters=1, warmup=0)
    kern, plain, lib = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2, (lib_a + lib_b) / 2
    rows, vp = st.H8.shape
    bnd, by = bound_ms(rows * vp + 3 * rows * 4 + 2 * B * vp * 4, 2.0 * B * rows * vp * iters)
    log("k2 time B=%d iters=%d: kernel %.3f ms (%.3f, %.3f) = %.1f candidates/s = %.1f int8 TOPS; "
        "plain %.3f ms (%.3f, %.3f); %d x torch._int_mm %.3f ms (%.3f, %.3f); bound %.3f ms (%s)"
        % (B, iters, kern, kern_a, kern_b, B * iters / kern * 1e3, 2.0 * B * rows * vp * iters / kern / 1e9,
           plain, plain_a, plain_b, iters, lib, lib_a, lib_b, bnd, by))
    if baseline:
        base = (base_a + base_b) / 2
        log("k2 time baseline B=%d iters=%d: %.3f ms (%.3f, %.3f), %.2fx the time of K2"
            % (B, iters, base, base_a, base_b, base / kern))
    del Xd, X8
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": bench_rel, "ms": kern, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bnd, "bound_by": by}


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
    before = score_rows.int8_launches
    s_b, hx_b = score_rows(st, X, want_hx=True)
    if score_rows.int8_launches != before + 1:
        raise AssertionError("batched K1 did not take its int8 path (%s)" % label)
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
    log("k1 cases int8 path %s G=%d B=32 rows=%d vp=%d: hx bitwise equal to plain, scores %s (max_abs_err %r), "
        "both bitwise equal to %d single-case calls"
        % (label, len(progs), st.H.shape[-2], st.H.shape[-1],
           "bitwise equal" if torch.equal(s_b, s_p) else "rel %.3g" % rel, err, len(progs)))
    return err


def batch_groups(paths):
    """The programs of the batch cases, grouped as `solve_device_batch`
    groups them (by interval and variable count)."""
    from ambigram_tpu_torch.engine.pipeline import extract_programs

    groups: dict = {}
    for path in paths:
        prog = extract_programs(path)[0]
        groups.setdefault((prog.start, prog.end, prog.num_vars), []).append(prog)
    return groups


def run_batch(workdir: str, paths) -> dict:
    """The batch path: four cases through the CLI's --manifest on cuda."""
    import numpy as np
    import torch

    from ambigram_tpu_torch import bench, cli
    from ambigram_tpu_torch.engine.pipeline import extract_programs
    from ambigram_tpu_torch.solver.score import reset_launch_counts, score_rows
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    manifest = os.path.join(workdir, "batch.manifest")
    with open(manifest, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    argv = ["--op", "bfb", "--manifest", "--in_lh", manifest, "--solver", "device", "--device", DEVICE, "--no-ledgers"]
    log("batch: python -m ambigram_tpu_torch.cli " + " ".join(argv))
    GLOBAL.reset()
    reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        results = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int8_launches = score_rows.launches, score_rows.int8_launches
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
    log("batch: 4 cases, wall %.3f s, %.2f cases/min, K1 launches %d (int8 path %d)"
        % (wall, 4 * 60.0 / wall, launches, int8_launches))
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
    if launches < 2 or int8_launches != launches:
        raise AssertionError("batched K1 launched %d times (%d on its int8 path), expected >= 2, all int8"
                             % (launches, int8_launches))
    return {"launches": launches, "int8_launches": int8_launches, "wall": wall}


def run_slice(lh: str) -> dict:
    import numpy as np
    import torch

    from ambigram_tpu_torch import cli
    from ambigram_tpu_torch.engine.pipeline import AUTO_EXACT_FIRST_MAX_VARS, extract_programs
    from ambigram_tpu_torch.solver.score import reset_launch_counts, score_rows
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    prog = extract_programs(lh)[0]
    if prog.num_vars <= AUTO_EXACT_FIRST_MAX_VARS:
        raise AssertionError("case has %d variables: auto would not reach the device" % prog.num_vars)
    argv = ["--op", "bfb", "--in_lh", lh, "--solver", "auto", "--device", DEVICE, "--no-ledgers"]
    log("slice: python -m ambigram_tpu_torch.cli " + " ".join(argv))
    GLOBAL.reset()
    reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int8_launches = score_rows.launches, score_rows.int8_launches
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
    log("slice: V=%d rows=%d wall %.3f s, eps %r, hard_violation %r, certified %s, K1 launches %d (int8 path %d)"
        % (prog.num_vars, prog.G.shape[0] + 2 * prog.n, wall, eps, vio, res.chromosomes[0].certified,
           launches, int8_launches))
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
    if launches < 2 or int8_launches != launches:
        raise AssertionError("K1 launched %d times in the slice (%d on its int8 path), expected >= 2, all int8"
                             % (launches, int8_launches))
    if vio != 0.0:
        raise AssertionError("solution violates hard rows: %r" % vio)
    if eps > EPS_BAR + 1e-4:
        raise AssertionError("eps %r above the bar %r" % (eps, EPS_BAR))
    return {"launches": launches, "int8_launches": int8_launches, "wall": wall}


def sass_counts(path: str) -> dict:
    """Tensor-core instructions in a library's SASS (cuobjdump), by
    mnemonic: IMMA is mma.sync on integers, [HIQ]GMMA the warpgroup
    products."""
    import re

    from ambigram_tpu_torch import kernels

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True, timeout=300).stdout
    counts: dict = {}
    for op in re.findall(r"\b([A-Z]*GMMA|IMMA)\b", sass):
        counts[op] = counts.get(op, 0) + 1
    return counts


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
    for name, wanted in (("score_rows", ("IMMA",)), ("chained_score", ("IGMMA", "HGMMA"))):
        info = kernels.BUILD_INFO[name]
        log("build: %s %.2f s in nvcc" % (name, info["seconds"]))
        if info["log"]:
            log(info["log"])
        counts = sass_counts(info["path"])
        log("sass: %s tensor-core instructions %s" % (name, json.dumps(counts, sort_keys=True)))
        if not any(counts.get(op) for op in wanted):
            raise AssertionError("no %s in the SASS of %s" % (" or ".join(wanted), name))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    log(card_line())
    log("torch %s, cuda %s, python %s" % (torch.__version__, torch.version.cuda, sys.version.split()[0]))
    build_kernels()

    from ambigram_tpu_torch.engine.pipeline import extract_programs

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        lh = simulate_case(workdir, noise=0.05)
        lh_exact = simulate_case(workdir, noise=0.0)
        prog = extract_programs(lh)[0]
        k1 = check_k1({"noise0.05": prog, "noise0": extract_programs(lh_exact)[0]})
        sl = run_slice(lh)
        k2 = check_k2()
        from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

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
                "bound_ms": k1["bound_ms"],
                "bound_by": k1["bound_by"],
                "library_ms": k1["library_ms"],
                "int8_launches": sl["int8_launches"] + batch["int8_launches"],
                "ms_b1000": k1["ms_b1000"],
                "f32_path_ms": k1["f32_path_ms"],
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
                "bound_ms": k2["bound_ms"],
                "bound_by": k2["bound_by"],
                "library_ms": k2["library_ms"],
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
