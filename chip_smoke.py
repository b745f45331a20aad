"""Smoke run of the PyTorch/CUDA port (ambigram_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

It runs these phases in order; a failure in any of them exits non-zero
and prints no result line:

1. the card: nvidia-smi's name and power limit; a CUDA device must exist;
2. build every kernel of the port's paths from csrc/ (nvcc, sm_90a), one
   nvcc per source, all started together; ptxas's register and spill
   report (K1's f32 kernels must spill nothing), and the tensor-core
   instructions in each library's SASS (cuobjdump), which must be there;
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
9. K1 on the tensors of a single-cell block program (K=3 clones, S=32,
   seed 3 of `simulate_sc_case`, chain; Rows 13056, Vp 3200, coupling
   rows included), on its int8 path, at B=32 and B=1000: hx and scores
   bitwise equal to the plain version (integer targets); then its times
   beside the plain version, `torch.matmul` and the bound, as in phase 3;
10. the single-cell slice: that sample through `python -m
   ambigram_tpu_torch.cli --op sc_bfb --edges <its evolution edges>
   --solver auto` on cuda, in process. Its block program has 3168
   variables, so auto sends it to the device search; the run must launch
   K1 only on its int8 path, reach the host MILP's optimum (eps <= 8.0
   + 1e-4, read from the solution the CLI replayed) with hard violation
   0, and recover each clone's simulated truth (`multiplicity_diff` 0);
11. K1 with a case axis on the block programs of seeds 3 and 4 (K=3,
   S=32), stacked as the `sc:` manifest below stacks them (rows padded
   with w = 0), on its int8 path at B=32: hx and scores bitwise equal
   to the plain per-case loop (integer targets) and to one single-case
   call per case;
12. an `sc:` manifest of seeds 3 and 4 (K=3, S=32) through `python -m
   ambigram_tpu_torch.cli --op bfb --manifest --solver device` on cuda:
   both block programs search as one case-stacked group, batched K1
   launches on its int8 path, and every clone prints a path from a
   solution with hard violation 0;
13. K1's two-plane int8 path at the bench's S=96 shape: the tensors of
   the seed-396 case of the bench's big leg (S=96, 6 rounds, noise 0.05;
   Rows 32512, Vp 9344, x_ub_max 821.8, so the candidates take two u8
   planes, and the row values reach 92% of 2^24), at B=32 and B=1000:
   hx bitwise equal to the plain version and the scores within rtol
   1e-5; on its noise-free twin (also two planes) the scores bitwise
   equal too; then its times beside the plain version, `torch.matmul`
   and the bound (both planes' operations counted), as in phase 3;
14. the S=64 slice: the seed-364 case of the big leg (V 4160, one u8
   plane) through `python -m ambigram_tpu_torch.cli --op bfb --solver
   auto` on cuda, in process: auto sends it to the device search; the
   run must print a path, launch K1 only on its int8 path, and reach
   hard violation 0 with eps <= 3.78 (two decimals), the JAX device
   search's value (docs/bench_big.json);
15. the port's golden suite, `python -m
   ambigram_tpu_torch.scripts.golden_suite --solver device --device
   cuda`, in process: every check ok, and K1 launched;
16. the sharded search step (`parallel.mesh.sharded_step`) on the bench
   batch's S=32 seed-200 program and its noise-free twin, stacked as two
   cases, pop 32 and all 2 Vp + 1 = 2305 moves: one step on a logical
   (2, 2) mesh of the card (two case slots, two row shards each) and on
   (1, 1), against the same step with K1's plain version: X' and the
   scores bitwise equal on the twin, the scores within rtol 1e-5 on the
   noisy case, every row-shard launch of K1 on its int8 path; the ms per
   step and the peak device memory; then K1's time at one row shard's
   launch (73,760 candidates, half the rows) beside its plain version,
   `torch.matmul` and the bound;
17. `solve_cases_sharded` on the bench proxy leg's 8 cases (S=16, seeds
   400-407, noise 0) at its budgets (pop 8, 12 steps, 2 rounds) over
   logical meshes (1,1), (1,2), (2,2) and (4,2) of the card: best_x
   identical across meshes, eps_sum and seconds per mesh;
18. `run_bfb_many(solver="device")` on phase 8's four cases under a
   logical (2, 2) mesh (two case slots): the two S=32 programs through
   the stacked sharded pass, the two S=48 programs through per-case
   searches round-robin over the mesh; every case prints a path whose
   solution has hard violation 0;
19. with two cards or more, phases 16 and 17 over distinct cards, equal
   to the same mesh shape on one card; with one card a line says the
   phase was skipped;
20. K1's f32 path at S=128: (a) the big leg's recipe at S=128 (seed
   428, 6 rounds, noise 0.05; V 16512, Rows 57600, Vp 16512) and its
   noise-free twin, both int8-exact but past the int8 gate's box bound
   (2.59 of 2^24), so `k1_planes` is 0; (b) K1 on both at B=32 and
   B=1000: hx bitwise equal to the plain version, the scores bitwise on
   the twin and within rtol 1e-5 on the noisy case; (c) its times beside
   the plain version, `torch.matmul` and the bound, as in phase 3; (d) a
   bounded device search on the noisy program (`solve_device`, one
   round, one sweep, no polish, no certificate): at least two K1
   launches, all on its f32 path, and an integral x inside [0, x_ub].
   The S=128 tensors (the f32 H and its transpose, 7.6 GB) are released
   after it;
21. a JSON line describing the kernels, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Every launch count in the kernels line comes from the main paths (the
slice, the chain leg, the manifest, the single-cell slice, the sc:
manifest, the S=64 slice, the golden suite, the sharded solves of phase
17, the mesh batch of phase 18 and the S=128 search of phase 20), each
driven with the counts set to 0 just before it and read just after; the
row-shard entry counts phase 17's launches, every one of which is a row
shard's, and the f32 block of the K1 entry phase 20's.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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
SC = dict(n_clones=3, n_segments=32)  # single-cell samples: K=3 clones, S=32, chain
SC_SLICE_SEED = 3
SC_MANIFEST_SEEDS = (3, 4)
SC_EPS_BAR = 8.0  # the host MILP's optimum (HiGHS) on the seed-3 block program
S64_EPS_BAR = 3.78  # the JAX device search at S=64, two decimals (docs/bench_big.json)
S128 = 128  # the big leg's recipe at the first S whose cases take K1's f32 path
DEVICE = "cuda"
BATCH_S32 = dict(seed=200, n_segments=32, rounds=5, mode="process")  # case 0 of the bench's batch
PROXY_BUDGETS = dict(pop=8, steps=12, rounds=2)  # the bench proxy leg's shard budgets
PROXY_MESHES = ((1, 1), (1, 2), (2, 2), (4, 2))
# NVIDIA H100 SXM data sheet (dense, at 700 W): the bounds' peaks
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores (K1's f32 path is FFMA)
L2_FLUSH_BYTES = 128 << 20  # more than the card's 50 MB L2
HOST_LEAD_CYCLES = 1_000_000  # about 0.5 ms of spin, longer than the host takes to queue a call


def log(*parts) -> None:
    print(*parts, flush=True)


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


def bound_ms(bytes_moved: float, ops: float, ops_per_s: float = INT8_OPS_PER_S):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(st, B: int, planes: int = 1, want_hx: bool = True):
    """K1 at one case: the rows and the row vectors read once, X read
    once, hx (when asked for) and the scores written once. On the int8
    path (planes >= 1) the rows are H8, one byte each, and each u8 plane
    of the candidates costs 2 B Rows Vp int8 operations; on the f32 path
    (planes 0) the rows are H, four bytes each, and the product is
    2 B Rows Vp f32 operations outside the tensor cores."""
    rows, vp = st.H8.shape[-2:]
    bytes_moved = rows * vp * (4 if planes == 0 else 1) + 3 * rows * 4 + B * vp * 4 + B * 4
    if want_hx:
        bytes_moved += B * rows * 4
    if planes == 0:
        return bound_ms(bytes_moved, 2.0 * B * rows * vp, F32_OPS_PER_S)
    return bound_ms(bytes_moved, 2.0 * planes * B * rows * vp)


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


def time_k1(label, st, X_pop, path, planes: int = 1, iters: int = 20, host_iters: int = 200):
    """Times at B=32 and B=1000, each after an L2 flush: K1, its plain
    version and one torch.matmul(X, H.T) in f32 (the library call for
    the product alone), each the mean of `iters` runs, and the host time
    to queue a call over `host_iters` calls; {B: (kernel, plain,
    library, bound, bound_by)}."""
    import torch

    from ambigram_tpu_torch.solver.score import score_rows, score_rows_plain

    out = {}
    warmup = min(3, iters)
    for B in (32, 1000):
        X = torch.as_tensor(X_pop[:B]).to(DEVICE)
        H = st.H
        plain_a = cuda_ms_cold(lambda: score_rows_plain(st, X, want_hx=True), iters, warmup)
        lib_a = cuda_ms_cold(lambda: torch.matmul(X, H.t()), iters, warmup)
        kern_a = cuda_ms_cold(lambda: score_rows(st, X, want_hx=True), iters, warmup)
        kern_b = cuda_ms_cold(lambda: score_rows(st, X, want_hx=True), iters, warmup)
        lib_b = cuda_ms_cold(lambda: torch.matmul(X, H.t()), iters, warmup)
        plain_b = cuda_ms_cold(lambda: score_rows_plain(st, X, want_hx=True), iters, warmup)
        warm = cuda_ms(lambda: score_rows(st, X, want_hx=True), iters, warmup)
        host_k = host_us(lambda: score_rows(st, X, want_hx=True), host_iters)
        host_l = host_us(lambda: torch.matmul(X, H.t()), host_iters)
        kern, plain, lib = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2, (lib_a + lib_b) / 2
        bnd, by = k1_bound(st, B, 0 if path == "f32" else planes)
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
        "plain_ms_b1000": timing[1000][1],
        "library_ms_b1000": timing[1000][2],
        "f32_path": {
            "ms": f32_timing[32][0],
            "plain_ms": f32_timing[32][1],
            "library_ms": f32_timing[32][2],
            "bound_ms": f32_timing[32][3],
            "bound_by": f32_timing[32][4],
            "ms_b1000": f32_timing[1000][0],
            "plain_ms_b1000": f32_timing[1000][1],
            "library_ms_b1000": f32_timing[1000][2],
            "bound_ms_b1000": f32_timing[1000][3],
            "bound_by_b1000": f32_timing[1000][4],
        },
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


def check_k1_cases(label: str, progs, exact: bool = False) -> float:
    """K1 with a case axis on a stacked group, at the search's
    population (B=32): hx bitwise equal to the plain per-case loop and
    the scores within K1_RTOL of it (noisy cases: fractional targets
    round in another order), or bitwise equal when `exact` (integer
    targets), and both bitwise equal to one single-case call per case.
    Returns the largest score difference from plain."""
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
    if exact and not torch.equal(s_b, s_p):
        raise AssertionError("batched K1 scores not bitwise equal to plain (%s): %g" % (label, err))
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


def log_phases(names) -> None:
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    for name in names:
        st = GLOBAL.phases.get(name)
        log("phase %-15s %.3f s x%d" % (name, st.seconds if st else 0.0, st.calls if st else 0))
    for name in sorted(GLOBAL.counters):
        log("counter %-22s %r" % (name, GLOBAL.counters[name]))


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
    log_phases(("solve.tensors", "solve.lp_bound", "score", "solve.lns", "solve.exact", "replay"))
    if max(violations) != 0.0:
        raise AssertionError("a batch solution violates hard rows: %r" % violations)
    calls = GLOBAL.counters.get("solve.device_calls", 0.0)
    if calls != 2:
        raise AssertionError("expected two case-stacked searches, got %r device calls" % calls)
    if launches < 2 or int8_launches != launches:
        raise AssertionError("batched K1 launched %d times (%d on its int8 path), expected >= 2, all int8"
                             % (launches, int8_launches))
    return {"launches": launches, "int8_launches": int8_launches, "wall": wall}


def run_slice(lh: str, label: str = "slice", eps_bar: float = EPS_BAR, two_decimals: bool = False) -> dict:
    """One case through the CLI's --op bfb --solver auto on cuda: the
    device search must run, K1 launch only on its int8 path, a path be
    printed, and the replayed solution reach hard violation 0 with eps at
    most `eps_bar` (+1e-4, or after rounding to two decimals)."""
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
    log(label + ": python -m ambigram_tpu_torch.cli " + " ".join(argv))
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
    log("%s: V=%d rows=%d wall %.3f s, eps %r, hard_violation %r, certified %s, K1 launches %d (int8 path %d)"
        % (label, prog.num_vars, prog.G.shape[0] + 2 * prog.n, wall, eps, vio, res.chromosomes[0].certified,
           launches, int8_launches))
    log("%s: path %s" % (label, path))
    log_phases(("solve.tensors", "solve.lp_bound", "score", "solve.lns", "solve", "replay"))
    score_s = GLOBAL.phases["score"].seconds if "score" in GLOBAL.phases else 0.0
    if score_s:
        log("candidates_scored / score phase: %.1f per s" % (GLOBAL.counters.get("candidates_scored", 0.0) / score_s))
    if calls < 1:
        raise AssertionError("the device search never ran (solve.device_calls = %r)" % calls)
    if launches < 2 or int8_launches != launches:
        raise AssertionError("K1 launched %d times in the %s (%d on its int8 path), expected >= 2, all int8"
                             % (launches, label, int8_launches))
    if vio != 0.0:
        raise AssertionError("solution violates hard rows: %r" % vio)
    if (round(eps, 2) > eps_bar) if two_decimals else (eps > eps_bar + 1e-4):
        raise AssertionError("%s: eps %r above the bar %r" % (label, eps, eps_bar))
    return {"launches": launches, "int8_launches": int8_launches, "wall": wall}


def sc_sample(workdir: str, seed: int):
    """The clone files of one single-cell sample; returns (ScCase, clone
    paths, the --edges string of its evolution DAG)."""
    from ambigram_tpu_torch.scripts.simulate import simulate_sc_case, write_sc_clones

    sc = simulate_sc_case(seed=seed, **SC)
    d = os.path.join(workdir, "sc_seed%d" % seed)
    os.makedirs(d, exist_ok=True)
    return (sc, *write_sc_clones(sc, os.path.join(d, "c")))


def sc_block_program(names, edges):
    from ambigram_tpu_torch.engine.sc import extract_sc_programs

    progs = [p for p in extract_sc_programs(",".join(names), edges) if p is not None]
    if len(progs) != 1:
        raise AssertionError("expected one block program, got %d" % len(progs))
    return progs[0]


def check_k1_block(prog) -> dict:
    """K1 on the block program's tensors (coupling rows included), on its
    int8 path: hx and scores bitwise equal to plain at B=32 and B=1000,
    then its times; returns the kernels-line numbers of this shape."""
    import torch

    from ambigram_tpu_torch.solver.score import k1_planes, scoring_tensors

    st = scoring_tensors(prog, DEVICE)
    if k1_planes(st) != 1 or prog.num_coupling == 0:
        raise AssertionError("the block program should take K1's one-plane int8 path with coupling rows")
    label = "sc block K=%d S=%d seed %d" % (SC["n_clones"], SC["n_segments"], SC_SLICE_SEED)
    pop = population(prog, st.x_ub.cpu().numpy(), 1000, seed=2)
    err = check_k1_case(label, st, {"population": pop}, "population", "int8")
    timing = time_k1(label, st, pop, "int8")
    del st
    torch.cuda.empty_cache()
    kern, plain, lib, bnd, by = timing[32]
    return {"max_abs_err": err, "ms": kern, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
            "bound_by": by, "ms_b1000": timing[1000][0], "plain_ms_b1000": timing[1000][1],
            "library_ms_b1000": timing[1000][2]}


@contextlib.contextmanager
def spy(module, name: str, record: list):
    """Replace module.name by a wrapper that appends (args, result) of
    every call to `record`."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        record.append((args, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield record
    finally:
        setattr(module, name, fn)


def run_sc_slice(workdir: str) -> dict:
    """The single-cell slice through the CLI's --op sc_bfb on cuda; the
    solution the CLI replayed is read through a spy on pipeline._solve."""
    import numpy as np
    import torch

    from ambigram_tpu_torch import cli
    from ambigram_tpu_torch.engine import pipeline
    from ambigram_tpu_torch.scripts.evaluate import multiplicity_diff
    from ambigram_tpu_torch.solver.score import reset_launch_counts, score_rows
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    sc, names, edges = sc_sample(workdir, SC_SLICE_SEED)
    prog = sc_block_program(names, edges)
    if prog.num_vars <= pipeline.AUTO_EXACT_FIRST_MAX_VARS:
        raise AssertionError("block program has %d variables: auto would not reach the device" % prog.num_vars)
    argv = ["--op", "sc_bfb", "--in_lh", ",".join(names), "--edges", edges, "--solver", "auto", "--device", DEVICE,
            "--no-ledgers"]
    log("sc slice: python -m ambigram_tpu_torch.cli " + " ".join(argv))
    buf = io.StringIO()
    with spy(pipeline, "_solve", []) as solved:
        GLOBAL.reset()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = cli.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, int8_launches, f32_launches = score_rows.launches, score_rows.int8_launches, score_rows.f32_launches
    if res is None or len(solved) != 1:
        raise AssertionError("the CLI returned %r after %d solves" % (res, len(solved)))
    sol = solved[0][1]
    x = np.asarray(sol.x, dtype=np.float64)
    eps, vio = float(prog.residual_objective(x)), float(prog.hard_violation(x))
    lines = buf.getvalue().splitlines()
    diffs = [multiplicity_diff(case.truth_string, res.path_strings[k][0] if res.path_strings[k] else "")
             for k, case in enumerate(sc.cases)]
    calls = GLOBAL.counters.get("solve.device_calls", 0.0)
    log("sc slice: V=%d rows=%d coupling=%d wall %.3f s, status %s, eps %r, hard_violation %r, "
        "K1 launches %d (int8 path %d, f32 path %d), multiplicity_diff per clone %r"
        % (prog.num_vars, prog.G.shape[0] + 2 * prog.n + prog.num_coupling, prog.num_coupling, wall, sol.status,
           eps, vio, launches, int8_launches, f32_launches, diffs))
    log_phases(("solve.tensors", "solve.lp_bound", "score", "solve.lns", "solve", "replay"))
    for k, paths in enumerate(res.path_strings):
        if not paths or not all(p and p in lines for p in paths):
            raise AssertionError("clone %d printed no path" % k)
    if calls < 1:
        raise AssertionError("the device search never ran (solve.device_calls = %r)" % calls)
    if int8_launches < 1 or f32_launches != 0 or int8_launches != launches:
        raise AssertionError("K1 launched %d times in the sc slice (%d int8, %d f32), expected >= 1, all int8"
                             % (launches, int8_launches, f32_launches))
    if vio != 0.0:
        raise AssertionError("sc solution violates hard rows: %r" % vio)
    if eps > SC_EPS_BAR + 1e-4:
        raise AssertionError("sc eps %r above the bar %r" % (eps, SC_EPS_BAR))
    if any(diffs):
        raise AssertionError("a clone's path misses its simulated truth: %r" % diffs)
    return {"launches": launches, "int8_launches": int8_launches, "wall": wall}


def run_sc_manifest(workdir: str) -> dict:
    """Two single-cell samples through the CLI's --manifest on cuda: one
    case-stacked search of both block programs."""
    import numpy as np
    import torch

    from ambigram_tpu_torch import cli
    from ambigram_tpu_torch.engine import pipeline
    from ambigram_tpu_torch.scripts.evaluate import multiplicity_diff
    from ambigram_tpu_torch.solver import search
    from ambigram_tpu_torch.solver.score import reset_launch_counts, score_rows
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    samples = [sc_sample(workdir, seed) for seed in SC_MANIFEST_SEEDS]
    manifest = os.path.join(workdir, "sc.manifest")
    with open(manifest, "w") as f:
        f.write("".join("sc:%s edges=%s\n" % (",".join(names), edges) for _, names, edges in samples))
    argv = ["--op", "bfb", "--manifest", "--in_lh", manifest, "--solver", "device", "--device", DEVICE, "--no-ledgers"]
    log("sc manifest: python -m ambigram_tpu_torch.cli " + " ".join(argv))
    buf = io.StringIO()
    with spy(pipeline, "solve_programs_batch", []) as batches, spy(search, "_dispatch", []) as groups:
        GLOBAL.reset()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            results = cli.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, int8_launches = score_rows.launches, score_rows.int8_launches
    if not results or len(results) != len(samples) or len(batches) != 1:
        raise AssertionError("the sc manifest run returned %r" % (results,))
    (flat, index), solutions = batches[0][0][:2], batches[0][1]
    lines = buf.getvalue().splitlines()
    for prog, key in zip(flat, index):
        x = np.asarray(solutions[key].x, dtype=np.float64)
        sc = samples[key[0]][0]
        res = results[key[0]]
        diffs = [multiplicity_diff(case.truth_string, res.path_strings[k][0] if res.path_strings[k] else "")
                 for k, case in enumerate(sc.cases)]
        vio = float(prog.hard_violation(x))
        log("sc manifest sample seed %d: V=%d status %s, eps %r, hard_violation %r, multiplicity_diff per clone %r"
            % (SC_MANIFEST_SEEDS[key[0]], prog.num_vars, solutions[key].status, float(prog.residual_objective(x)),
               vio, diffs))
        if vio != 0.0:
            raise AssertionError("an sc manifest solution violates hard rows: %r" % vio)
        for k, paths in enumerate(res.path_strings):
            if not paths or not all(p and p in lines for p in paths):
                raise AssertionError("sample %d clone %d printed no path" % (key[0], k))
    sizes = [len(args[0]) for args, _ in groups]
    log("sc manifest: %d samples, wall %.3f s, case-stacked groups %r, K1 launches %d (int8 path %d)"
        % (len(samples), wall, sizes, launches, int8_launches))
    log_phases(("solve.tensors", "solve.lp_bound", "score", "solve.lns", "replay"))
    if sizes != [len(samples)] or GLOBAL.counters.get("solve.device_calls", 0.0) != 1:
        raise AssertionError("expected one case-stacked group of %d, got %r" % (len(samples), sizes))
    if launches < 1 or int8_launches != launches:
        raise AssertionError("batched K1 launched %d times (%d on its int8 path), expected >= 1, all int8"
                             % (launches, int8_launches))
    return {"launches": launches, "int8_launches": int8_launches, "wall": wall}


def run_s64_slice(workdir: str) -> dict:
    """The S=64 case of the big leg through the CLI on cuda: one u8
    plane, K1's int8 path only, eps <= 3.78 (two decimals)."""
    from ambigram_tpu_torch.bench import big_case_path
    from ambigram_tpu_torch.engine.pipeline import extract_programs
    from ambigram_tpu_torch.solver.score import k1_planes, scoring_tensors

    lh = big_case_path(workdir, 64)
    planes = k1_planes(scoring_tensors(extract_programs(lh)[0], "cpu", need_f32=False))
    if planes != 1:
        raise AssertionError("the S=64 case should take K1's one-plane int8 path, got %d" % planes)
    return run_slice(lh, label="S=64 slice", eps_bar=S64_EPS_BAR, two_decimals=True)


def check_k1_two_planes(workdir: str) -> dict:
    """K1 on the S=96 case of the big leg, on its two-plane int8 path:
    hx bitwise equal to plain and the scores within K1_RTOL at B=32 and
    B=1000, bitwise on the noise-free twin; then its times. Returns the
    kernels-line numbers of this shape."""
    import torch

    from ambigram_tpu_torch.bench import big_case_path
    from ambigram_tpu_torch.engine.pipeline import extract_programs
    from ambigram_tpu_torch.solver.score import k1_planes, scoring_tensors

    out = {}
    for noise in (0.0, 0.05):
        prog = extract_programs(big_case_path(workdir, 96, noise))[0]
        st = scoring_tensors(prog, DEVICE)
        planes = k1_planes(st)
        log("k1 two planes S=96 noise %g: V=%d rows=%d vp=%d x_ub_max %r max|H8| %d, row-value bound %.4f of 2^24, "
            "%d planes" % (noise, prog.num_vars, st.H8.shape[0], st.H8.shape[1], st.x_ub_max, st.h8_absmax(),
                           math.ceil(st.x_ub_max) * st.h8_absmax() * st.H8.shape[1] / 2**24, planes))
        if planes != 2:
            raise AssertionError("the S=96 case (noise %g) should take K1's two-plane int8 path, got %d" % (noise, planes))
        label = "S=96 seed 396 noise%g" % noise
        pop = population(prog, st.x_ub.cpu().numpy(), 1000, seed=2)
        err = check_k1_case(label, st, {"population": pop}, "population" if noise == 0.0 else None, "int8")
        if noise > 0.0:
            timing = time_k1(label, st, pop, "int8", planes=2)
            kern, plain, lib, bnd, by = timing[32]
            out = {"max_abs_err": err, "ms": kern, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
                   "bound_by": by, "ms_b1000": timing[1000][0], "plain_ms_b1000": timing[1000][1],
                   "library_ms_b1000": timing[1000][2], "bound_ms_b1000": timing[1000][3], "planes": planes}
        del st
        torch.cuda.empty_cache()
    return out


def run_golden_suite() -> dict:
    """The port's golden suite with the device search on cuda, through
    its command line, in process: every check ok, and K1 launched."""
    import torch

    from ambigram_tpu_torch.scripts import golden_suite
    from ambigram_tpu_torch.solver.score import reset_launch_counts, score_rows

    argv = ["--solver", "device", "--device", DEVICE]
    log("golden suite: python -m ambigram_tpu_torch.scripts.golden_suite " + " ".join(argv))
    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = golden_suite.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int8_launches = score_rows.launches, score_rows.int8_launches
    report = json.loads(buf.getvalue())
    for c in report["checks"]:
        log("golden suite %-16s ok %s %.3f s %s" % (c["name"], c["ok"], c["seconds"], c["detail"][-80:].replace("\n", " ")))
    log("golden suite: %d checks, wall %.3f s, K1 launches %d (int8 path %d)"
        % (len(report["checks"]), wall, launches, int8_launches))
    if rc != 0 or not report["ok"] or len(report["checks"]) != 16:
        raise AssertionError("the golden suite failed on the device search: rc %d" % rc)
    if launches < 1:
        raise AssertionError("the golden suite's device search never launched K1")
    return {"launches": launches, "int8_launches": int8_launches, "wall": wall}


@contextlib.contextmanager
def substitute(module, name: str, fn):
    """Replace module.name by fn for the duration."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def logical_mesh(shape):
    """A (case, model) mesh of that shape whose every shard is the one card."""
    import torch

    from ambigram_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(case_axis=shape[0], devices=[torch.device(DEVICE, 0)] * (shape[0] * shape[1]))


def step_inputs(workdir: str):
    """Phase 16's input: the bench batch's S=32 seed-200 program (noise
    0.05) and its noise-free twin stacked as two cases, and a pool of 32
    search-like candidates for each."""
    import numpy as np

    from ambigram_tpu_torch.engine.pipeline import extract_programs
    from ambigram_tpu_torch.parallel.mesh import stack_cases
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

    progs = []
    for noise in (0.05, 0.0):
        case = simulate_bfb_case(noise=noise, **BATCH_S32)
        progs.append(extract_programs(write_case(case, os.path.join(workdir, "b32_noise%g" % noise))["lh"])[0])
    st = stack_cases(progs)
    x_ub = st.x_ub.numpy()
    X = np.stack([population(p, x_ub[g], 32, seed=g) for g, p in enumerate(progs)])
    return progs, st, X


def run_step(st, X, mesh, plain: bool = False, reps: int = 3):
    """One sharded step on `mesh` from X, `reps` times on the same input:
    (X', scores, ms per step, peak device bytes, K1 launches per step by
    path). With `plain` the row shards score through K1's plain version."""
    import torch

    from ambigram_tpu_torch.parallel import mesh as mesh_mod
    from ambigram_tpu_torch.solver.score import reset_launch_counts, score_rows, score_rows_plain

    cases = mesh_mod.shard_cases(st, mesh)
    step = mesh_mod.sharded_step(mesh)
    Xj = cases.put(X)
    scorer = (lambda shard, Xs: score_rows_plain(shard, Xs.contiguous())[0]) if plain else mesh_mod._local_score
    with substitute(mesh_mod, "_local_score", scorer):
        Xo, So = step(cases, Xj)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(reps):
            Xo, So = step(cases, Xj)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
    launches = (score_rows.launches // reps, score_rows.int8_launches // reps)
    peak = torch.cuda.max_memory_allocated()
    return cases.gather(Xo), cases.gather(So), ms, peak, launches


def check_sharded_step(workdir: str) -> dict:
    """Phase 16: one step of the sharded search on a logical (2, 2) mesh
    of the card and on (1, 1), all 2 Vp + 1 moves, pop 32: X' and the
    scores bitwise equal across meshes and to the plain version on the
    noise-free twin, the scores within K1_RTOL on the noisy case; every
    row-shard launch of K1 on its int8 path. Then K1's time at one row
    shard's launch beside its plain version, torch.matmul and the bound.
    Returns the kernels-line numbers of the row shards."""
    import numpy as np
    import torch

    from ambigram_tpu_torch.parallel.mesh import shard_cases
    from ambigram_tpu_torch.solver.score import k1_planes, score_rows, score_rows_plain

    progs, st, X = step_inputs(workdir)
    vp = st.H.shape[-1]
    log("step: V=%d rows=%d vp=%d moves=%d pop=%d: %d candidates per case per step"
        % (progs[0].num_vars, st.H.shape[-2], vp, 2 * vp + 1, X.shape[1], X.shape[1] * (2 * vp + 1)))
    runs = {}
    for label, shape, plain in (("(2, 2)", (2, 2), False), ("(1, 1)", (1, 1), False), ("(1, 1) plain", (1, 1), True)):
        Xo, So, ms, peak, (launches, int8_launches) = run_step(st, X, logical_mesh(shape), plain=plain)
        runs[label] = (Xo, So)
        log("step %s: %.3f ms per step, peak %.1f MB allocated, K1 launches per step %d (int8 path %d), "
            "members moved %d of %d"
            % (label, ms, peak / 2**20, launches, int8_launches, int((Xo != X).any(axis=2).sum()), X.shape[0] * X.shape[1]))
        if not plain and (launches == 0 or int8_launches != launches):
            raise AssertionError("the step's row shards launched K1 %d times, %d on its int8 path" % (launches, int8_launches))
    err = 0.0
    ref_X, ref_S = runs["(1, 1) plain"]
    for label in ("(2, 2)", "(1, 1)"):
        Xo, So = runs[label]
        for g, name in ((1, "twin"), (0, "noisy")):
            same_x, same_s = np.array_equal(Xo[g], ref_X[g]), np.array_equal(So[g], ref_S[g])
            rel = float((np.abs(So[g] - ref_S[g]) / np.maximum(np.abs(ref_S[g]), 1.0)).max())
            log("step %s %s case: X' %s, scores %s against the plain (1, 1) step"
                % (label, name, "bitwise equal" if same_x else "DIFFERS",
                   "bitwise equal" if same_s else "rel %.3g" % rel))
            if name == "twin" and not (same_x and same_s):
                raise AssertionError("the step on %s is not bitwise on the noise-free twin" % label)
            if rel > K1_RTOL:
                raise AssertionError("the step's scores on %s are off by rel %g (%s)" % (label, rel, name))
            if name == "noisy":
                err = max(err, float(np.abs(So[g] - ref_S[g]).max()))
    if not (np.array_equal(runs["(2, 2)"][0][1], runs["(1, 1)"][0][1])
            and np.array_equal(runs["(2, 2)"][1][1], runs["(1, 1)"][1][1])):
        raise AssertionError("the (2, 2) and (1, 1) steps differ on the twin")

    # K1 at the launch a row shard of the (2, 2) mesh makes: one case, the
    # candidates of all moves of its pool, half the rows
    shard = shard_cases(st, logical_mesh((2, 2))).shards[0][0]
    moves = np.concatenate([np.zeros((1, vp), np.float32), np.eye(vp, dtype=np.float32), -np.eye(vp, dtype=np.float32)])
    x_ub = st.x_ub[0].numpy()
    cand = torch.as_tensor(np.clip(X[0][:, None, :] + moves[None], 0.0, x_ub)).reshape(1, -1, vp).to(DEVICE)
    del moves
    B = cand.shape[1]
    if k1_planes(shard) != 1:
        raise AssertionError("the row shard should take K1's one-plane int8 path")
    s_k, _ = score_rows(shard, cand)
    s_p, _ = score_rows_plain(shard, cand)
    torch.cuda.synchronize()
    rel = float(((s_k - s_p).abs() / s_p.abs().clamp(min=1.0)).max())
    shard_err = float((s_k - s_p).abs().max())
    if rel > K1_RTOL:
        raise AssertionError("K1 on the row shard is off its plain version by rel %g" % rel)
    H = shard.H[0]
    kern = cuda_ms(lambda: score_rows(shard, cand), iters=10)
    plain = cuda_ms(lambda: score_rows_plain(shard, cand), iters=10)
    lib = cuda_ms(lambda: torch.matmul(cand[0], H.t()), iters=10)
    bnd, by = k1_bound(shard, B, 1, want_hx=False)
    log("k1 row shard B=%d rows=%d vp=%d: scores %s (max_abs_err %r); kernel %.4f ms, plain %.4f ms, "
        "torch.matmul f32 %.4f ms, bound %.4f ms (%s)"
        % (B, H.shape[0], vp, "bitwise equal" if torch.equal(s_k, s_p) else "rel %.3g" % rel, shard_err, kern, plain,
           lib, bnd, by))
    del cand, s_k, s_p
    torch.cuda.empty_cache()
    return {"max_abs_err": max(err, shard_err), "ms": kern, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
            "bound_by": by, "shape": [1, B, H.shape[0], vp]}


def proxy_programs(workdir: str):
    """The programs of the bench proxy leg's 8 cases, as its script reads
    them (every .lh file of the directory, sorted)."""
    import glob

    from ambigram_tpu_torch.bench import proxy_case_dir
    from ambigram_tpu_torch.engine.pipeline import extract_programs

    d = os.path.join(workdir, "proxy")
    os.makedirs(d, exist_ok=True)
    proxy_case_dir(d)
    return [p for lh in sorted(glob.glob(os.path.join(d, "*.lh"))) for p in extract_programs(lh) if p is not None]


def run_sharded_solve(progs, meshes) -> dict:
    """`solve_cases_sharded` on the programs at the proxy's budgets over
    each mesh: one best_x across meshes; returns {mesh label: (best_x,
    seconds, K1 launches, int8 launches)}."""
    import numpy as np
    import torch

    from ambigram_tpu_torch.parallel.mesh import solve_cases_sharded
    from ambigram_tpu_torch.solver.score import reset_launch_counts, score_rows

    out = {}
    for label, mesh in meshes:
        reset_launch_counts()
        t0 = time.perf_counter()
        best = solve_cases_sharded(progs, mesh=mesh, **PROXY_BUDGETS)
        for d in set(mesh.flat()):
            torch.cuda.synchronize(d)
        secs = time.perf_counter() - t0
        out[label] = (best, secs, score_rows.launches, score_rows.int8_launches)
        eps = sum(float(p.residual_objective(x.astype(np.float64))) for p, x in zip(progs, best))
        vio = max(float(p.hard_violation(x.astype(np.float64))) for p, x in zip(progs, best))
        log("sharded solve %s mesh %s: %d cases, %.3f s, eps_sum %r, max hard_violation %r, K1 launches %d (int8 path %d)"
            % (label, mesh.shape, len(progs), secs, eps, vio, score_rows.launches, score_rows.int8_launches))
    first = next(iter(out.values()))[0]
    for label, (best, *_rest) in out.items():
        if not all(np.array_equal(a, b) for a, b in zip(first, best)):
            raise AssertionError("best_x on %s differs from %s" % (label, next(iter(out))))
    return out


def run_proxy_meshes(workdir: str) -> dict:
    """Phase 17: `solve_cases_sharded` on the proxy's 8 cases (S=16,
    seeds 400-407) at budgets 8/12/2 over logical meshes (1,1), (1,2),
    (2,2) and (4,2) of the card: best_x identical across meshes, every K1
    launch on its int8 path."""
    progs = proxy_programs(workdir)
    out = run_sharded_solve(progs, [(str(shape), logical_mesh(shape)) for shape in PROXY_MESHES])
    launches = sum(v[2] for v in out.values())
    int8_launches = sum(v[3] for v in out.values())
    if launches == 0 or int8_launches != launches:
        raise AssertionError("the sharded solves launched K1 %d times, %d on its int8 path" % (launches, int8_launches))
    return {"launches": launches, "int8_launches": int8_launches, "wall": sum(v[1] for v in out.values())}


def run_mesh_batch(workdir: str, paths) -> dict:
    """Phase 18: `run_bfb_many(--solver device)` on the four batch cases
    of phase 8 under a logical mesh with two case slots ((2, 2) of the
    card): the two S=32 programs go through the stacked sharded pass
    `_solve_stacked`, the two S=48 programs through per-case searches
    round-robin over the mesh's devices; every case prints a path whose
    solution has hard violation 0."""
    import numpy as np
    import torch

    from ambigram_tpu_torch import bench
    from ambigram_tpu_torch.engine import pipeline
    from ambigram_tpu_torch.engine.pipeline import extract_programs
    from ambigram_tpu_torch.solver import search
    from ambigram_tpu_torch.solver.score import reset_launch_counts, score_rows
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    mesh = logical_mesh((2, 2))
    buf = io.StringIO()
    log("mesh batch: run_bfb_many(%d cases, solver='device', mesh=%s of %s)" % (len(paths), mesh.shape, DEVICE))
    with spy(pipeline, "_solve_stacked", []) as stacked, spy(search, "solve_device", []) as singles:
        GLOBAL.reset()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = pipeline.run_bfb_many(paths, solver="device", device=DEVICE, mesh=mesh, out=buf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, int8_launches = score_rows.launches, score_rows.int8_launches
    lines = buf.getvalue().splitlines()
    violations = bench.case_violations(paths, results)
    for path, r in zip(paths, results):
        prog = extract_programs(path)[0]
        x = np.asarray(r.chromosomes[0].element_cn, dtype=np.float64)
        log("mesh batch case %s: V=%d eps %r, hard_violation %r, certified %s"
            % (os.path.basename(path), prog.num_vars, float(prog.residual_objective(x)), float(prog.hard_violation(x)),
               r.chromosomes[0].certified))
        if not r.path_strings or not all(p and p in lines for p in r.path_strings):
            raise AssertionError("no path printed for %s" % path)
    stacked_vars = sorted(p.num_vars for args, _ in stacked for _, p in args[0])
    single_vars = sorted(args[0].num_vars for args, _ in singles)
    log("mesh batch: %d cases, wall %.3f s, stacked pass %r, round-robin searches %r, K1 launches %d (int8 path %d)"
        % (len(paths), wall, stacked_vars, single_vars, launches, int8_launches))
    log_phases(("solve.tensors", "solve.lp_bound", "score", "solve.lns", "replay"))
    if max(violations) != 0.0:
        raise AssertionError("a mesh batch solution violates hard rows: %r" % violations)
    if len(stacked) != 1 or len(stacked_vars) != 2 or max(stacked_vars) > pipeline.AUTO_EXACT_FIRST_MAX_VARS:
        raise AssertionError("expected the two S=32 programs in one stacked pass, got %r" % stacked_vars)
    if len(single_vars) != 2 or min(single_vars) <= pipeline.AUTO_EXACT_FIRST_MAX_VARS:
        raise AssertionError("expected the two S=48 programs searched round-robin, got %r" % single_vars)
    if launches < 1 or int8_launches != launches:
        raise AssertionError("K1 launched %d times (%d int8) under the mesh" % (launches, int8_launches))
    return {"launches": launches, "int8_launches": int8_launches, "wall": wall}


def check_distinct_cards(workdir: str) -> None:
    """Phase 19: phases 16 and 17 over distinct cards (a (2, 2) mesh of
    four, or (1, 2) of two), equal to the same mesh shape on one card.
    With one card it says so and returns: that is no failure."""
    import numpy as np
    import torch

    from ambigram_tpu_torch.parallel.mesh import make_mesh, visible_devices

    cards = visible_devices()
    if len(cards) < 2:
        log("distinct cards: skipped, %d card visible (the phase needs two)" % len(cards))
        return
    n = 4 if len(cards) >= 4 else 2
    distinct = make_mesh(devices=cards[:n])
    logical = make_mesh(devices=[cards[0]] * n)
    progs, st, X = step_inputs(workdir)
    Xd, Sd, ms_d, _, _ = run_step(st, X, distinct)
    Xl, Sl, ms_l, _, _ = run_step(st, X, logical)
    log("distinct cards %s of %s: step %.3f ms (one card %.3f ms); X' %s, scores %s against one card"
        % (distinct.shape, ",".join(map(str, distinct.flat())), ms_d, ms_l,
           "bitwise equal" if np.array_equal(Xd, Xl) else "DIFFERS", "bitwise equal" if np.array_equal(Sd, Sl) else "DIFFER"))
    if not (np.array_equal(Xd[1], Xl[1]) and np.array_equal(Sd[1], Sl[1])):
        raise AssertionError("the step on distinct cards differs from one card on the twin")
    rel = float((np.abs(Sd - Sl) / np.maximum(np.abs(Sl), 1.0)).max())
    if rel > K1_RTOL:
        raise AssertionError("the step's scores on distinct cards are off one card's by rel %g" % rel)
    run_sharded_solve(proxy_programs(workdir), [("distinct", distinct), ("one card", logical)])


def s128_programs(workdir: str) -> dict:
    """Phase 20(a): the big leg's recipe at S=128 (seed 428, 6 rounds,
    process mode) and its noise-free twin, {noise: program}. Their row
    values can reach 0.652 of 2^24 but the gate's box bound passes it
    (2.59), so K1 reads both in f32."""
    from ambigram_tpu_torch.bench import big_case_path
    from ambigram_tpu_torch.engine.pipeline import extract_programs
    from ambigram_tpu_torch.solver.score import k1_planes, scoring_tensors

    progs = {}
    for noise in (0.05, 0.0):
        t0 = time.perf_counter()
        prog = extract_programs(big_case_path(workdir, S128, noise))[0]
        st = scoring_tensors(prog, "cpu", need_f32=False)
        planes = k1_planes(st)
        log("s128 noise %g: V=%d rows=%d vp=%d x_ub_max %r max|H8| %d, box bound %.4f of 2^24, int8_ok %s, "
            "%d planes (%.1f s to build)"
            % (noise, prog.num_vars, st.H8.shape[0], st.H8.shape[1], st.x_ub_max, st.h8_absmax(),
               math.ceil(st.x_ub_max) * st.h8_absmax() * st.H8.shape[1] / 2**24, st.int8_ok, planes,
               time.perf_counter() - t0))
        if planes != 0 or not st.int8_ok:
            raise AssertionError("the S=128 case (noise %g) should be int8-exact and take K1's f32 path" % noise)
        progs[noise] = prog
        del st
    return progs


def check_k1_s128(progs: dict) -> dict:
    """Phase 20(b, c): K1's f32 path on both S=128 programs at B=32 and
    B=1000: hx bitwise equal to the plain version (every partial sum of
    a row value is w times an integer below 2^24), the scores bitwise on
    the noise-free twin and within K1_RTOL on the noisy case; then its
    times on the noisy case. Returns the kernels-line numbers."""
    import torch

    from ambigram_tpu_torch.solver.score import scoring_tensors

    out = {}
    for noise in (0.0, 0.05):
        prog = progs[noise]
        st = scoring_tensors(prog, DEVICE)
        label = "S=%d seed %d noise%g" % (S128, 300 + S128, noise)
        pop = population(prog, st.x_ub.cpu().numpy(), 1000, seed=2)
        err = check_k1_case(label, st, {"population": pop}, "population" if noise == 0.0 else None, "f32")
        if noise > 0.0:
            t = time_k1(label, st, pop, "f32", iters=5, host_iters=10)
            out = {"max_abs_err": err, "ms": t[32][0], "plain_ms": t[32][1], "library_ms": t[32][2],
                   "bound_ms": t[32][3], "bound_by": t[32][4], "ms_b1000": t[1000][0],
                   "plain_ms_b1000": t[1000][1], "library_ms_b1000": t[1000][2], "bound_ms_b1000": t[1000][3],
                   "bound_by_b1000": t[1000][4], "shape": [st.H.shape[0], st.H.shape[1]]}
        del st
        torch.cuda.empty_cache()
    return out


def run_s128_search(prog) -> dict:
    """Phase 20(d): a bounded device search on the noisy S=128 program
    (one round, one sweep of each tier it reaches, no polish, no
    certificate), through `solve_device` on cuda: K1 must launch at least
    twice (the first scoring and the rescoring after the kick), every
    launch on its f32 path, and the returned x be integral and inside
    [0, x_ub]."""
    import numpy as np
    import torch

    from ambigram_tpu_torch.solver.score import reset_launch_counts, score_rows
    from ambigram_tpu_torch.solver.search import solve_device
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    GLOBAL.reset()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_device(prog, device=DEVICE, rounds=1, max_sweeps=1, polish=False, certify=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int8_launches, f32_launches = score_rows.launches, score_rows.int8_launches, score_rows.f32_launches
    x = np.asarray(res.x, dtype=np.float64)
    vio = float(prog.hard_violation(x))
    log("s128 search: V=%d wall %.3f s, status %s, eps %r, hard_violation %r, K1 launches %d (f32 path %d, int8 path %d)"
        % (prog.num_vars, wall, res.status, float(prog.residual_objective(x)), vio, launches, f32_launches,
           int8_launches))
    log_phases(("solve.tensors", "solve.lp_bound", "score"))
    if f32_launches < 2 or int8_launches != 0 or f32_launches != launches:
        raise AssertionError("K1 launched %d times in the S=128 search (%d f32, %d int8), expected >= 2, all f32"
                             % (launches, f32_launches, int8_launches))
    if x.shape != (prog.num_vars,) or not np.array_equal(x, np.round(x)) or (x < 0).any() or (x > prog.x_ub).any():
        raise AssertionError("the S=128 search returned an x that is not integral inside [0, x_ub]")
    return {"launches": launches, "int8_launches": int8_launches, "f32_launches": f32_launches, "wall": wall,
            "hard_violation": vio}


def check_s128(workdir: str) -> tuple:
    """Phase 20: K1's f32 path on the S=128 programs, then the bounded
    search; (kernels-line numbers, the search's main-path counts). The
    S=128 tensors are released before it returns."""
    import torch

    progs = s128_programs(workdir)
    k1 = check_k1_s128(progs)
    search = run_s128_search(progs[0.05])
    del progs
    torch.cuda.empty_cache()
    return k1, search


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


def ptxas_spills(report: str) -> dict:
    """{function: (spill store bytes, spill load bytes)} from ptxas's
    -v report."""
    import re

    found = re.findall(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", report)
    return {name: (int(st), int(ld)) for name, st, ld in found}


def build_kernels() -> None:
    """Build every kernel of the port at once (one nvcc per source); K1's
    f32 kernels must not spill."""
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
        if name == "score_rows":
            f32 = {fn: v for fn, v in ptxas_spills(info["log"]).items() if "score_rows_f32" in fn}
            if not f32 or any(v != (0, 0) for v in f32.values()):
                raise AssertionError("K1's f32 kernels spill or are missing from ptxas's report: %r" % f32)
            log("ptxas: K1's %d f32 kernels spill nothing" % len(f32))
        counts = sass_counts(info["path"])
        log("sass: %s tensor-core instructions %s" % (name, json.dumps(counts, sort_keys=True)))
        if not any(counts.get(op) for op in wanted):
            raise AssertionError("no %s in the SASS of %s" % (" or ".join(wanted), name))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ambigram_tpu_torch.bench import card_line

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
        blocks = [sc_block_program(*sc_sample(workdir, seed)[1:]) for seed in SC_MANIFEST_SEEDS]
        k1_block = check_k1_block(blocks[SC_MANIFEST_SEEDS.index(SC_SLICE_SEED)])
        sc_slice = run_sc_slice(workdir)
        k1_err.append(check_k1_cases("sc group K=%d S=%d seeds %s" % (
            SC["n_clones"], SC["n_segments"], ",".join(map(str, SC_MANIFEST_SEEDS))), blocks, exact=True))
        del blocks
        sc_batch = run_sc_manifest(workdir)
        k1_big = check_k1_two_planes(workdir)
        s64 = run_s64_slice(workdir)
        golden = run_golden_suite()
        step = check_sharded_step(workdir)
        proxy = run_proxy_meshes(workdir)
        mesh_batch = run_mesh_batch(workdir, paths)
        check_distinct_cards(workdir)
        k1_s128, s128_search = check_s128(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    main_paths = (sl, batch, sc_slice, sc_batch, s64, golden, proxy, mesh_batch, s128_search)

    kernels_line = {
        "kernels": [
            {
                "name": "score_rows",
                "route": "cuda",
                "source": "ambigram_tpu_torch/csrc/score_rows.cu",
                "replaces": "ambigram_tpu/solver/score.py:435",
                "launches": sum(r["launches"] for r in main_paths),
                "max_abs_err": max([k1["max_abs_err"], k1_block["max_abs_err"], k1_big["max_abs_err"],
                                    k1_s128["max_abs_err"]] + k1_err),
                "ms": k1["ms"],
                "plain_ms": k1["plain_ms"],
                "bound_ms": k1["bound_ms"],
                "bound_by": k1["bound_by"],
                "library_ms": k1["library_ms"],
                "int8_launches": sum(r["int8_launches"] for r in main_paths),
                "ms_b1000": k1["ms_b1000"],
                "plain_ms_b1000": k1["plain_ms_b1000"],
                "library_ms_b1000": k1["library_ms_b1000"],
                "f32_path": dict(k1["f32_path"], s128=k1_s128, launches=s128_search["f32_launches"]),
                "sc_block": k1_block,
                "big_s96": k1_big,
            },
            {
                "name": "score_rows (row shards of the sharded step)",
                "route": "cuda",
                "source": "ambigram_tpu_torch/csrc/score_rows.cu",
                "replaces": "ambigram_tpu/solver/score.py:435",
                "serves": "ambigram_tpu/parallel/mesh.py:129 (_local_score)",
                "launches": proxy["launches"],
                "max_abs_err": step["max_abs_err"],
                "ms": step["ms"],
                "plain_ms": step["plain_ms"],
                "bound_ms": step["bound_ms"],
                "bound_by": step["bound_by"],
                "library_ms": step["library_ms"],
                "shape": step["shape"],
                "wall_s": {"sharded_solves": proxy["wall"], "mesh_batch": mesh_batch["wall"]},
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
