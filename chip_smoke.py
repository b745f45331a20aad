"""Smoke run of the PyTorch/CUDA port (ambigram_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

It runs these phases in order; a failure in any of them exits non-zero
and prints no result line:

1. the card: nvidia-smi's name and power limit; a CUDA device must exist;
2. build every kernel of the port's main path from csrc/ (nvcc, sm_90a);
3. K1 (`score_rows`, csrc/score_rows.cu) against its plain PyTorch
   version on the tensors of the S=48 seed-0 case, at B=32 (the search's
   population) and B=1000 (ragged): hx bitwise equal, scores bitwise
   equal on the noise-free variant of the case (integer targets, so
   every f32 sum is exact) and within rtol 1e-5 on the noisy case
   (fractional targets: the f32 row sum rounds, and the two versions
   sum in different orders); then the times of both;
4. the slice: the S=48 seed-0 case of the repo's 4xS48 suite through
   `python -m ambigram_tpu_torch.cli --op bfb --solver auto` on cuda,
   in process. Its program has more than 2048 variables, so auto sends
   it to the device search; the run must go through K1, print a path,
   and reach a feasible solution with eps <= 8.2245 (+1e-4), the value
   the host MILP and the JAX auto path reach on this case;
5. a JSON line describing the kernels, then the result line
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


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
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
        st = scoring_tensors(prog, "cuda")
        x_ub = st.x_ub.cpu().numpy()
        rng = np.random.default_rng(1)
        dense = np.zeros((32, len(x_ub)), dtype=np.float32)
        dense[:, : prog.num_vars] = rng.integers(0, prog.x_ub.astype(np.int64) + 1, size=(32, prog.num_vars))
        sets = {"population": population(prog, x_ub, 1000, seed=2), "dense": dense}
        for kind, X_all in sets.items():
            for B in (32, 1000):
                if B > len(X_all):
                    continue
                X = torch.as_tensor(X_all[:B]).cuda()
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
            X = torch.as_tensor(sets["population"][:B]).cuda()
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
    argv = ["--op", "bfb", "--in_lh", lh, "--solver", "auto", "--device", "cuda", "--no-ledgers"]
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    log(card_line())
    log("torch %s, cuda %s, python %s" % (torch.__version__, torch.version.cuda, sys.version.split()[0]))

    from ambigram_tpu_torch import kernels
    from ambigram_tpu_torch.solver.score import _k1_library

    t0 = time.perf_counter()
    _k1_library()
    log("build: score_rows %.2f s (%.2f s in nvcc)" % (time.perf_counter() - t0, kernels.BUILD_INFO["score_rows"]["seconds"]))
    if kernels.BUILD_INFO["score_rows"]["log"]:
        log(kernels.BUILD_INFO["score_rows"]["log"])

    from ambigram_tpu.engine.pipeline import extract_programs

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        lh = simulate_case(workdir, noise=0.05)
        lh_exact = simulate_case(workdir, noise=0.0)
        k1 = check_k1({"noise0.05": extract_programs(lh)[0], "noise0": extract_programs(lh_exact)[0]})
        sl = run_slice(lh)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels_line = {
        "kernels": [
            {
                "name": "score_rows",
                "route": "cuda",
                "source": "ambigram_tpu_torch/csrc/score_rows.cu",
                "replaces": "ambigram_tpu/solver/score.py:435",
                "launches": sl["launches"],
                "max_abs_err": k1["max_abs_err"],
                "ms": k1["ms"],
                "plain_ms": k1["plain_ms"],
            }
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
