"""The port's case-stacked batch path against the JAX package.

`stack_cases`, the case-axis sweeps (the `jax.vmap` of the JAX batch
search) and batched K1's plain version are held bitwise against the JAX
package on integer-target programs, where every f32 sum is exact. The
batch search itself (`solve_device_batch`, `run_bfb_many`, the CLI's
`--manifest`) draws its kicks from torch generators, so it is judged on
its results: the exact optimum, the exact solver's goldens, aligned with
the inputs. A subprocess shows that the port's bench module and batch
path load no jax.
"""

import functools
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ambigram_tpu.engine.pipeline import run_bfb as reference_run_bfb
from ambigram_tpu.parallel import mesh as jmesh
from ambigram_tpu.solver import search as jsearch
from ambigram_tpu.solver.exact import solve_exact
from ambigram_tpu_torch import cli
from ambigram_tpu_torch.engine import pipeline
from ambigram_tpu_torch.parallel.mesh import stack_cases
from ambigram_tpu_torch.solver import host, search, sweeps
from ambigram_tpu_torch.solver.score import score_rows
from ambigram_tpu_torch.utils.profiling import GLOBAL
from test_e2e_bfb import GOLDEN_EGFR6
from test_solver import _random_prog
from test_torch_score import LEAVES, STATIC, port_from_jax

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EGFR6 = os.path.join(ROOT, "tests", "data", "egfr6.lh")
STEPS = 10


@pytest.fixture
def small_search(monkeypatch):
    monkeypatch.setenv("AMBIGRAM_SEARCH_POP", "8")
    monkeypatch.setenv("AMBIGRAM_SEARCH_ROUNDS", "2")
    monkeypatch.setenv("AMBIGRAM_SEARCH_SWEEPS", "64")
    monkeypatch.setenv("AMBIGRAM_LNS_BUDGET", "10")


def mixed_progs():
    """Three random programs of different sizes (V = 30, 90, 210)."""
    return [_random_prog(np.random.default_rng(10 + n), n) for n in (5, 9, 14)]


def start_states(progs, jst, B=16, seed=3):
    """Per case: the seeded population, every member but the first kicked
    at 4 variables by +-1/+-2, clipped to the box; hx exact (float64)."""
    Vp = jst.H.shape[-1]
    Xs = []
    for g, prog in enumerate(progs):
        x_ub = np.asarray(jst.x_ub[g])
        X, _ = host._seed_case(prog, Vp, x_ub, B, seed + g)
        rng = np.random.default_rng(seed + g)
        for b in range(1, B):
            np.add.at(X[b], rng.integers(0, prog.num_vars, size=4), rng.choice([-2.0, -1.0, 1.0, 2.0], size=4))
        Xs.append(np.clip(X, 0.0, x_ub).astype(np.float32))
    X = np.stack(Xs)
    hx = np.einsum("gbv,grv->gbr", X.astype(np.float64), np.asarray(jst.H, dtype=np.float64)).astype(np.float32)
    return X, hx


def test_stack_cases_is_bitwise_jax():
    progs = mixed_progs()
    jst = jmesh.stack_cases(progs)
    tst = stack_cases(progs, "cpu")
    assert tuple(tst.H.shape) == tuple(jst.H.shape) and tst.H.dim() == 3
    for k in LEAVES:
        got, want = getattr(tst, k).numpy(), np.asarray(getattr(jst, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in STATIC:
        assert getattr(tst, k) == getattr(jst, k), k
    # padding rows carry w = 0 and open bounds
    w = tst.w.numpy()
    assert (tst.lb.numpy()[w == 0] == np.float32(-3e38)).all()
    assert (tst.ub.numpy()[w == 0] == np.float32(3e38)).all()


def test_batched_score_rows_plain_is_bitwise_einsum():
    """K1's plain version with a case axis (the per-case loop) against
    the JAX batch search's rescoring: einsum + vmapped _score_from_hx."""
    progs = mixed_progs()
    jst = jmesh.stack_cases(progs)
    tst = port_from_jax(jst)
    X, _ = start_states(progs, jst, B=24)
    hx_j = jnp.einsum("gbv,grv->gbr", jnp.asarray(X), jst.H, preferred_element_type=jnp.float32)
    s_j = jax.vmap(jsearch._score_from_hx)(jst, hx_j)
    before = score_rows.launches
    s_t, hx_t = score_rows(tst, torch.as_tensor(X), want_hx=True)
    assert score_rows.launches == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(hx_t.numpy(), np.asarray(hx_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    # and each case equals a single-case call
    for g in range(len(progs)):
        s_g, hx_g = score_rows(tst.case(g), torch.as_tensor(X[g]), want_hx=True)
        assert torch.equal(s_g, s_t[g]) and torch.equal(hx_g, hx_t[g])


@pytest.mark.parametrize("kind", ["delta", "moves", "moves3"])
def test_case_axis_sweeps_lockstep_with_vmap(kind):
    """G = 2 integer-target programs of one interval (shared catalogues),
    10 sweeps: X, hx, scores and the per-case flags bitwise equal to the
    JAX package's vmapped sweeps."""
    progs = [_random_prog(np.random.default_rng(s), 14) for s in (5, 6)]
    jst = jmesh.stack_cases(progs)
    tst = port_from_jax(jst)
    X, hx = start_states(progs, jst)
    scores = np.array(jax.vmap(jsearch._score_from_hx)(jst, jnp.asarray(hx)))
    if kind == "delta":
        cat = ()
        jfn = jax.vmap(functools.partial(jsearch._sweep_delta, chunk=128))
        tfn = sweeps.sweep_delta
    elif kind == "moves":
        cat = host.slide_transfer_moves(progs[0])
        jfn = jax.vmap(functools.partial(jsearch._sweep_moves, chunk=128), in_axes=(0, 0, 0, 0, None, None))
        tfn = sweeps.sweep_moves
    else:
        cat = host.split_merge_moves(progs[0])
        assert len(cat[0]) > 128
        jfn = jax.vmap(
            functools.partial(jsearch._sweep_moves3, chunk=128),
            in_axes=(0, 0, 0, 0, None, None, None, None, None),
        )
        tfn = sweeps.sweep_moves3
    jcat = tuple(jnp.asarray(a) for a in cat)
    tcat = tuple(torch.as_tensor(a).to(torch.int64) if a.dtype == np.int32 else torch.as_tensor(a) for a in cat)
    jX, jhx, js = jnp.asarray(X), jnp.asarray(hx), jnp.asarray(scores)
    tX, thx, ts = torch.as_tensor(X), torch.as_tensor(hx), torch.as_tensor(scores)
    n_improved = 0
    for step in range(STEPS):
        jX, jhx, js, jimp = jfn(jst, jX, jhx, js, *jcat)
        tX, thx, ts, timp = tfn(tst, tX, thx, ts, *tcat)
        msg = "%s step %d" % (kind, step)
        np.testing.assert_array_equal(tX.numpy(), np.asarray(jX), err_msg=msg)
        np.testing.assert_array_equal(thx.numpy(), np.asarray(jhx), err_msg=msg)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=msg)
        np.testing.assert_array_equal(timp.numpy(), np.asarray(jimp), err_msg=msg)
        assert tuple(timp.shape) == (2,)
        n_improved += int(timp.sum())
    assert n_improved >= 1


def test_solve_device_batch_groups_aligned_at_the_optimum(small_search):
    """Five programs forming a group of 2, a group of 2 and a singleton
    (a group of one): results come back aligned with the inputs, each at
    the exact solver's optimum."""
    sizes = (6, 7, 6, 8, 7)
    progs = [_random_prog(np.random.default_rng(20 + k), n) for k, n in enumerate(sizes)]
    GLOBAL.reset()
    res = search.solve_device_batch(progs, device="cpu")
    assert GLOBAL.counters["solve.device_calls"] == 3  # two groups and one single
    for prog, r in zip(progs, res):
        exact = solve_exact(prog)
        assert exact.status == "optimal"
        assert r.x.shape == (prog.num_vars,)
        assert float(prog.hard_violation(r.x.astype(np.float64))) == 0.0
        assert r.epsilon_sum == pytest.approx(exact.epsilon_sum, abs=1e-6)


def test_batch_search_pads_a_group_to_a_power_of_two(small_search):
    """A group of 3 runs as 4 cases (the last repeated); the search
    returns one best per padded case and converges on every one."""
    progs = [_random_prog(np.random.default_rng(30 + k), 7) for k in range(3)]
    GLOBAL.reset()
    res = search.solve_device_batch(progs, device="cpu")
    assert GLOBAL.counters["solve.device_calls"] == 1
    assert GLOBAL.counters["candidates_scored"] > 0
    for prog, r in zip(progs, res):
        assert r.epsilon_sum == pytest.approx(solve_exact(prog).epsilon_sum, abs=1e-6)


def simulated_cases(tmp_path, seeds=(1, 3, 5), n_segments=8):
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

    return [
        write_case(simulate_bfb_case(seed=s, n_segments=n_segments, mode="nested"), str(tmp_path / ("c%d" % s)))["lh"]
        for s in seeds
    ]


def test_run_bfb_many_matches_exact_goldens(tmp_path, small_search):
    """Three same-interval cases (one case-stacked group) plus egfr6 (a
    singleton) through the port's batch device path: every case prints
    and returns what the JAX package's exact solver gives."""
    paths = simulated_cases(tmp_path) + [EGFR6]
    out = io.StringIO()
    GLOBAL.reset()
    results = pipeline.run_bfb_many(paths, solver="device", device="cpu", out=out)
    assert GLOBAL.counters["solve.device_calls"] == 2
    want_text = io.StringIO()
    for path, got in zip(paths, results):
        want = reference_run_bfb(path, solver="exact", out=want_text)
        assert got.path_strings == want.path_strings, path
        assert got.ilp_error == pytest.approx(want.ilp_error, abs=1e-9)
    assert results[-1].path_strings[0] == GOLDEN_EGFR6
    assert out.getvalue() == want_text.getvalue()


def test_cli_manifest_through_the_port_and_result_store(tmp_path, small_search, capsys):
    paths = simulated_cases(tmp_path, seeds=(2, 4))
    manifest = tmp_path / "cases.manifest"
    manifest.write_text("# two bulk cases\n%s\n%s\n" % (os.path.basename(paths[0]), paths[1]))
    store = str(tmp_path / "store")
    argv = ["--op", "bfb", "--manifest", "--in_lh", str(manifest), "--solver", "device",
            "--device", "cpu", "--no-ledgers", "--result_store", store]
    assert cli.main(argv) == 0
    captured = capsys.readouterr()
    want = io.StringIO()
    for p in paths:
        reference_run_bfb(p, solver="exact", out=want)
    assert captured.out == want.getvalue()
    assert "manifest complete: 2 case(s)" in captured.err
    stored = sorted(os.listdir(store))
    assert len(stored) == 2
    # rerun: a finished case is served from the store (its file is
    # poisoned to prove it is read), the other is recomputed
    fn = os.path.join(store, stored[0])
    payload = json.load(open(fn))
    payload["path_strings"] = ["cached-sentinel"]
    json.dump(payload, open(fn, "w"))
    os.unlink(os.path.join(store, stored[1]))
    results = cli.run(argv)
    assert sum(r.path_strings == ["cached-sentinel"] for r in results) == 1
    assert len(os.listdir(store)) == 2


def test_bench_and_batch_path_load_no_jax(tmp_path):
    """The port's bench module imports, and a small run_bfb_many through
    the case-stacked device path runs, with no jax in the process."""
    paths = simulated_cases(tmp_path, seeds=(7, 8))
    code = (
        "import sys\n"
        "import ambigram_tpu_torch.bench\n"
        "from ambigram_tpu_torch.engine.pipeline import run_bfb_many\n"
        "res = run_bfb_many(%r, solver='device', device='cpu')\n"
        "assert all(r.path_strings for r in res)\n"
        "print('JAX_LOADED=%%s' %% ('jax' in sys.modules))\n" % (paths,)
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(
        AMBIGRAM_SEARCH_POP="8", AMBIGRAM_SEARCH_ROUNDS="2", AMBIGRAM_SEARCH_SWEEPS="64",
        AMBIGRAM_LNS_BUDGET="10", OMP_NUM_THREADS="1",
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_LOADED=False" in proc.stdout


def test_bench_big_programs_are_the_jax_legs(tmp_path):
    """The port bench's big leg runs the JAX leg's programs (bench.py's
    `bench_big`: seed 300 + S, 6 rounds, process mode, noise 0.05), field
    for field; S=64 takes one u8 plane of K1's int8 path, S=96 two, its
    row values at 92% of 2^24."""
    import dataclasses
    import math

    from ambigram_tpu.engine.pipeline import extract_programs
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case
    from ambigram_tpu_torch import bench
    from ambigram_tpu_torch.solver.score import k1_planes, scoring_tensors

    progs = bench.big_programs()
    assert sorted(progs) == [64, 96]
    for n_seg, prog in progs.items():
        case = simulate_bfb_case(seed=300 + n_seg, n_segments=n_seg, rounds=6, mode="process", noise=0.05)
        ref = extract_programs(write_case(case, str(tmp_path / ("big%d" % n_seg)))["lh"])[0]
        for f in dataclasses.fields(ref):
            a, b = getattr(prog, f.name), getattr(ref, f.name)
            assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, f.name
        st = scoring_tensors(prog, "cpu", need_f32=False)
        fill = math.ceil(st.x_ub_max) * st.h8_absmax() * st.H8.shape[1] / 2**24
        assert (prog.num_vars, k1_planes(st)) == {64: (4160, 1), 96: (9312, 2)}[n_seg]
        assert tuple(st.H8.shape) == {64: (14592, 4224), 96: (32512, 9344)}[n_seg]
        if n_seg == 96:
            assert 0.9 < fill < 1.0


BATCH_QUALITY_BUDGET = dict(pop=8, rounds=2, max_sweeps=64)


def batch_quality(pkg: str, seed: int) -> list:
    """One package's `solve_device_batch` over the bench's 16 batch
    programs (seeds 200-215, S=32/48 alternating, noise 0.05) at equal
    reduced budgets, without the wall-clock LNS and the certificate;
    each case's eps, None unless feasible."""
    import tempfile

    if pkg == "jax":
        from ambigram_tpu.engine.pipeline import extract_programs
        from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

        solve, kw = jsearch.solve_device_batch, {}
    else:
        from ambigram_tpu_torch.engine.pipeline import extract_programs
        from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

        solve, kw = search.solve_device_batch, {"device": "cpu"}
    td = tempfile.mkdtemp()
    progs = []
    for i in range(16):
        case = simulate_bfb_case(seed=200 + i, n_segments=32 if i % 2 == 0 else 48, rounds=5, mode="process", noise=0.05)
        progs.append(extract_programs(write_case(case, os.path.join(td, "b%d" % i))["lh"])[0])
    res = solve(progs, seed=seed, polish=False, certify=False, **BATCH_QUALITY_BUDGET, **kw)
    out = []
    for p, r in zip(progs, res):
        feasible = float(p.hard_violation(r.x.astype(np.float64))) == 0.0
        out.append(round(float(r.epsilon_sum), 4) if feasible else None)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_quality_against_jax(seed):
    """Both packages' batch search on the bench's 16 batch programs at
    equal budgets and seed (about an hour per package on one CPU core
    set): the port may not be worse than the JAX search on most cases.
    Prints both packages' eps per case."""
    jax_eps, port_eps = batch_quality("jax", seed), batch_quality("torch", seed)
    print(json.dumps({"seed": seed, "jax": jax_eps, "port": port_eps}))
    assert None not in jax_eps and None not in port_eps
    worse = sum(t > j + 1e-9 for j, t in zip(jax_eps, port_eps))
    assert worse <= len(port_eps) // 2, (jax_eps, port_eps)
