"""The port's multi-device batching against the JAX package.

JAX runs its meshes on 8 virtual CPU devices (tests/conftest.py); the
port's meshes here are made of the CPU labels cpu:0 .. cpu:7, which say
which leg went where while the data lands on the CPU. Both packages get
the same numpy inputs:

- `make_mesh`'s shapes for 1, 2, 4 and 8 devices;
- `sharded_step` on integer-target programs over meshes (1,1), (1,2),
  (2,2) and (4,2): X' and the scores bitwise equal to JAX's;
- `solve_cases_sharded` at the same seed and small budgets: the same
  best_x as JAX's (the search draws from numpy in JAX's order);
- counterparts of tests/test_parallel.py and tests/test_scaling.py: leg
  placement under restricted meshes and the deep queue, round-robin,
  mixed sizes, the result store under a mesh, solutions that do not
  change with the mesh size, per-device work that falls as 1/D;
- `mesh=None` on one device makes the calls the batch path made before
  it had a mesh, and K1's launch count keeps every launch of many
  threads.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from ambigram_tpu.engine.pipeline import extract_programs as jax_extract_programs
from ambigram_tpu.parallel import mesh as jmesh
from ambigram_tpu_torch.engine import pipeline
from ambigram_tpu_torch.engine.pipeline import extract_programs
from ambigram_tpu_torch.parallel import mesh as tmesh
from ambigram_tpu_torch.parallel.mesh import cpu_devices, make_mesh
from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_EGFR6 = "1+2+3+4+5+6+|6-5-4-3-2-|2+3+4+|4-3-|3+4+|4-3-2-|2+3+4+5+6+|6-5-4-3-2-1-"
SHAPES = [(1, 1), (1, 2), (2, 2), (4, 2)]


def cpu_mesh(n, case_axis=None):
    return make_mesh(case_axis=case_axis, devices=cpu_devices(n))


def proxy_paths(tmp_path, n_cases=8, n_segments=16):
    """The bench proxy leg's recipe (seeds 400..., process mode, noise 0:
    integer targets)."""
    paths = []
    for i in range(n_cases):
        case = simulate_bfb_case(seed=400 + i, n_segments=n_segments, rounds=4, mode="process", noise=0.0)
        paths.append(write_case(case, str(tmp_path / ("sp%d" % i)))["lh"])
    return paths


def both_programs(paths):
    return [jax_extract_programs(p)[0] for p in paths], [extract_programs(p)[0] for p in paths]


@pytest.mark.parametrize("n, shape", [(1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (8, (4, 2))])
def test_make_mesh_shapes(n, shape):
    mesh = make_mesh(n, devices=cpu_devices(8))
    assert mesh.shape == shape == jmesh.make_mesh(n).devices.shape
    assert mesh.axis_names == ("case", "model")
    assert mesh.flat() == cpu_devices(n)
    # a logical mesh repeats one device
    assert make_mesh(devices=["cpu"] * n).shape == shape


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_sharded_step_matches_jax_bitwise(shape, tmp_path, monkeypatch):
    """One step over the dense move set on four integer-target programs:
    X' and the scores bitwise equal to JAX's, and to the port's step when
    its move set is built in chunks of 7 moves."""
    import jax.numpy as jnp

    jp, tp = both_programs(proxy_paths(tmp_path, n_cases=4, n_segments=10))
    jst = jmesh.stack_cases(jp)
    V = jst.H.shape[-1]
    eye = np.eye(V, dtype=np.float32)
    moves = np.concatenate([np.zeros((1, V), np.float32), eye, -eye], axis=0)
    x_ub = np.asarray(jst.x_ub)
    rng = np.random.default_rng(0)
    X = np.minimum(rng.integers(0, 3, size=(4, 6, V)).astype(np.float32), x_ub[:, None, :])
    n = shape[0] * shape[1]
    score_args = (jst.H8, jst.lb_raw, jst.ub_raw, jst.w) if jst.use_int8 else (jst.H, jst.lb, jst.ub, jnp.ones_like(jst.lb))
    Xj, Sj = jmesh.sharded_step(jmesh.make_mesh(n, case_axis=shape[0]))(
        *score_args, jst.x_ub, jnp.asarray(X), jnp.asarray(moves)
    )
    mesh = cpu_mesh(n, case_axis=shape[0])
    cases = tmesh.shard_cases(tmesh.stack_cases(tp), mesh)
    assert [[s.H8.device.type for s in row] for row in cases.shards] == [["cpu"] * shape[1]] * shape[0]
    for chunk_bytes in (tmesh.STEP_CHUNK_BYTES, 4 * 6 * V * 7):
        monkeypatch.setattr(tmesh, "STEP_CHUNK_BYTES", chunk_bytes)
        Xt, St = tmesh.sharded_step(mesh)(cases, cases.put(X))
        assert np.array_equal(cases.gather(Xt), np.asarray(Xj))
        assert np.array_equal(cases.gather(St), np.asarray(Sj))
    assert (np.asarray(Xj) != X).any()


def _demo_programs():
    import __graft_entry__

    from ambigram_tpu_torch.bench import _demo_program

    return [__graft_entry__._demo_program(6), __graft_entry__._demo_program(8)], [_demo_program(6), _demo_program(8)]


@pytest.mark.parametrize(
    "programs, shape", [("demo", (1, 1)), ("demo", (4, 2)), ("proxy", (2, 2)), ("proxy", (4, 2))]
)
def test_solve_cases_sharded_matches_jax(programs, shape, tmp_path):
    """The whole stacked search at the same seed and small budgets: the
    port returns JAX's best_x, case for case."""
    if programs == "demo":
        jp, tp = _demo_programs()
    else:
        jp, tp = both_programs(proxy_paths(tmp_path))
    n = shape[0] * shape[1]
    kw = dict(pop=4, steps=4, rounds=2, seed=3)
    want = jmesh.solve_cases_sharded(jp, mesh=jmesh.make_mesh(n, case_axis=shape[0]), **kw)
    got = tmesh.solve_cases_sharded(tp, mesh=cpu_mesh(n, case_axis=shape[0]), **kw)
    assert len(got) == len(want) == len(tp)
    for a, b in zip(got, want):
        assert a.dtype == np.int64 and np.array_equal(a, b)


# ------------------------------------- counterparts of tests/test_parallel.py


def test_mesh_shape():
    mesh = make_mesh(devices=cpu_devices(8))
    assert mesh.shape == (4, 2)
    assert mesh.axis_names == ("case", "model")


def test_sharded_step_reaches_small_residual():
    from ambigram_tpu_torch.engine.ilp import build_bfb_program

    seg = np.array([2.0, 4.0, 4.0, 2.0])
    fbi = np.array([0.0, 1.0, 1.0, 0.0])
    prog = build_bfb_program(1, 4, seg, fbi, 12, 1)
    best = tmesh.solve_cases_sharded([prog] * 4, mesh=cpu_mesh(8), steps=48)
    for x in best:
        assert float(prog.hard_violation(x.astype(float))) == 0.0
        assert float(prog.residual_objective(x.astype(float))) <= 4.0


def test_run_bfb_many_batches_cases(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    paths = [os.path.join(DATA, "egfr6.lh")]
    for seed in (1, 3):
        paths.append(write_case(simulate_bfb_case(seed=seed, n_segments=6), "sim%d" % seed)["lh"])
    results = pipeline.run_bfb_many(paths, solver="auto", device="cpu", mesh=cpu_mesh(8))
    assert results[0].path_strings[0] == GOLDEN_EGFR6
    for path, res in zip(paths, results):
        assert res.path_strings == pipeline.run_bfb(path, solver="exact", device="cpu").path_strings


def test_host_shard_single_process():
    from ambigram_tpu_torch.parallel.distributed import host_shard, process_count, process_index

    assert process_count() == 1 and process_index() == 0
    assert host_shard([1, 2, 3]) == [1, 2, 3]


def test_run_bfb_many_result_store_idempotent_under_a_mesh(tmp_path):
    import json

    lh = str(tmp_path / "case.lh")
    open(lh, "w").write(open(os.path.join(DATA, "egfr6.lh")).read())
    store = str(tmp_path / "store")
    mesh = cpu_mesh(8)
    r1 = pipeline.run_bfb_many([lh], solver="auto", device="cpu", mesh=mesh, result_store=store)
    files = os.listdir(store)
    assert len(files) == 1 and files[0].endswith(".json")
    assert r1[0].path_strings == [GOLDEN_EGFR6]
    payload = json.load(open(os.path.join(store, files[0])))
    payload["path_strings"] = ["cached-sentinel"]
    json.dump(payload, open(os.path.join(store, files[0]), "w"))
    r2 = pipeline.run_bfb_many([lh], solver="auto", device="cpu", mesh=mesh, result_store=store)
    assert r2[0].path_strings == ["cached-sentinel"]
    open(lh, "a").write("\n")
    r3 = pipeline.run_bfb_many([lh], solver="auto", device="cpu", mesh=mesh, result_store=store)
    assert r3[0].path_strings == [GOLDEN_EGFR6]
    assert len(os.listdir(store)) == 2


@pytest.fixture
def record_searches(monkeypatch):
    """Record the device of every solve_device / solve_device_batch call
    (one entry per program) and each call's program count."""
    from ambigram_tpu_torch.solver import search

    used, batches = [], []
    real_one, real_batch = search.solve_device, search.solve_device_batch

    def one(prog, *a, device=None, **kw):
        used.append(device)
        return real_one(prog, *a, device=device, **kw)

    def batch(progs, *a, device=None, **kw):
        used.extend([device] * len(progs))
        batches.append((device, len(progs)))
        return real_batch(progs, *a, device=device, **kw)

    monkeypatch.setattr(search, "solve_device", one)
    monkeypatch.setattr(search, "solve_device_batch", batch)
    return used, batches


def test_run_bfb_many_per_case_searches_roundrobin(tmp_path, monkeypatch, record_searches):
    """Per-case searches go round-robin over the mesh's devices when the
    queue is not deep: two cases on a (1, 2) mesh (one case slot, so
    every program takes the per-case branch, whatever its size) search on
    cpu:0 and cpu:1, and still recover truth exactly. (The JAX test
    reaches the branch with two V > 2048 programs under its 8-device
    mesh; the dry run does so here with one.)"""
    from ambigram_tpu_torch.scripts.evaluate import multiplicity_diff

    used, batches = record_searches
    monkeypatch.setenv("AMBIGRAM_SEARCH_POP", "16")
    monkeypatch.setenv("AMBIGRAM_SEARCH_ROUNDS", "2")
    monkeypatch.setenv("AMBIGRAM_SEARCH_SWEEPS", "96")
    monkeypatch.chdir(tmp_path)
    paths, truths = [], []
    for seed in (1, 3):
        case = simulate_bfb_case(seed=seed, n_segments=12)
        paths.append(write_case(case, "lg%d" % seed)["lh"])
        truths.append(case.truth_string)
    mesh = cpu_mesh(2)
    results = pipeline.run_bfb_many(paths, solver="device", device="cpu", mesh=mesh)
    assert sorted(used, key=lambda d: d.index) == mesh.flat() and not batches
    for res, truth in zip(results, truths):
        assert multiplicity_diff(truth, res.path_strings[0]) == 0


def test_run_bfb_many_mixed_sizes_threaded(tmp_path, monkeypatch):
    """Mixed sizes under a four-slot mesh: the exact prepass, the stacked
    sharded pass for what it leaves open and the threaded polish after
    it; noise-free cases come back exactly recovered."""
    from ambigram_tpu_torch.scripts.evaluate import multiplicity_diff

    for knob, value in (("SEARCH_POP", "4"), ("SEARCH_ROUNDS", "1"), ("SEARCH_SWEEPS", "32"), ("SHARD_POP", "4"),
                        ("SHARD_ROUNDS", "1"), ("SHARD_STEPS", "24"), ("LNS_BUDGET", "20")):
        monkeypatch.setenv("AMBIGRAM_" + knob, value)
    sizes = [8, 14, 24, 33]  # V = 72, 210, 600, 1122
    cases, paths = [], []
    for i, n in enumerate(sizes):
        case = simulate_bfb_case(seed=40 + i, n_segments=n, mode="nested")
        cases.append(case)
        paths.append(write_case(case, str(tmp_path / ("m%d" % i)))["lh"])
    results = pipeline.run_bfb_many(paths, solver="auto", device="cpu", mesh=cpu_mesh(8))
    assert len(results) == len(sizes)
    for case, res in zip(cases, results):
        assert res.path_strings
        assert multiplicity_diff(case.truth_string, res.path_strings[0]) == 0


def test_stacked_pass_takes_the_mid_size_programs(tmp_path, monkeypatch):
    """With two case slots, `solve_programs_batch(solver="device")` sends
    programs of at most 2048 variables to one stacked sharded pass on the
    caller's mesh and the rest round-robin; every solution replays."""
    monkeypatch.setenv("AMBIGRAM_SHARD_POP", "8")
    monkeypatch.setenv("AMBIGRAM_SHARD_STEPS", "16")
    monkeypatch.setenv("AMBIGRAM_SHARD_ROUNDS", "2")
    monkeypatch.setenv("AMBIGRAM_LNS_BUDGET", "10")
    calls = []
    real = tmesh.solve_cases_sharded

    def spy(progs, mesh=None, **kw):
        calls.append(([p.num_vars for p in progs], mesh))
        return real(progs, mesh=mesh, **kw)

    monkeypatch.setattr(tmesh, "solve_cases_sharded", spy)
    paths = [write_case(simulate_bfb_case(seed=s, n_segments=10), str(tmp_path / ("s%d" % s)))["lh"] for s in (0, 1, 2)]
    flat = [extract_programs(p)[0] for p in paths]
    mesh = cpu_mesh(4)
    sols = pipeline.solve_programs_batch(flat, [(i, 0) for i in range(3)], solver="device", device="cpu", mesh=mesh)
    assert calls == [([p.num_vars for p in flat], mesh)]
    for i, prog in enumerate(flat):
        assert float(prog.hard_violation(sols[(i, 0)].x.astype(np.float64))) == 0.0


def test_run_bfb_many_respects_restricted_mesh(tmp_path, monkeypatch, record_searches):
    """A caller-restricted one-device mesh confines every device search,
    per case or case-stacked, to that mesh's device."""
    used, _ = record_searches
    for knob, value in (("POP", "4"), ("ROUNDS", "1"), ("SWEEPS", "16")):
        monkeypatch.setenv("AMBIGRAM_SEARCH_" + knob, value)
    monkeypatch.setenv("AMBIGRAM_LNS_BUDGET", "5")
    monkeypatch.chdir(tmp_path)
    mesh = make_mesh(1, devices=cpu_devices(8)[3:])
    paths = [write_case(simulate_bfb_case(seed=seed, n_segments=10), "r%d" % seed)["lh"] for seed in (0, 1, 2)]
    results = pipeline.run_bfb_many(paths, solver="device", device="cpu", mesh=mesh)
    assert len(results) == 3 and all(r.path_strings for r in results)
    assert used and set(used) == {torch.device("cpu", 3)}


def test_one_device_auto_batch_certifies_small_programs(tmp_path, monkeypatch):
    """Clean mid-size programs (past the prepass cut, under the auto
    split) end certified under a one-device mesh: the case-stacked search
    with its tiny budget cannot certify, so `_post_big_auto`'s exact
    stage must."""
    for knob, value in (("POP", "4"), ("ROUNDS", "1"), ("SWEEPS", "8")):
        monkeypatch.setenv("AMBIGRAM_SEARCH_" + knob, value)
    monkeypatch.setenv("AMBIGRAM_LNS_BUDGET", "5")
    flat, index = [], []
    for seed in (0, 1, 2):
        case = simulate_bfb_case(seed=seed, n_segments=24)  # V = 600
        flat.append(extract_programs(write_case(case, str(tmp_path / ("a%d" % seed)))["lh"])[0])
        index.append((seed, 0))
    solutions = pipeline.solve_programs_batch(flat, index, solver="auto", device="cpu", mesh=cpu_mesh(1))
    assert [solutions[k].status for k in index] == ["optimal"] * 3


def test_deep_queue_multi_device_case_stacking(tmp_path, monkeypatch, record_searches):
    """More programs than twice the devices: one case-stacked leg per
    device of the mesh, every leg inside it; clean cases recover truth.
    (A (1, 2) mesh has one case slot, so every program is a per-case one
    whatever its size: the JAX test's V > 2048 cases are not needed to
    reach the leg.)"""
    from ambigram_tpu_torch.scripts.evaluate import multiplicity_diff

    used, batches = record_searches
    for knob, value in (("POP", "8"), ("ROUNDS", "1"), ("SWEEPS", "64")):
        monkeypatch.setenv("AMBIGRAM_SEARCH_" + knob, value)
    monkeypatch.setenv("AMBIGRAM_LNS_BUDGET", "10")
    monkeypatch.chdir(tmp_path)
    mesh = make_mesh(2, devices=cpu_devices(8)[4:])
    paths, truths = [], []
    for seed in (1, 3, 5, 7, 9):  # 5 cases > 2 * 2 devices
        case = simulate_bfb_case(seed=seed, n_segments=12)
        paths.append(write_case(case, "dq%d" % seed)["lh"])
        truths.append(case.truth_string)
    results = pipeline.run_bfb_many(paths, solver="device", device="cpu", mesh=mesh)
    assert sorted(batches, key=lambda b: b[0].index) == [(torch.device("cpu", 4), 3), (torch.device("cpu", 5), 2)]
    for res, truth in zip(results, truths):
        assert res.path_strings and multiplicity_diff(truth, res.path_strings[0]) == 0


# -------------------------------------- counterparts of tests/test_scaling.py


def test_per_device_work_scales_inverse_with_mesh(tmp_path, monkeypatch):
    """Per-device operations of one step fall as 1/D over case-parallel
    meshes of 1, 2, 4 and 8 devices (JAX reads them from XLA's cost
    analysis; here they are counted from the shapes of every row-shard
    launch, per device label)."""
    progs = [extract_programs(p)[0] for p in proxy_paths(tmp_path, n_cases=8, n_segments=10)]
    st = tmesh.stack_cases(progs)
    X = np.zeros((8, 4, st.H.shape[-1]), dtype=np.float32)
    real = tmesh._local_score
    ops: dict = {}
    label: dict = {}  # id of a row shard -> its mesh device

    def counting(shard, Xs):
        G, B, vp = Xs.shape
        dev = label[id(shard)]
        ops[dev] = ops.get(dev, 0) + 2 * G * B * shard.H8.shape[-2] * vp
        return real(shard, Xs)

    monkeypatch.setattr(tmesh, "_local_score", counting)
    per_device = {}
    for d in (1, 2, 4, 8):
        mesh = cpu_mesh(d, case_axis=d)
        cases = tmesh.shard_cases(st, mesh)
        label.update({id(s): mesh.devices[c, m] for c, row in enumerate(cases.shards) for m, s in enumerate(row)})
        ops.clear()
        tmesh.sharded_step(mesh)(cases, cases.put(X))
        assert set(ops) == set(mesh.flat())
        per_device[d] = max(ops.values())
    for d in (2, 4, 8):
        assert per_device[1] / (d * per_device[d]) >= 0.8, per_device


def test_solutions_invariant_across_mesh_sizes(tmp_path):
    progs = [extract_programs(p)[0] for p in proxy_paths(tmp_path, n_cases=8, n_segments=10)]
    results = {d: tmesh.solve_cases_sharded(progs, mesh=cpu_mesh(d, case_axis=d), rounds=2, steps=24, pop=8)
               for d in (1, 2, 8)}
    for d in (2, 8):
        for a, b in zip(results[1], results[d]):
            assert np.array_equal(a, b)


# ------------------------------------------------ the one-device route, K1


def _fake_batch_results(progs):
    from ambigram_tpu_torch.solver.exact import solve_exact

    return [solve_exact(p) for p in progs]


def test_mesh_none_on_one_device_takes_the_one_card_route(tmp_path, monkeypatch):
    """`run_bfb_many(mesh=None)` on one device makes the calls the batch
    path made before the mesh was ported: several programs go to one
    `solve_device_batch(progs, device=..., lns_budget=total / waves,
    post_workers=8)`, a single one to `solve_device(prog, device=...,
    lns_budget=...)`; the stacked pass never runs."""
    from ambigram_tpu_torch.solver import search

    calls = []

    def batch(progs, device=None, **kw):
        calls.append(("solve_device_batch", len(progs), device, kw))
        return _fake_batch_results(progs)

    def one(prog, device=None, **kw):
        calls.append(("solve_device", 1, device, kw))
        return _fake_batch_results([prog])[0]

    def no_stacked(*a, **kw):
        raise AssertionError("the stacked pass ran with one case slot")

    monkeypatch.setattr(search, "solve_device_batch", batch)
    monkeypatch.setattr(search, "solve_device", one)
    monkeypatch.setattr(pipeline, "_solve_stacked", no_stacked)
    monkeypatch.chdir(tmp_path)
    paths = [os.path.join(DATA, "egfr6.lh")]
    paths += [write_case(simulate_bfb_case(seed=s, n_segments=6), "m%d" % s)["lh"] for s in (1, 2)]
    res = pipeline.run_bfb_many(paths, solver="device", device="cpu")
    assert res[0].path_strings[0] == GOLDEN_EGFR6
    budget = pipeline._per_case_lns_budget(3, 3)
    assert calls == [("solve_device_batch", 3, torch.device("cpu"), {"lns_budget": budget, "post_workers": 8})]
    calls.clear()
    res = pipeline.run_bfb_many(paths[:1], solver="device", device="cpu")
    assert res[0].path_strings[0] == GOLDEN_EGFR6
    assert calls == [("solve_device", 1, torch.device("cpu"), {"lns_budget": pipeline._per_case_lns_budget(1, 1)})]


def test_k1_launch_count_keeps_every_thread():
    """N threads x M counted launches of K1 count N * M, under a switch
    interval short enough to expose a lost update (the count is guarded
    by a lock; on the card `score_rows` counts through it)."""
    from ambigram_tpu_torch.solver import score

    score.reset_launch_counts()
    n_threads, m_calls = 8, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda k=k: [score._count_k1_launch(k % 2) for _ in range(m_calls)])
            for k in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert score.score_rows.launches == n_threads * m_calls
    assert score.score_rows.int8_launches == score.score_rows.f32_launches == n_threads * m_calls // 2
    score.reset_launch_counts()
