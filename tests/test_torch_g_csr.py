"""The port's sparse hard rows: each program's CSR of G (engine/ilp.py
`g_csr`) and the host readers that take it.

The builders attach the CSR as they assemble G; it must hold exactly
what a conversion of the dense G holds. `hard_violation` is the CSR's
product in float64 and must equal a plain float64 product with the
dense G. The LNS windows slice the CSR and must hand HiGHS
(`milp_lad`) the arrays that the dense formulas over
`residual_system()` and G in float32 give. The seeding LP is held
against the JAX package in tests/test_torch_search.py.
"""

import dataclasses
import glob
import inspect
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

from ambigram_tpu.engine import sc as jsc
from ambigram_tpu.solver import lns as jlns
from ambigram_tpu_torch.engine import ilp, pipeline
from ambigram_tpu_torch.engine import sc as tsc
from ambigram_tpu_torch.scripts.simulate import simulate_sc_case, write_sc_clones
from ambigram_tpu_torch.solver import host, lns
from ambigram_tpu_torch.utils.profiling import GLOBAL

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def recipe_programs(workdir, seed=2, n_segments=10):
    """The benchmark recipe's sample at a small S: K = 3 clones, integer
    targets, all-pairs coupling. Returns the block program as the port
    builds it and as the JAX package builds it."""
    sc = simulate_sc_case(seed=seed, n_clones=3, n_segments=n_segments, topology="chain")
    names, _ = write_sc_clones(sc, os.path.join(str(workdir), "s%d_c" % seed))
    paths = ",".join(names)
    (tprog,) = [p for p in tsc.extract_sc_programs(paths) if p is not None]
    (jprog,) = [p for p in jsc.extract_sc_programs(paths) if p is not None]
    return tprog, jprog


def fields_of(prog):
    return {f.name: getattr(prog, f.name) for f in dataclasses.fields(prog)}


def dense_count():
    return GLOBAL.counters.get("program.g_csr_dense", 0.0)


def assert_csr_is_the_dense_conversion(prog):
    got, want = ilp.g_csr(prog), csr_matrix(prog.G)
    assert got.shape == want.shape and got.dtype == want.dtype
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


def _bundled(tmp_path):
    progs = []
    for path in sorted(glob.glob(os.path.join(DATA, "*.lh"))):
        progs += [p for p in pipeline.extract_programs(path) if p is not None]
    assert len(progs) >= 14
    return progs


def _loops(tmp_path):
    rng = np.random.default_rng(5)
    out = []
    for n, comps in ((6, []), (7, [[1, 2], [2, 3, 4]])):
        seg = rng.integers(1, 7, size=n).astype(np.float64)
        fbi = rng.integers(0, 3, size=n).astype(np.float64)
        args = (1, n, seg, fbi, float(seg.sum()), 1)
        out.append(ilp._build_bfb_program_loops(*args, components=comps, juncs_info=bool(comps)))
    return out


def _sc_recipe(tmp_path):
    tprog, _ = recipe_programs(tmp_path)
    return [tprog]


def _zero_sum_duplicates(tmp_path):
    # (0, 1) is +1 and -1 (a sum of 0, absent from the dense G), (1, 2)
    # is 1 + 1, (2, 0) is -2 + 1
    rows = np.array([0, 0, 1, 1, 2, 2, 0])
    cols = np.array([1, 1, 2, 2, 0, 0, 5])
    vals = np.array([1.0, -1.0, 1.0, 1.0, -2.0, 1.0, 1.0])
    G, G_sp = ilp._g_from_triplets(rows, cols, vals, (3, 6))
    np.testing.assert_array_equal(G, [[0, 0, 0, 0, 0, 1], [0, 0, 2, 0, 0, 0], [-1, 0, 0, 0, 0, 0]])
    assert G_sp.nnz == 3
    prog = ilp.build_bfb_program(1, 2, np.ones(2), np.zeros(2), 2.0, 0)
    prog = ilp.BfbProgram(**{**fields_of(prog), "G": G, "g_lb": np.zeros(3), "g_ub": np.full(3, 2.0)})
    return [ilp.attach_g_csr(prog, G_sp)]


@pytest.mark.parametrize(
    "make",
    [_bundled, _loops, _sc_recipe, _zero_sum_duplicates],
    ids=["build_bfb_program", "build_bfb_program_loops", "build_sc_program", "zero_sum_duplicates"],
)
def test_builders_attach_the_dense_conversion(make, tmp_path):
    """Every builder's CSR is `csr_matrix(G)`: the same indptr, indices
    and values, so no reader of it sees another G. None of them counts
    a conversion."""
    before = dense_count()
    progs = make(tmp_path)
    assert dense_count() == before
    for prog in progs:
        assert_csr_is_the_dense_conversion(prog)
        assert ilp.g_csr(prog) is ilp.g_csr(prog)
    assert dense_count() == before


def test_programs_made_otherwise_convert_once(tmp_path):
    """A program not made by a builder (here, a copy of one) converts its
    dense G on first use, counted once, and keeps the CSR; one whose G
    is replaced converts again."""
    prog = pipeline.extract_programs(os.path.join(DATA, "egfr6.lh"))[0]
    copy = ilp.BfbProgram(**fields_of(prog))
    before = dense_count()
    first = ilp.g_csr(copy)
    assert dense_count() == before + 1
    assert ilp.g_csr(copy) is first and dense_count() == before + 1
    assert_csr_is_the_dense_conversion(copy)
    copy.G = copy.G.copy()
    assert ilp.g_csr(copy) is not first and dense_count() == before + 2
    assert_csr_is_the_dense_conversion(copy)


def _plain_violation(prog, x):
    gx = x @ prog.G.astype(np.float64).T
    return np.maximum(gx - prog.g_ub, 0).sum(axis=-1) + np.maximum(prog.g_lb - gx, 0).sum(axis=-1)


def test_hard_violation_is_the_float64_product(tmp_path):
    """On integer points, feasible and violating, one at a time and in
    batches of any rank, `hard_violation` equals the plain float64
    product with the dense G, also where x_ub puts a row past 2**24
    (where a float32 product would round)."""
    tprog, _ = recipe_programs(tmp_path)
    rng = np.random.default_rng(0)
    V = tprog.num_vars
    X = np.minimum(rng.integers(0, 3, size=(2, 3, V)), tprog.x_ub).astype(np.float64)
    X[0, 0] = 0.0  # feasible: every hard row holds at x = 0
    assert tprog.hard_violation(X[0, 0]) == 0.0 and (tprog.hard_violation(X)[1] > 0).all()
    huge = ilp.build_bfb_program(1, 6, np.full(6, 4.0), np.zeros(6), 2.0**25, 0)
    assert float((np.abs(huge.G).astype(np.float64) @ huge.x_ub).max()) >= 2.0**24
    Xh = rng.integers(0, 2**25, size=(4, huge.num_vars)).astype(np.float64)
    Xh[:, : len(huge.pairs)] = rng.integers(0, 2, size=(4, len(huge.pairs)))
    Xh[0] = 0.0
    Xh[1, len(huge.pairs)] = 2.0**24 + 1  # no float32 holds it
    for prog, batch in ((tprog, X), (huge, Xh)):
        for x in (batch, batch.reshape(-1, batch.shape[-1]), batch.reshape(-1, batch.shape[-1])[1]):
            got = prog.hard_violation(x)
            want = _plain_violation(prog, x)
            assert np.shape(got) == np.shape(want)
            np.testing.assert_array_equal(got, want)
    assert huge.hard_violation(Xh[0]) == 0.0 and huge.hard_violation(Xh[1]) > 0


@pytest.mark.parametrize("probe", [True, False], ids=["probe", "polish"])
@pytest.mark.parametrize("incumbent", ["feasible", "violating"])
def test_solve_window_hands_highs_the_dense_formulas_arrays(incumbent, probe, tmp_path, monkeypatch):
    """Over a whole probe or polish of a K = 3 block program at S = 20
    (its endpoint neighbourhood, then its windows), every call of
    `milp_lad`, screen and MILP, gets the arrays that the dense formulas
    give: the rows of `residual_system()` and of G in float32 restricted
    to the free columns, the rows with no free column dropped, and the
    targets and bounds shifted by the frozen part."""
    prog, jprog = recipe_programs(tmp_path, n_segments=20)
    T = len(prog.pairs)
    K = lns._num_blocks(prog)
    # the root pattern in every clone: nonzero, and every hard row holds;
    # three root loops in clone 0 break its loop-children row (at most 2)
    root = host._pair_idx(prog, prog.start, prog.end)
    x0 = np.zeros(prog.num_vars, dtype=np.int64)
    x0[[k * 2 * T + root for k in range(K)]] = 1
    if incumbent == "violating":
        x0[T + root] = 3
    vio = prog.hard_violation(x0.astype(np.float64))
    assert (vio == 0) == (incumbent == "feasible")

    A_res, c_res = prog.residual_system()
    G = prog.G.astype(np.float32)
    windows = []
    solve_window = lns._solve_window
    sig = inspect.signature(solve_window)

    def spy(*args, **kwargs):
        bound = sig.bind(*args, **kwargs).arguments
        windows.append((bound["x"].copy(), bound["free"].copy(), bound.get("screen_margin"), []))
        return solve_window(*args, **kwargs)

    def highs(*args, **kwargs):
        windows[-1][3].append((args, kwargs))
        return SimpleNamespace(status=9, x=None, fun=None)  # nothing found

    monkeypatch.setattr(lns, "_solve_window", spy)
    monkeypatch.setattr(lns, "milp_lad", highs)
    x, _, _ = lns.lns_polish(prog, x0, time_budget=60.0, probe=probe)
    np.testing.assert_array_equal(x, x0)
    # the endpoint neighbourhood, then windows (a probe of a feasible
    # incumbent stops after the first)
    assert len(windows) >= (1 if probe and incumbent == "feasible" else 2)
    dropped = 0

    for x, free, margin, calls in windows:
        np.testing.assert_array_equal(x, x0)
        F = np.flatnonzero(free)
        ax = A_res @ x.astype(np.float64)
        gx = (G @ x.astype(np.float32)).astype(np.float64)
        A_F = A_res[:, F]
        c_shift = ax - A_F @ x[F]
        keep = np.abs(A_F).sum(axis=1) > 0
        G_F = G[:, F]
        g_shift = gx - G_F @ x[F]
        keep_g = np.abs(G_F).sum(axis=1) > 0
        want = (
            A_F[keep],
            c_res[keep] - c_shift[keep],
            G_F[keep_g],
            prog.g_lb[keep_g] - g_shift[keep_g],
            prog.g_ub[keep_g] - g_shift[keep_g],
            prog.x_ub[F],
        )
        dropped += int((~keep).sum() + (~keep_g).sum())
        assert [kw.get("relax", False) for _, kw in calls] == ([True, False] if margin is not None else [False])
        assert (margin is not None) == (incumbent == "feasible")
        for args, _ in calls:
            for k, (got, w) in enumerate(zip(args[:6], want)):
                assert got.dtype == w.dtype and got.shape == w.shape, k
                np.testing.assert_array_equal(got, w, err_msg=str(k))
    assert dropped > 0  # some window left rows out
    if incumbent == "violating":
        # the columns of the violated rows, freed in every window
        gx = (G @ x0.astype(np.float32)).astype(np.float64)
        np.testing.assert_array_equal(lns._violated_row_cols(prog, gx), jlns._violated_row_cols(jprog, gx))
