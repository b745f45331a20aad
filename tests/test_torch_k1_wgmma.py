"""K1's int8 path as the wgmma kernel runs it, on the CPU.

The kernel (csrc/score_rows.cu) takes one launch per call, cut by a host
rule, `k1_int8_plan`: candidate-stationary or row-streaming, the
candidates a block holds, the ring's stages, the row splits. Here that
rule is held at every program shape the port runs and at ragged ones,
and over a sweep of every shape `k1_planes` admits. Then the kernel's
arithmetic: the candidates truncated to u8 planes as it converts them
(`k1_x_planes`), and its order of the row sum (`k1_tile_sums`, which
`score_rows_int8_plain` uses), against an explicit walk of the threads,
lanes and warps, against K1's plain version and against the JAX
package's Pallas scorer in interpret mode: bitwise on integer targets,
within rel 1e-5 on noisy ones. Last, the f32 expansion of the int8
rows (`_expand_f32`, in place) against JAX's. The kernel itself runs
only on the card (tests/test_torch_cuda.py).
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from ambigram_tpu.solver import score as jscore
from ambigram_tpu_torch.parallel.mesh import stack_cases
from ambigram_tpu_torch.solver import score as tscore
from test_solver import _random_prog
from test_torch_k1_int8 import wide_box_prog
from test_torch_score import candidates, port_from_jax, small_progs

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

SMEM_MAX = 232448
# the variants csrc/score_rows.cu builds: (planes, candidates a warpgroup, mode)
BUILT = {(p, bnw, 0) for p in (1, 2) for bnw in (16, 32, 64)} | {
    (p, bnw, 1) for p in (1, 2) for bnw in (32, 64)
} | {(1, 16, 2), (2, 16, 2)}

# the programs the port's main paths score (PERF.md section 4): rows x Vp,
# planes, and the plan expected at the search's B=32 and at B=1000
PROGRAM_SHAPES = {
    "S=16 proxy": (1024, 384, 1, ("rows", False, 16), ("cands", False, 64)),
    "S=32 batch": (3840, 1152, 1, ("rows", False, 16), ("cands", False, 64)),
    "S=48": (8192, 2432, 1, ("rows", False, 16), ("cands", False, 32)),
    "S=64": (14592, 4224, 1, ("rows", True, 32), ("cands", False, 16)),
    "S=96": (32512, 9344, 2, ("rows", True, 64), ("rows", True, 128)),
    "sc block": (13056, 3200, 1, ("rows", True, 32), ("cands", False, 16)),
}


def check_plan(plan, B, rows, vp, planes, cases):
    """What every plan must hold: a built variant, smem within the
    block's limit and equal to its parts, the ring at least 2 deep, and
    a grid that covers every candidate and every row once."""
    T = rows // 64
    bnw = plan.bn if plan.split_rows else plan.bn // 2
    assert (planes, bnw, plan.mode) in BUILT
    assert plan.nw == planes * bnw and plan.nw in (16, 32, 64, 128)
    assert 2 <= plan.stages <= tscore.K1_MAX_STAGES
    assert plan.smem == tscore.k1_int8_smem(planes, plan.bn, plan.mode, plan.stages, vp) <= SMEM_MAX
    ctiles = -(-B // plan.bn)
    assert plan.grid == (ctiles * cases, plan.splits, 1)
    steps = -(-T // (2 if plan.split_rows else 1))
    assert plan.splits * plan.steps_per_split >= steps > (plan.splits - 1) * plan.steps_per_split
    if plan.order == "cands":
        assert B > 64 and not plan.split_rows
    if plan.direct:
        assert plan.splits == 1


@pytest.mark.parametrize("name", sorted(PROGRAM_SHAPES))
def test_plan_at_every_program_shape(name):
    rows, vp, planes, at32, at1000 = PROGRAM_SHAPES[name]
    for B, want in ((32, at32), (1000, at1000)):
        plan = tscore.k1_int8_plan(B, rows, vp, planes)
        check_plan(plan, B, rows, vp, planes, 1)
        assert (plan.order, plan.split_rows, plan.nw) == want, (name, B, plan)
        # the blocks fill about one wave of the card's 132 SMs, no more
        assert plan.grid[0] * plan.grid[1] <= 132 or plan.splits == 1


def test_plan_at_the_search_population_with_a_case_axis():
    """The batch path's groups (G = 2 to 8 at S=32 and S=48, B=32): one
    wave of blocks, each case's candidates in one tile."""
    for (rows, vp), G in itertools.product(((3840, 1152), (8192, 2432)), (2, 4, 8)):
        plan = tscore.k1_int8_plan(32, rows, vp, 1, G)
        check_plan(plan, 32, rows, vp, 1, G)
        assert plan.order == "rows" and plan.bn == 32 and plan.grid[0] == G
        assert plan.grid[0] * plan.grid[1] <= 132


def test_plan_at_the_row_shard():
    """The sharded step's row shard (73,760 candidates, 1920 x 1152): 128
    candidates a block, resident, each block walking every row, so each
    candidate's f32 bytes are read once and its score summed in
    registers."""
    plan = tscore.k1_int8_plan(73760, 1920, 1152, 1)
    check_plan(plan, 73760, 1920, 1152, 1, 1)
    assert (plan.order, plan.bn, plan.splits, plan.direct) == ("cands", 128, 1, True)
    assert plan.grid == (577, 1, 1) and plan.stages == 8


@pytest.mark.parametrize("planes", [1, 2])
def test_plan_at_ragged_shapes(planes):
    """Rows and Vp 64 more than a multiple of 128 (half a TMA box past
    the edge) and the smallest shape."""
    for rows, vp, B, G in itertools.product((64, 1344, 8256), (64, 576, 2368), (1, 31, 33, 1000), (1, 3)):
        check_plan(tscore.k1_int8_plan(B, rows, vp, planes, G), B, rows, vp, planes, G)


def test_plan_takes_every_shape_k1_planes_admits():
    """A sweep of rows and Vp (multiples of 64 up to S=128's), B from 1
    to the row shard's, 1 or 2 planes and up to 100 cases: every shape
    has a plan, and between them they use all twelve built variants."""
    seen = set()
    for rows, vp, B, planes, G in itertools.product(
        (64, 128, 640, 1920, 8192, 32512, 57600),
        (64, 128, 1152, 2432, 3328, 9344, 16512),
        (1, 31, 32, 33, 64, 65, 1000, 73760),
        (1, 2),
        (1, 8, 100),
    ):
        plan = tscore.k1_int8_plan(B, rows, vp, planes, G)
        check_plan(plan, B, rows, vp, planes, G)
        seen.add((planes, plan.bn if plan.split_rows else plan.bn // 2, plan.mode))
    assert seen == BUILT


def test_plan_refuses_what_k1_planes_refuses():
    for args in ((32, 100, 128, 1), (32, 128, 100, 1), (32, 128, 128, 3), (0, 128, 128, 1), (32, 128, 128, 1, 0)):
        with pytest.raises(ValueError, match="no int8 plan"):
            tscore.k1_int8_plan(*args)


def kernel_walk(terms: np.ndarray) -> np.ndarray:
    """The kernel's sum of one candidate's hinge terms [Rows], written as
    the threads do it, in f32: per 64-row tile, thread (warp w, lane
    group g) adds its rows 16 w + g and + 8; the shuffles add lanes 4, 8
    and 16 apart (each lane's own value plus its partner's); the four
    warps' sums in order; the tiles in order from 0."""
    f = np.float32
    score = f(0.0)
    for tile in range(len(terms) // 64):
        t = terms[64 * tile : 64 * tile + 64]
        warps = []
        for w in range(4):
            v = [f(t[16 * w + g] + t[16 * w + g + 8]) for g in range(8)]
            for bit in (1, 2, 4):
                v = [f(v[g] + v[g ^ bit]) for g in range(8)]
            assert len(set(v)) == 1  # every lane of the group holds the same sum
            warps.append(v[0])
        p = f(f(f(warps[0] + warps[1]) + warps[2]) + warps[3])
        score = f(score + p)
    return score


def test_tile_sums_follow_the_kernel_walk():
    """On fractional terms (where the order shows in the last bits) the
    mirror's vectorised sum equals the walk of the threads bitwise, and
    differs from torch's own sum somewhere."""
    rng = np.random.default_rng(4)
    terms = (rng.random((6, 1344)) * rng.choice([0.0, 1.0, 1024.0], size=(6, 1344))).astype(np.float32)
    got = tscore.k1_tile_sums(torch.as_tensor(terms)).numpy()
    want = np.array([kernel_walk(row) for row in terms], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, torch.as_tensor(terms).sum(dim=-1).numpy())


def test_x_planes_truncate_like_the_kernel():
    """The kernel's conversion of a candidate value (`__float2int_rz`,
    then byte p of the integer for plane p): fractions drop toward zero,
    the high plane carries 256 and up, and 256 hi + lo restores the
    integer."""
    X = torch.tensor([[0.0, 0.75, 1.0, 2.5, 255.0, 255.99, 256.0, 300.4, 65535.0, 65535.9]], dtype=torch.float32)
    q = tscore.k1_x_planes(X, 2)
    assert q.shape == (2, 1, 10) and q.dtype == torch.int32
    np.testing.assert_array_equal(q[0, 0].numpy(), [0, 0, 1, 2, 255, 255, 0, 44, 255, 255])
    np.testing.assert_array_equal(q[1, 0].numpy(), [0, 0, 0, 0, 0, 0, 1, 1, 255, 255])
    np.testing.assert_array_equal((q[0] + 256 * q[1]).numpy(), np.trunc(X.numpy()).astype(np.int32))
    assert torch.equal(tscore.k1_x_planes(X, 1)[0], q[0])


@pytest.mark.parametrize("name", ["egfr6", "rand0", "rand1", "rand2", "rand3"])
def test_mirror_matches_plain_and_pallas_on_integer_targets(name):
    prog = small_progs()[name]
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    assert tscore.k1_planes(tst) == 1
    X = candidates(np.random.default_rng(8), prog, tst.H.shape[1], 256, high=4)
    scores, hx = tscore.score_rows_int8_plain(tst, torch.as_tensor(X), want_hx=True)
    s_plain, hx_plain = tscore.score_rows_plain(tst, torch.as_tensor(X), want_hx=True)
    assert torch.equal(hx, hx_plain) and torch.equal(scores, s_plain)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscore.score_batch_pallas(jst, X, block_b=256)))


def test_mirror_matches_plain_and_pallas_on_two_planes():
    prog = wide_box_prog(seed=7)
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    assert tscore.k1_planes(tst) == 2
    rng = np.random.default_rng(7)
    B, Vp, T = 128, tst.H.shape[1], len(prog.pairs)
    X = np.zeros((B, Vp), dtype=np.float32)
    X[:, : prog.num_vars] = np.minimum(rng.integers(0, 2, size=(B, prog.num_vars)), prog.x_ub)
    X[np.arange(B), T + rng.integers(0, T, size=B)] = rng.integers(256, 401, size=B)
    scores, hx = tscore.score_rows_int8_plain(tst, torch.as_tensor(X), want_hx=True)
    s_plain, hx_plain = tscore.score_rows_plain(tst, torch.as_tensor(X), want_hx=True)
    assert torch.equal(hx, hx_plain) and torch.equal(scores, s_plain)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscore.score_batch_pallas(jst, X, block_b=128)))


def test_mirror_takes_the_case_axis():
    """A stacked group (rows padded with w = 0): bitwise the plain loop
    over the cases and the mirror of each case alone."""
    progs = [_random_prog(np.random.default_rng(50 + k), n) for k, n in enumerate((6, 8, 5))]
    st = stack_cases(progs, "cpu")
    G, _, Vp = st.H.shape
    rng = np.random.default_rng(2)
    X = np.zeros((G, 96, Vp), dtype=np.float32)
    for g, prog in enumerate(progs):
        X[g, :, : prog.num_vars] = np.minimum(rng.integers(0, 3, size=(96, prog.num_vars)), prog.x_ub)
    Xt = torch.as_tensor(X)
    s_i8, hx_i8 = tscore.score_rows_int8_plain(st, Xt, want_hx=True)
    s_p, hx_p = tscore.score_rows_plain(st, Xt, want_hx=True)
    assert torch.equal(hx_i8, hx_p) and torch.equal(s_i8, s_p)
    for g in range(G):
        s_g, _ = tscore.score_rows_int8_plain(st.case(g), Xt[g])
        assert torch.equal(s_g, s_i8[g])


@pytest.mark.parametrize("name", ["egfr6", "rand1", "rand3"])
def test_mirror_on_noisy_targets(name):
    """Fractional segment targets (as the simulated noisy cases have):
    hx stays bitwise, the scores within rel 1e-5 of plain and of the
    Pallas scorer, whose sums run in other orders."""
    prog = small_progs()[name]
    rng = np.random.default_rng(11)
    noisy = dataclasses.replace(prog, c_seg=prog.c_seg + rng.random(len(prog.c_seg)) * 0.6 - 0.3)
    jst = jscore.scoring_tensors(noisy)
    tst = port_from_jax(jst)
    assert tscore.k1_planes(tst) == 1
    X = candidates(rng, noisy, tst.H.shape[1], 256, high=4)
    scores, hx = tscore.score_rows_int8_plain(tst, torch.as_tensor(X), want_hx=True)
    s_plain, hx_plain = tscore.score_rows_plain(tst, torch.as_tensor(X), want_hx=True)
    pallas = np.asarray(jscore.score_batch_pallas(jst, X, block_b=256))
    assert torch.equal(hx, hx_plain)
    for ref in (s_plain.numpy(), pallas):
        np.testing.assert_allclose(scores.numpy(), ref, rtol=1e-5)
    assert not np.array_equal(np.round(scores.numpy()), scores.numpy())  # the targets are fractional


def test_expand_f32_matches_jax_on_one_case():
    """H = w * H8 scaled in place, and the clamped bounds: bitwise JAX's
    jitted `_expand_f32` (integer and fractional bounds, padding rows)."""
    prog = small_progs()["rand2"]
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    rng = np.random.default_rng(6)
    lb_raw = np.asarray(jst.lb_raw) + (rng.random(jst.lb_raw.shape) * 0.5).astype(np.float32)
    args = (np.array(jst.H8), lb_raw, np.array(jst.ub_raw), np.array(jst.w))
    H, lb, ub = tscore._expand_f32(*(torch.as_tensor(a) for a in args))
    jH, jlb, jub = jscore._expand_f32(*args)
    for got, want in ((H, jH), (lb, jlb), (ub, jub)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert H.data_ptr() != tst.H8.data_ptr()
    np.testing.assert_array_equal(H.numpy(), np.asarray(jst.H))


def test_expand_f32_matches_jax_on_a_stacked_pair():
    """The stacked form (leading case axis, rows padded with w = 0):
    bitwise JAX's vmapped `_expand_f32_cases`, and `stack_cases` keeps it."""
    progs = [_random_prog(np.random.default_rng(60 + k), n) for k, n in enumerate((7, 5))]
    st = stack_cases(progs, "cpu")
    args = tuple(getattr(st, k).numpy().copy() for k in ("H8", "lb_raw", "ub_raw", "w"))
    jH, jlb, jub = jscore._expand_f32_cases(*args)
    H, lb, ub = tscore._expand_f32(*(torch.as_tensor(a) for a in args))
    for got, want, kept in ((H, jH, st.H), (lb, jlb, st.lb), (ub, jub, st.ub)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(kept, got)


def test_h8_absmax_from_the_int8_extremes():
    """max |H8| from the int8 tensor's minimum and maximum, widened on
    the host: -128 counts as 128, an all-zero or empty H8 as 0."""
    st = tscore.scoring_tensors(small_progs()["egfr6"], "cpu")
    assert st.h8_absmax() == int(np.abs(st.H8.numpy().astype(np.int16)).max()) == 2
    for H8, want in ((torch.tensor([[3, -128], [0, 7]], dtype=torch.int8), 128),
                     (torch.zeros((2, 64), dtype=torch.int8), 0),
                     (torch.zeros((0, 64), dtype=torch.int8), 0),
                     (torch.tensor([[-5, 4]], dtype=torch.int8), 5)):
        assert dataclasses.replace(st, H8=H8, _h8_absmax=None).h8_absmax() == want
