"""The sweep kernel's sparse formulation, on the CPU.

On a card the sweeps (csrc/sweeps.cu) read H as sparse columns
(`sweeps.sparse_columns`) and score a move as its member's dense hinge
sum plus the change of the hinge over U_m, the rows that the move's
columns touch. Here, without a card:

- the sparse columns rebuild H exactly, for one case and for a
  case-stacked group whose padding columns are empty;
- the plain mirror of that formulation (`move_scores_sparse_plain`)
  gives the dense `move_scores_plain` bitwise on integer targets (every
  f32 sum exact) and within rtol 1e-5 on noisy ones;
- the kernel's selection (the lexicographic minimum of (score, position)
  over the valid moves, then `best < base - 1e-6`) made from the
  mirror's scores, and the apply over U_m, land where JAX's
  `_sweep_delta`, `_sweep_moves` and `_sweep_moves3` land, bitwise;
- the one-max hinge's precondition lb <= ub is checked.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ambigram_tpu.parallel import mesh as jmesh
from ambigram_tpu.solver import score as jscore
from ambigram_tpu.solver import search as jsearch
from ambigram_tpu_torch.engine.pipeline import extract_programs
from ambigram_tpu_torch.parallel.mesh import stack_cases
from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case
from ambigram_tpu_torch.solver import sweeps
from ambigram_tpu_torch.solver.score import score_rows_plain
from test_solver import _random_prog
from test_torch_batch import start_states
from test_torch_score import port_from_jax
from test_torch_sweep_gates import _jax_tie_tensors
from test_torch_sweeps import JAX_SWEEPS, as_port_index, catalogues, lockstep_prog, start_state

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

KINDS = ("delta", "moves", "moves3")
# (program, kind): every kind on three programs, the hand-built triple
# catalogue on the triple sweep
CASES = [(name, kind) for name in ("egfr6", "rand14", "tie") for kind in KINDS] + [("triple_bc", "moves3")]


def triple_bc_catalogue(prog, seed=11, n=300, pad_to=512):
    """A hand-built triple catalogue over the program's variables: random
    (a, b, c) with every third move b == c, both signs, and padding moves
    (valid False) at the tail. numpy, seeded."""
    rng = np.random.default_rng(seed)
    V = prog.num_vars
    a, b, c = (rng.integers(0, V, size=n).astype(np.int32) for _ in range(3))
    c[::3] = b[::3]
    M = ((2 * n + pad_to - 1) // pad_to) * pad_to
    out = [np.zeros(M, dtype=np.int32) for _ in range(3)]
    for t, src in zip(out, (a, b, c)):
        t[: 2 * n] = np.concatenate([src, src])
    s = np.ones(M, dtype=np.float32)
    s[n : 2 * n] = -1.0
    valid = np.zeros(M, dtype=bool)
    valid[: 2 * n] = True
    return (*out, s, valid)


def program_state(name, kind):
    """(jax tensors, X, hx, scores, catalogue) of an integer-target program:
    egfr6, rand14 (two variable chunks), the tie case, or rand14 with the
    hand-built triple catalogue (b == c moves and padding)."""
    if name == "tie":
        jst, X, hx, scores, moves, moves3 = _jax_tie_tensors()
        return jst, X, hx, scores, {"delta": (), "moves": moves, "moves3": moves3}[kind]
    prog = lockstep_prog("rand14" if name == "triple_bc" else name)
    jst = jscore.scoring_tensors(prog)
    X, hx, scores = start_state(prog, jst, seed=4)
    cat = triple_bc_catalogue(prog) if name == "triple_bc" else catalogues(prog, kind)
    return jst, X, hx, scores, cat


def noisy_progs(tmp_path, seeds=(1, 2), n_segments=16):
    """Simulated programs with fractional targets (noise 0.05), one
    interval so they stack."""
    progs = []
    for seed in seeds:
        case = simulate_bfb_case(seed=seed, n_segments=n_segments, noise=0.05, mode="process")
        progs.append(extract_programs(write_case(case, str(tmp_path / ("n%d" % seed)))["lh"])[0])
    return progs


# ------------------------------------------------------------ the columns


@pytest.mark.parametrize("case", ["egfr6", "rand14", "stacked"])
def test_sparse_columns_rebuild_H(case):
    """The entries rebuild H.T bitwise, their support is H's, each column
    is sorted by row and ends in one sentinel, and the counts are H's;
    a case-stacked group (different widths and rows) leaves its padding
    columns empty. Built once per program, then cached."""
    if case == "stacked":
        progs = [_random_prog(np.random.default_rng(s), n) for s, n in ((1, 9), (2, 14), (3, 12))]
        st = stack_cases(progs, "cpu")
        widths = [p.num_vars for p in progs]
    else:
        st = port_from_jax(jscore.scoring_tensors(lockstep_prog(case)))
        widths = [st.num_vars]
    sp = sweeps.sparse_columns(st)
    assert sweeps.sparse_columns(st) is sp
    H = st.H if st.H.dim() == 3 else st.H[None]
    HT, support = sp.dense()
    assert torch.equal(HT, H.transpose(1, 2))
    assert torch.equal(support, H.transpose(1, 2) != 0)
    counts = (H != 0).sum(dim=1)  # [G, Vp]
    assert torch.equal(sp.ptr[:, 1:] - sp.ptr[:, :-1] - 1, counts.to(torch.int32))
    assert sp.max_count == int(counts.max()) and sp.nnz == int(counts.sum())
    assert torch.equal(sp.bnd, torch.stack([st.lb, st.ub], dim=-1).reshape(sp.bnd.shape))
    for g, width in enumerate(widths):
        assert int(counts[g, width:].sum()) == 0  # padding columns are empty
        for v in range(0, H.shape[-1], 7):
            lo, hi = int(sp.ptr[g, v]), int(sp.ptr[g, v + 1])
            rows = sp.ent[g, lo:hi, 0]
            assert int(rows[-1]) == sweeps.END and bool((rows[1:] > rows[:-1]).all())


def test_catalogue_uploads_are_cached():
    """A catalogue's device copies are made once per program and reused by
    every later descent's `SweepOps`."""
    prog = lockstep_prog("rand14")
    st = port_from_jax(jscore.scoring_tensors(prog))
    sp = sweeps.sparse_columns(st)
    cat = tuple(as_port_index(a) for a in catalogues(prog, "moves3"))
    first = sweeps._catalogue(sp, 2, cat, 128, torch.device("cpu"))
    assert sweeps._catalogue(sp, 2, cat, 128, torch.device("cpu")) is first
    assert first[0].dtype == torch.int32 and first[-1] == (len(cat[0]) // 128) * 128


def test_lb_above_ub_is_refused():
    """The kernel's hinge max(max(v - ub, lb - v), 0) is the plain one only
    while lb <= ub: a program with a row that breaks it is refused."""
    st = port_from_jax(jscore.scoring_tensors(lockstep_prog("egfr6")))
    lb = st.lb.clone()
    lb[0] = st.ub[0] + 1.0
    bad = dataclasses.replace(st, lb=lb, _sparse=None)
    with pytest.raises(ValueError, match="lb > ub"):
        sweeps.sparse_columns(bad)
    hx = torch.zeros((2, st.H.shape[0]))
    with pytest.raises(ValueError, match="lb > ub"):
        sweeps.move_scores_sparse_plain("delta", bad, hx)


# ----------------------------------------------------------- the mirror


@pytest.mark.parametrize("name, kind", CASES)
def test_sparse_mirror_equals_dense_move_scores(name, kind):
    """On integer targets base + the sum over U_m of the hinge's change
    equals the dense hinge sum of every move bitwise."""
    jst, X, hx, scores, cat = program_state(name, kind)
    st = port_from_jax(jst)
    tcat = tuple(as_port_index(a) for a in cat)
    want = sweeps.move_scores_plain(kind, st, torch.as_tensor(hx), *tcat)
    got = sweeps.move_scores_sparse_plain(kind, st, torch.as_tensor(hx), *tcat)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_sparse_mirror_on_a_stacked_group(kind):
    """Three case-stacked programs of one interval (padding rows where a
    case has fewer): bitwise against the dense move scores."""
    progs = [_random_prog(np.random.default_rng(20 + g), 12) for g in range(3)]
    jst = jmesh.stack_cases(progs)
    st = port_from_jax(jst)
    X, hx = start_states(progs, jst, B=8)
    cat = tuple(as_port_index(a) for a in catalogues(progs[0], kind))
    want = sweeps.move_scores_plain(kind, st, torch.as_tensor(hx), *cat)
    got = sweeps.move_scores_sparse_plain(kind, st, torch.as_tensor(hx), *cat)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_sparse_mirror_on_noisy_targets(tmp_path, kind):
    """Fractional targets: the hinges round, and base + a sum of changes
    rounds differently from the dense sum; within rtol 1e-5 (the bar the
    card holds the kernel to)."""
    progs = noisy_progs(tmp_path)
    st = stack_cases(progs, "cpu")
    x_ub = st.x_ub.numpy()
    rng = np.random.default_rng(7)
    X = np.stack([np.minimum(rng.integers(0, 3, size=x_ub.shape[1]), x_ub[g]) for g in range(len(progs))
                  for _ in range(4)]).reshape(len(progs), 4, -1).astype(np.float32)
    _, hx = score_rows_plain(st, torch.as_tensor(X), want_hx=True)
    cat = tuple(as_port_index(a) for a in catalogues(progs[0], kind))
    want = sweeps.move_scores_plain(kind, st, hx, *cat)
    got = sweeps.move_scores_sparse_plain(kind, st, hx, *cat)
    rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    assert rel <= 1e-5


# --------------------------------------------- the selection, against JAX


def sparse_sweep(kind, st, X, hx, scores, *cat, chunk=128):
    """The kernel's sweep of one case in plain torch: the mirror's scores,
    the first minimum of (score, position) over the valid moves, the
    kernel's improvement rule (against the member's dense hinge sum, its
    base), and the apply, hx changing on U_m only."""
    ms = sweeps.move_scores_sparse_plain(kind, st, hx, *cat, chunk=chunk)
    valid = sweeps.move_valid_plain(kind, X, st.x_ub, *cat, chunk=chunk)
    masked = torch.where(valid, ms, float("inf"))
    idx = torch.argmin(masked, dim=-1)  # the first minimum
    val = masked.gather(-1, idx[:, None])[:, 0]
    sp = sweeps.sparse_columns(st)
    base = sweeps._hinge1(sp.bnd[0, :, 0], sp.bnd[0, :, 1], hx).sum(dim=-1)
    improved = val < base - 1e-6
    HT, U = sp.dense()
    HT, U = HT[0], U[0]
    Vp = X.shape[-1]
    if kind == "delta":
        var = (idx // (2 * chunk)) * chunk + idx % chunk
        sign = torch.where(idx % (2 * chunk) < chunk, 1.0, -1.0)
        X_new = torch.minimum(torch.clamp(X + F.one_hot(var, Vp) * sign[:, None], min=0.0), st.x_ub)
        col, support = HT[var] * sign[:, None], U[var]
    elif kind == "moves":
        mm, mp = cat[0][idx], cat[1][idx]
        X_new = X + F.one_hot(mp, Vp).float() - F.one_hot(mm, Vp).float()
        col, support = HT[mp] - HT[mm], U[mp] | U[mm]
    else:
        a, b, c, s = (t[idx] for t in cat[:4])
        X_new = X + (F.one_hot(b, Vp).float() + F.one_hot(c, Vp).float() - F.one_hot(a, Vp).float()) * s[:, None]
        col = (HT[b] + HT[c] - HT[a]) * s[:, None]
        support = U[a] | U[b] | U[c]
    hx_new = torch.where(support, hx + col, hx)
    imp = improved[:, None]
    return (torch.where(imp, X_new, X), torch.where(imp, hx_new, hx), torch.where(improved, val, scores),
            improved.any())


@pytest.mark.parametrize("name, kind", CASES)
def test_sparse_selection_matches_jax(name, kind):
    """Four sweeps in lockstep: the kernel's selection and apply over the
    mirror's scores give JAX's X', hx', scores' and improved flag bitwise
    (integer targets)."""
    jst, X, hx, scores, cat = program_state(name, kind)
    st = port_from_jax(jst)
    jcat = tuple(jnp.asarray(a) for a in cat)
    tcat = tuple(as_port_index(a) for a in cat)
    jX, jhx, js = jnp.asarray(X), jnp.asarray(hx), jnp.asarray(scores)
    n_improved = 0
    for step in range(4 if name != "tie" else 1):
        got = sparse_sweep(kind, st, *(torch.as_tensor(np.array(a)) for a in (jX, jhx, js)), *tcat)
        jX, jhx, js, jimp = JAX_SWEEPS[kind](jst, jX, jhx, js, *jcat)
        msg = "%s %s step %d" % (name, kind, step)
        for t, j in zip(got[:3], (jX, jhx, js)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)
        assert bool(got[3]) == bool(jimp), msg
        n_improved += bool(jimp)
    assert n_improved >= 1
