"""The port's host helpers, descent, search and host tail against the
JAX package.

The host helpers are copies and must return equal arrays, but for the
seeding LP, which the port states in equality form: its bound and
certificate equal JAX's, its solution is an optimum of JAX's lifted
form, and the population's LP-rounding rows round it. The tiered
descent is deterministic, so from identical inputs it must match JAX
bitwise. A whole search draws its kicks from a torch.Generator, not
jax.random, so it is judged on quality: it must reach the solve_exact
optimum, as tests/test_solver.py asks of the JAX search.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ambigram_tpu.solver import lns as jlns
from ambigram_tpu.solver import score as jscore
from ambigram_tpu.solver import search as jsearch
from ambigram_tpu.solver.exact import solve_exact
from ambigram_tpu_torch.solver import host, search
from ambigram_tpu_torch.solver import lns as tlns
from ambigram_tpu_torch.solver.score import score_rows
from test_solver import _egfr_prog, _random_prog
from test_torch_g_csr import recipe_programs
from test_torch_score import port_from_jax, small_progs
from test_torch_sweeps import as_port_index, start_state

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

NAMES = ["egfr6", "rand0", "rand1", "rand2", "rand3"]


@pytest.fixture
def small_search(monkeypatch):
    monkeypatch.setenv("AMBIGRAM_SEARCH_POP", "8")
    monkeypatch.setenv("AMBIGRAM_SEARCH_ROUNDS", "3")
    monkeypatch.setenv("AMBIGRAM_SEARCH_SWEEPS", "64")


def lp_roundings(prog, x_frac, Vp, seed):
    """Population rows 4-9 as `_seed_case` places them: the LP
    solution's rounding, its floor and four randomized roundings."""
    rows = np.zeros((6, Vp), dtype=np.float32)
    rr = np.random.default_rng(seed + 1)
    floor = np.floor(x_frac)
    members = [np.round(x_frac), floor] + [floor + (rr.random(len(x_frac)) < x_frac - floor) for _ in range(4)]
    for row, member in zip(rows, members):
        row[: prog.num_vars] = np.clip(member, 0, prog.x_ub)
    return rows


@pytest.mark.parametrize("name", NAMES + ["sc_k3"])
def test_host_helpers_match_jax(name, tmp_path):
    """`sc_k3`: a K=3 block program of the benchmark's recipe at S=10,
    each package's own build, so the port's seeding LP reads the CSR its
    builders attach. The port states the seeding LP in equality form
    and the JAX package in lifted form: the same optimum, but HiGHS may
    stop at another optimal vertex, so the port's LP solution is held to
    the lifted form's rows and optimum, and the LP-rounding rows of the
    population to that solution."""
    if name == "sc_k3":
        prog, jprog = recipe_programs(tmp_path)
    else:
        prog = jprog = small_progs()[name]
    for a, b in zip(host.slide_transfer_moves(prog), jsearch.slide_transfer_moves(jprog)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(host.split_merge_moves(prog), jsearch.split_merge_moves(jprog)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(host.greedy_peel_seed(prog), jsearch.greedy_peel_seed(jprog))
    Vp = max(128, -(-prog.num_vars // 128) * 128)
    x_ub = np.zeros(Vp, dtype=np.float32)
    x_ub[: prog.num_vars] = prog.x_ub
    X_t, lb_t = host._seed_case(prog, Vp, x_ub, 12, seed=4)
    X_j, lb_j = jsearch._seed_case(jprog, Vp, x_ub, 12, seed=4)
    np.testing.assert_array_equal(X_t[:4], X_j[:4])
    np.testing.assert_array_equal(X_t[10:], X_j[10:])
    bound, x_frac = host.lp_relaxation(prog)
    np.testing.assert_array_equal(X_t[4:10], lp_roundings(prog, x_frac, Vp, seed=4))
    assert lb_t == bound == host.lp_lower_bound(prog)
    assert lb_j == jsearch.lp_lower_bound(jprog)
    assert lb_t == pytest.approx(lb_j, rel=1e-9, abs=1e-9)
    # x_frac with e = |R x - c| is a point of the lifted LP: G's rows and
    # the bounds hold, and its objective there is the optimum
    gx = np.asarray(jprog.G, dtype=np.float64) @ x_frac
    assert np.all(gx <= jprog.g_ub + 1e-9) and np.all(gx >= jprog.g_lb - 1e-9)
    assert np.all(x_frac >= -1e-9) and np.all(x_frac <= jprog.x_ub + 1e-9)
    assert float(jprog.residual_objective(x_frac)) == pytest.approx(lb_j, rel=1e-9, abs=1e-9)
    assert host.eps_quantum(prog) == jsearch.eps_quantum(jprog)
    assert host.certified_bound(prog, lb_t) == jsearch.certified_bound(jprog, lb_j)
    for v in (0.0, 0.2, 0.5, 1.49, 2.0000001, 7.75):
        assert host.half_ceil(v) == jsearch.half_ceil(v)


def test_eps_quantum_on_noisy_program(tmp_path):
    from ambigram_tpu.engine.pipeline import extract_programs
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

    case = simulate_bfb_case(seed=0, n_segments=10, rounds=3, mode="process", noise=0.05)
    prog = extract_programs(write_case(case, str(tmp_path / "noisy"))["lh"])[0]
    assert host.eps_quantum(prog) == jsearch.eps_quantum(prog) == 0.0
    lb = host.lp_lower_bound(prog)
    assert host.certified_bound(prog, lb) == jsearch.certified_bound(prog, lb) == lb


_jax_descend = jax.jit(jsearch._descend_loop, static_argnames=("max_sweeps", "chunk"))


@pytest.mark.parametrize("name", ["egfr6", "rand14"])
def test_descend_loop_matches_jax(name):
    """The host-loop tiered descent takes the same sweeps as JAX's
    while_loop/cond version and lands on the same X, hx and scores."""
    from test_torch_sweeps import lockstep_prog

    prog = lockstep_prog(name)
    jst = jscore.scoring_tensors(prog)
    tst = port_from_jax(jst)
    X, hx, scores = start_state(prog, jst, seed=9)
    moves = host.slide_transfer_moves(prog)
    moves3 = host.split_merge_moves(prog)
    jout = _jax_descend(
        jst, jnp.asarray(X), jnp.asarray(hx), jnp.asarray(scores),
        max_sweeps=64, chunk=128,
        moves=tuple(jnp.asarray(a) for a in moves),
        moves3=tuple(jnp.asarray(a) for a in moves3),
    )
    tout = search.descend_loop(
        tst, torch.as_tensor(X), torch.as_tensor(hx), torch.as_tensor(scores), 64, 128,
        tuple(as_port_index(a) for a in moves), tuple(as_port_index(a) for a in moves3),
    )
    for t, j in zip(tout[:3], jout[:3]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tuple(tout[3:]) == tuple(int(v) for v in jout[3:])
    assert tout[4] >= 1 and tout[5] >= 1  # every tier ran


def test_search_impl_rescoring_uses_score_rows(monkeypatch):
    """The search of one case (a group of one): both full rescorings
    (the start and each kick) go through K1's wrapper, 1 + rounds calls
    on the whole [1, B, Vp] group."""
    calls = []

    def counting(st, X, want_hx=False):
        calls.append(tuple(X.shape))
        return score_rows(st, X, want_hx)

    monkeypatch.setattr(search, "score_rows", counting)
    prog = _egfr_prog()
    from ambigram_tpu_torch.parallel.mesh import stack_cases

    st = stack_cases([prog], "cpu")
    X0 = torch.zeros((1, 8, st.H.shape[-1]))
    _, best_s, _, _ = search.batch_search(
        st, X0, [torch.Generator().manual_seed(0)], rounds=3, max_sweeps=16, patience=5
    )
    assert calls == [(1, 8, st.H.shape[-1])] * (1 + 3)
    assert best_s.shape == (1,) and np.isfinite(float(best_s[0]))


def test_solve_device_finds_exact_optimum_egfr6(small_search):
    prog = _egfr_prog()
    res = search.solve_device(prog, device="cpu")
    assert res.epsilon_sum == pytest.approx(solve_exact(prog).epsilon_sum)
    assert float(prog.hard_violation(res.x.astype(float))) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_solve_device_matches_exact_random(seed, small_search):
    rng = np.random.default_rng(seed)
    prog = _random_prog(rng, n=rng.integers(4, 8))
    ref = solve_exact(prog)
    assert ref.status == "optimal"
    res = search.solve_device(prog, device="cpu")
    assert float(prog.hard_violation(res.x.astype(float))) == 0.0
    assert res.epsilon_sum == pytest.approx(ref.epsilon_sum, abs=1e-6)


def test_solve_device_counts_and_phases(small_search):
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    GLOBAL.reset()
    search.solve_device(_egfr_prog(), device="cpu")
    assert GLOBAL.counters["solve.device_calls"] == 1
    assert GLOBAL.counters["candidates_scored"] > 0
    assert GLOBAL.counters["search.delta_sweeps"] >= 1
    for phase in ("solve.tensors", "solve.lp_bound", "score"):
        assert GLOBAL.phases[phase].calls >= 1


def test_solve_device_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.solve_device(_egfr_prog(), device="cuda")


def test_lns_polish_matches_jax_copy():
    """The port's lns.py is a copy: from the same start (the greedy
    seed, which violates hard rows here) it returns the same repaired
    point. The windows are tiny, so no time limit decides the result."""
    prog = _random_prog(np.random.default_rng(0), n=6)
    x0 = np.round(host.greedy_peel_seed(prog)).astype(np.int64)
    assert prog.hard_violation(x0.astype(np.float64)) > 0
    got = tlns.lns_polish(prog, x0, time_budget=30.0)
    want = jlns.lns_polish(prog, x0, time_budget=30.0)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[2] == 0.0



def _determinism_prog():
    """The program of tests/test_determinism.py, built by the port."""
    from ambigram_tpu_torch.engine.ilp import build_bfb_program

    seg = np.array([2.0, 6.0, 8.0, 8.0, 4.0, 4.0])
    fbi = np.array([0.0, 2.0, 1.0, 2.0, 0.0, 2.0])
    return build_bfb_program(1, 6, seg, fbi, 32, 1)


def test_device_search_deterministic():
    """The port's counterpart of tests/test_determinism.py's
    test_device_search_deterministic: one program, seed 3, twice, at the
    default budgets, gives the same x and eps."""
    prog = _determinism_prog()
    r1 = search.solve_device(prog, seed=3, device="cpu")
    r2 = search.solve_device(prog, seed=3, device="cpu")
    assert np.array_equal(r1.x, r2.x)
    assert r1.epsilon_sum == r2.epsilon_sum


def _spy_dispatch(monkeypatch):
    calls = []
    real = search._dispatch

    def spy(group, seeds, kick_seeds, device, **kw):
        d = real(group, seeds, kick_seeds, device, **kw)
        calls.append((len(group), list(seeds), list(kick_seeds), kw, d))
        return d

    monkeypatch.setattr(search, "_dispatch", spy)
    return calls


@pytest.mark.parametrize("seed", [0, 5])
def test_seed_offsets_population_and_kicks_as_jax(seed, monkeypatch, small_search):
    """`seed` offsets the seeds as the JAX package's does
    (ambigram_tpu/solver/search.py: `_seed_case(..., seed + idxs[k])`,
    kicks from `PRNGKey(seed + k)` in a group, a lone case `seed + i` for
    both): a group of three same-interval programs is padded to four
    with the last repeated; a lone case keeps its own index. A lone
    case's batch search is the single-case search, bitwise."""
    calls = _spy_dispatch(monkeypatch)
    rng = np.random.default_rng(0)
    a = _random_prog(rng, n=5)
    b = _egfr_prog()
    res = search.solve_device_batch([a, b, a, a], seed=seed, device="cpu")
    # both groups are in flight at once, so they may finish in either order
    batch_calls = sorted(calls, key=lambda c: -c[0])
    assert [c[:3] for c in batch_calls] == [
        (4, [seed + 0, seed + 2, seed + 3, seed + 3], [seed + k for k in range(4)]),
        (1, [seed + 1], [seed + 1]),
    ]
    lone = search.solve_device(b, seed=seed + 1, device="cpu")
    np.testing.assert_array_equal(lone.x, res[1].x)
    assert lone.epsilon_sum == res[1].epsilon_sum
    np.testing.assert_array_equal(batch_calls[1][4]["best_x"].numpy(), calls[2][4]["best_x"].numpy())


def test_budget_arguments_override_the_env_knobs(monkeypatch, small_search):
    """pop/rounds/max_sweeps given override the env knobs; without
    `certify` the search does not stop at the LP bound and the status
    stays heuristic; without `polish` no LNS runs."""
    from ambigram_tpu_torch.utils.profiling import GLOBAL

    calls = _spy_dispatch(monkeypatch)
    prog = _random_prog(np.random.default_rng(3), n=6)
    GLOBAL.reset()
    res = search.solve_device(prog, pop=4, rounds=1, max_sweeps=2, certify=False, polish=False, device="cpu")
    d = calls[0][4]
    assert d["pop"] == 4 and calls[0][3]["certify"] is False
    assert float(d["targets"][0]) == 0.0
    assert d["sweeps"][0] <= 2
    assert res.status == "heuristic" and "solve.lns" not in GLOBAL.phases
    env = search._budgets()
    assert env[:3] == (8, 3, 64)
    assert search._budgets(pop=4, rounds=1, max_sweeps=2) == (4, 1, 2, env[3])
