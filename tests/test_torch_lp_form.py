"""The seeding LP in equality form (solver/host.py `_lp_solve`) against
the benchmark's plain reference (bfbbench/reference.py), which states
the same relaxation in lifted form, on block programs of both of the
benchmark's recipes at a small S (integer targets and read depth) and
on egfr6: the same optimum, an LP solution that keeps every hard row
and bound and fits the residual rows to that optimum, and the counters
`lp.solves` and `lp.iterations`.
"""

import json
import os

import numpy as np
import pytest
import torch

from ambigram_tpu_torch.engine import pipeline
from ambigram_tpu_torch.engine import sc as tsc
from ambigram_tpu_torch.engine.ilp import g_csr
from ambigram_tpu_torch.solver import host
from ambigram_tpu_torch.utils.profiling import GLOBAL
from bfbbench import gen, reference

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EGFR6 = os.path.join(ROOT, "tests", "data", "egfr6.lh")

# (configuration, the recipe's sample, S); None: egfr6
CASES = [
    ("sc_k3_s30", 0, 10),
    ("sc_k3_s30", 1, 12),
    ("sc_k3_s30_depth", 0, 10),
    ("sc_k3_s30_depth", 1, 12),
    None,
]
IDS = ["egfr6" if c is None else "%s_s%d_S%d" % c for c in CASES]


def programs(case, workdir):
    """The port's program of `case` and the reference's."""
    if case is None:
        (prog,) = [p for p in pipeline.extract_programs(EGFR6) if p is not None]
        with open(EGFR6) as f:
            return prog, reference.Program([reference.parse_lh(f.read())])
    config, seed, S = case
    with open(os.path.join(ROOT, "bfbbench", "configs", config + ".json")) as f:
        recipe = json.load(f)["generator"]
    sc = gen.simulate_sc_case(
        seed=seed,
        n_clones=recipe["n_clones"],
        n_segments=S,
        coverage=recipe["coverage"],
        noise=recipe["noise"],
        topology=recipe["topologies"][seed % len(recipe["topologies"])],
    )
    names = gen.write_sc_clones(sc, os.path.join(str(workdir), "%s_%d_c" % (config, seed)))
    (prog,) = [p for p in tsc.extract_sc_programs(",".join(names)) if p is not None]
    return prog, reference.Program([reference.parse_lh(c.lh_text) for c in sc.cases])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bound_is_the_references(case, tmp_path):
    prog, ref = programs(case, tmp_path)
    assert prog.num_vars == ref.V
    lb = host.lp_lower_bound(prog)
    assert lb == pytest.approx(ref.lp_bound(), rel=1e-9, abs=1e-9)
    if case is not None and case[0] == "sc_k3_s30_depth":
        assert host.eps_quantum(prog) == 0.0 and host.certified_bound(prog, lb) == lb


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lp_solution_keeps_the_hard_rows(case, tmp_path):
    """x_frac satisfies every row of G and every bound, and its residual
    fit |R x - c| is the bound: it is an optimum of the lifted form."""
    prog, _ = programs(case, tmp_path)
    lb, x_frac = host.lp_relaxation(prog)
    assert x_frac.shape == (prog.num_vars,)
    gx = g_csr(prog) @ x_frac
    assert np.all(gx <= prog.g_ub + 1e-9) and np.all(gx >= prog.g_lb - 1e-9)
    assert np.all(x_frac >= -1e-9) and np.all(x_frac <= prog.x_ub + 1e-9)
    assert float(prog.residual_objective(x_frac)) == pytest.approx(lb, rel=1e-9, abs=1e-9)


def counted():
    return GLOBAL.counters.get("lp.solves", 0.0), GLOBAL.counters.get("lp.iterations", 0.0)


@pytest.mark.parametrize("case", [CASES[2], None], ids=[IDS[2], "egfr6"])
def test_counters(case, tmp_path):
    """`lp.solves` counts one a call of `_lp_solve`, whichever entry
    makes it; `lp.iterations` adds HiGHS's simplex iterations."""
    prog, _ = programs(case, tmp_path)
    solves, iterations = counted()
    res = host._lp_solve(prog)
    assert res.success and res.nit > 0
    assert counted() == (solves + 1, iterations + res.nit)
    host.lp_lower_bound(prog)
    host.lp_relaxation(prog)
    assert counted()[0] == solves + 3
    Vp = -(-prog.num_vars // 128) * 128
    x_ub = np.zeros(Vp, dtype=np.float32)
    x_ub[: prog.num_vars] = prog.x_ub
    host._seed_case(prog, Vp, x_ub, 12, seed=1)
    assert counted()[0] == solves + 4
