"""lp_iterations_per_case: HiGHS's simplex iterations a case in the LP
seeding and bound on the host (solver/host.py `_lp_solve`).

The program's counter `lp.iterations` (each LP's iterations, summed
over the window) over the window's cases. It does not depend on the
host's speed. None where the program counts no `lp.solves`, as on a
program without these counters.
"""


def read(ctx):
    if "lp.solves" not in ctx.counters or not ctx.cases:
        return None
    return ctx.counters.get("lp.iterations", 0.0) / ctx.cases
