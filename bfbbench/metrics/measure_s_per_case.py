"""measure_s_per_case: seconds a case in the host tail's measurement of
the search's incumbent (solver/search.py:_finish_solution: its eps, its
hard violation, its certified target; the hard violation is the product
of x with the CSR of the program's hard rows G, engine/ilp.py:g_csr).

The program's phase solve.measure, summed over the window and divided by
its cases; None where the program has no such phase. In a cohort the
tails run on several threads at once, so this sums their time over the
threads: occupancy, not wall time.
"""

PHASE = "solve.measure"


def read(ctx):
    if not ctx.cases or PHASE not in ctx.phases:
        return None
    return ctx.phases[PHASE] / ctx.cases
