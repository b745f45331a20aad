"""search_s_per_case: seconds a case in the tiered device search (solver/search.py).

The program's phases score, summed over the window and divided by its
cases; 0 where the window never entered them. In a cohort the phases
run on several threads at once, so this sums their time over the
threads: occupancy, not wall time.
"""

PHASES = ('score',)


def read(ctx):
    if not ctx.cases:
        return None
    return sum(ctx.phases.get(p, 0.0) for p in PHASES) / ctx.cases
