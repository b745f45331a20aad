"""lns_full_s_per_case: seconds a case in the LNS tail's full polish
(solver/search.py:_finish_solution: the sliding-window polish of a
budget-starved or violating incumbent, or the escalation after a probe
that improved).

The program's phase solve.lns.full, summed over the window and divided
by its cases; 0 where the tail ran only probes. None where the window
counts no probe (counter `lns.probes`) and no full polish, as on a
program without them. In a cohort this sums over the threads:
occupancy, not wall time.
"""

PHASE = "solve.lns.full"


def read(ctx):
    if not ctx.cases or (PHASE not in ctx.phases and "lns.probes" not in ctx.counters):
        return None
    return ctx.phases.get(PHASE, 0.0) / ctx.cases
