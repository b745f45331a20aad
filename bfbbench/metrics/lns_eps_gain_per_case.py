"""lns_eps_gain_per_case: how much the LNS tail lowered eps, a case
(solver/search.py:_finish_solution).

The program's counter `lns.eps_gain` (each tail's eps before it less
its eps after it; 0 where the tail changed nothing, below 0 where
mending a hard violation raised eps), summed over the window and divided
by its cases. None where the window counts no probe (counter
`lns.probes`) and no full polish (phase solve.lns.full), as on a program
without them.
"""


def read(ctx):
    if not ctx.cases or ("lns.probes" not in ctx.counters and "solve.lns.full" not in ctx.phases):
        return None
    return ctx.counters.get("lns.eps_gain", 0.0) / ctx.cases
