"""lns_milp_capped_share: the share of the LNS tail's window MILPs that
stopped on their time limit (solver/lns.py:_solve_window, HiGHS status
1). Where such a MILP's proposal is accepted, the answer depends on the
host's speed.

The program's counter `lns.milp_capped` over its counter `lns.milps`
(each MILP solved after its LP screen), both summed over the window.
None where no MILP ran, or where the window counts no probe (counter
`lns.probes`) and no full polish (phase solve.lns.full), as on a program
without them.
"""


def read(ctx):
    if "lns.probes" not in ctx.counters and "solve.lns.full" not in ctx.phases:
        return None
    solved = ctx.counters.get("lns.milps")
    return ctx.counters.get("lns.milp_capped", 0.0) / solved if solved else None
