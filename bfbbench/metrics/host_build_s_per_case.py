"""host_build_s_per_case: seconds a case in the engine's own host work (engine/pipeline.py,
engine/sc.py: parsing, program build, path replay).

The program's phases parse,program_build,replay, summed over the window and divided by its
cases; 0 where the window never entered them. In a cohort the phases
run on several threads at once, so this sums their time over the
threads: occupancy, not wall time.
"""

PHASES = ('parse', 'program_build', 'replay')


def read(ctx):
    if not ctx.cases:
        return None
    return sum(ctx.phases.get(p, 0.0) for p in PHASES) / ctx.cases
