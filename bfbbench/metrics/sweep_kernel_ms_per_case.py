"""sweep_kernel_ms_per_case: device milliseconds a case in the sweep
kernel's launches (csrc/sweeps.cu: `sweep_score_kernel`,
`sweep_base_kernel`, `sweep_apply_kernel`, `sweep_state_kernel`), by
name from the traced window."""

MARK = "sweep_"


def read(ctx):
    if not ctx.intervals or not ctx.cases:
        return None
    ms = [1e3 * (end - start) for name, start, end in ctx.intervals if MARK in name]
    return sum(ms) / ctx.cases if ms else None
