"""cases_per_min: every case completed in the window, over the time from
the window's start to the end of its last unit (no unit is cut, none is
left out), times 60."""


def read(ctx):
    return 60.0 * ctx.cases / ctx.window_s if ctx.cases else None
