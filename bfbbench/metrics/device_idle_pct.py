"""device_idle_pct: the share of the traced window in which the device
ran no kernel, copy or memset: 100 x (1 - the union of their intervals
over the window), streams that overlap counted once."""

from bfbbench.trace import busy_seconds


def read(ctx):
    if not ctx.intervals:
        return None
    return 100.0 * (1.0 - busy_seconds(ctx.intervals) / ctx.window_s)
