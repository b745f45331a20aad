"""device_calls_per_case: the program's counter `solve.device_calls`
(one a device search call, a case-stacked group counting once) over the
window's cases."""


def read(ctx):
    calls = ctx.counters.get("solve.device_calls")
    return calls / ctx.cases if calls is not None and ctx.cases else None
