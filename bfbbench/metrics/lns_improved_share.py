"""lns_improved_share: the share of the LNS tail's neighbourhoods whose
result it accepted (solver/lns.py). The program's counter `lns.improved`
over its counter `lns.neighbourhoods`, both summed over the window; None
where no neighbourhood was solved (or the program counts neither)."""


def read(ctx):
    tried = ctx.counters.get("lns.neighbourhoods")
    return ctx.counters.get("lns.improved", 0.0) / tried if tried else None
