"""eps_lp_ratio: the quality of the answers. The mean, over the window's
cases (whole cycles, so every case of the cycle counts alike), of the
epsilon of the program's answer over the reference's LP bound for that
case: at least 1, and 1 where the answer is provably optimal. The
reference works both out from the generated LH files."""


def read(ctx):
    ratios = [v.lp_ratio for v in ctx.verdicts if v is not None]
    return sum(ratios) / len(ratios) if ratios else None
