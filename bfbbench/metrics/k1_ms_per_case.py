"""k1_ms_per_case: device milliseconds a case in K1's launches
(csrc/score_rows.cu: `score_rows_i8`, `score_rows_f32_product`,
`score_rows_f32_finish`, `score_rows_sum`), by name from the traced
window."""

MARK = "score_rows"


def read(ctx):
    if not ctx.intervals or not ctx.cases:
        return None
    ms = [1e3 * (end - start) for name, start, end in ctx.intervals if MARK in name]
    return sum(ms) / ctx.cases if ms else None
