"""Bulk cases of the TRX-BFB concatenation mode (`PROP C1:<chrA>:<chrB>`,
upstream `concatBeforeBFB`): two arms joined by a translocation, on
which BFB runs as on one fused arm.

A case is one nested BFB loop chain over the fused arm, drawn with the
frozen `gen` functions, its read depths taken by `gen.case_from_path`,
and written back as two chromosomes in their own coordinates: arm A
keeps ids 1..a, arm B takes ids a+1..a+b. Under orientation "+" arm B
is joined as it stands (fused a+i is B's segment a+i, junction
`H:a:+ H:a+1:+`); under "-" it is joined reversed (fused a+i is B's
segment a+b+1-i, junction `H:a:+ H:a+b:-`). The translocation's copy
number is the number of times the truth path crosses the fused a|a+1
boundary. It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from bfbbench import gen

Step = gen.Step
SEG_LEN = START_POS = 1000  # as gen.case_from_path lays out segments


@dataclass
class C1Case:
    arms: Tuple[int, int]
    fused_path: List[Step]  # the truth over the fused arm
    truth_path: List[Step]  # the same in original ids
    crossings: int
    lh_text: str

    @property
    def truth_string(self) -> str:
        return format_original(self.truth_path, self.arms[0])


def to_original(step: Step, arms: Sequence[int], orientation: str) -> Step:
    """A fused step in original ids: arm B's segments reversed, and
    their strands flipped, where it is joined "-"."""
    seg, d = step
    a, b = arms
    if seg <= a or orientation == "+":
        return step
    return a + b + 1 - (seg - a), "-" if d == "+" else "+"


def format_original(path: List[Step], a: int) -> str:
    """`1+2+||60-59-|59+`: `||` where the path changes arm, `|` where it
    turns on one arm."""
    out = []
    for k, (seg, d) in enumerate(path):
        out.append("%d%s" % (seg, d))
        if k + 1 < len(path):
            nxt, nd = path[k + 1]
            if (seg <= a) != (nxt <= a):
                out.append("||")
            elif nd != d:
                out.append("|")
    return "".join(out)


def crossings(fused_path: List[Step], a: int) -> int:
    """How often the fused path steps between a and a+1, either way."""
    return sum(1 for (s1, _), (s2, _) in zip(fused_path, fused_path[1:]) if {s1, s2} == {a, a + 1})


def simulate_c1_case(
    seed: int,
    arms: Sequence[int] = (30, 30),
    chroms: Sequence[str] = ("chr7", "chr12"),
    coverage: float = 30.0,
    noise: float = 0.05,
    orientation: str = "+",
) -> C1Case:
    """One C1 case from `seed`: a nested chain over the fused arm of
    a + b segments, depths as `gen.case_from_path` takes them (with
    noise: SEG depth and CN -1), arm B joined in `orientation`."""
    if orientation not in ("+", "-"):
        raise ValueError("orientation is '+' or '-', not %r" % orientation)
    a, b = int(arms[0]), int(arms[1])
    n = a + b
    rng = np.random.default_rng(seed)
    fused_path = gen.chain_to_path(gen.random_nested_chain(rng, n))
    fused = gen.case_from_path(fused_path, n, rng, seed=seed, coverage=coverage, noise=noise,
                               chrom=chroms[0], seg_len=SEG_LEN, start_pos=START_POS,
                               sample_name="c1_%d" % seed)
    seg_fields = {}  # fused id -> (depth, cn) as the fused case wrote them
    folds = []  # (s1, d1, s2, d2, depth, cn) in fused ids, in the fused case's order
    head = []
    for line in fused.lh_text.splitlines():
        tok = line.split()
        if tok[0] == "SEG":
            seg_fields[int(tok[1].split(":")[1])] = (tok[2], tok[3])
        elif tok[0] == "JUNC":
            x, y = tok[1].split(":"), tok[2].split(":")
            folds.append((int(x[1]), x[2], int(y[1]), y[2], tok[3], tok[4]))
        elif tok[0] not in ("SOURCE", "SINK"):
            head.append(line)

    def original(seg):
        return to_original((seg, "+"), (a, b), orientation)[0]

    lines = head + ["SOURCE 1,%d" % (a + 1), "SINK %d,%d" % (a, n)]
    by_original = {original(f): fields for f, fields in seg_fields.items()}
    for o in range(1, n + 1):
        chrom, first = (chroms[0], 1) if o <= a else (chroms[1], a + 1)
        s = START_POS + (o - first) * SEG_LEN
        depth, cn = by_original[o]
        lines.append("SEG H:%d:%s:%d:%d %s %s" % (o, chrom, s, s + SEG_LEN - 1, depth, cn))
    for s1, d1, s2, d2, depth, cn in folds:
        (o1, e1), (o2, e2) = to_original((s1, d1), (a, b), orientation), to_original((s2, d2), (a, b), orientation)
        lines.append("JUNC H:%d:%s H:%d:%s %s %s U B" % (o1, e1, o2, e2, depth, cn))
    cross = crossings(fused_path, a)
    far_end = "H:%d:+" % (a + 1) if orientation == "+" else "H:%d:-" % n
    lines.append("JUNC H:%d:+ %s %g %g U B" % (a, far_end, cross * coverage / 2.0, float(cross)))
    lines.append("PROP C1:%s:%s" % (chroms[0], chroms[1]))
    truth = [to_original(step, (a, b), orientation) for step in fused_path]
    return C1Case((a, b), fused_path, truth, cross, "\n".join(lines) + "\n")


def write_c1_case(case: C1Case, prefix: str) -> List[str]:
    """`<prefix>.lh` and the truth beside it; returns the LH file name
    as the one file of the case."""
    with open(prefix + ".lh", "w") as f:
        f.write(case.lh_text)
    with open(prefix + "_truth.txt", "w") as f:
        f.write(case.truth_string + "\n")
    return [prefix + ".lh"]
