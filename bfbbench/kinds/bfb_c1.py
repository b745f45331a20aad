"""Generator kind `bfb_c1`: a bulk case of the TRX-BFB concatenation
mode, two arms joined by a translocation (`PROP C1:<chrA>:<chrB>`,
`gen_trx.simulate_c1_case`), read by the reference as the one arm they
fuse into (`reference.fuse_c1`), its paths judged on that arm.

Recipe keys: `arms`, `chroms`, `coverage`, `noise`, and `orientations`,
of which a case takes the one at its place in the traffic's list.
"""

from __future__ import annotations

from typing import List, Sequence

from bfbbench import gen_trx, reference


def write(recipe: dict, case_seed: int, index: int, prefix: str) -> List[str]:
    """The case from `case_seed`, its second arm joined in the
    orientation picked by `index`: `<prefix>.lh`; returns that name."""
    orientations = recipe["orientations"]
    case = gen_trx.simulate_c1_case(
        seed=case_seed,
        arms=recipe["arms"],
        chroms=recipe["chroms"],
        coverage=recipe["coverage"],
        noise=recipe["noise"],
        orientation=orientations[index % len(orientations)],
    )
    return gen_trx.write_c1_case(case, prefix)


def case_program(texts: Sequence[str]):
    """The single clone of the one file's fused arm, and the map that
    reads a path in the file's ids on that arm."""
    if len(texts) != 1:
        raise ValueError("a bfb_c1 case is one LH file, not %d" % len(texts))
    fused, fusion = reference.fuse_c1(texts[0])
    return reference.Program([reference.parse_lh(fused)]), fusion
