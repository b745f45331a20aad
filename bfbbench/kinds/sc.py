"""Generator kind `sc`: the K clones of one single-cell sample, each an
LH file of one interval (`gen.simulate_sc_case`), read by the reference
as one block program of K clones.

Recipe keys: `n_clones`, `n_segments`, `coverage`, `noise`, and
`topologies`, of which a case takes the one at its place in the
traffic's list.
"""

from __future__ import annotations

from typing import List, Sequence

from bfbbench import gen, reference


def write(recipe: dict, case_seed: int, index: int, prefix: str) -> List[str]:
    """The sample from `case_seed`, its clones' topology picked by
    `index`: `<prefix>_c<k>.lh` a clone; returns those names."""
    topologies = recipe["topologies"]
    sc = gen.simulate_sc_case(
        seed=case_seed,
        n_clones=recipe["n_clones"],
        n_segments=recipe["n_segments"],
        coverage=recipe["coverage"],
        noise=recipe["noise"],
        topology=topologies[index % len(topologies)],
    )
    return gen.write_sc_clones(sc, prefix + "_c")


def case_program(texts: Sequence[str]):
    """One clone a file; the paths are in the program's ids already."""
    return reference.Program([reference.parse_lh(t) for t in texts]), None
