"""PROP line grammar for TRX/insertion/concatenation modes.

Parity target: LocalGenomicMap::readBFBProps
(src/LocalGenomicMap.cpp:3941-3987). Grammar (tokens on
a line beginning with PROP):

    M:<mainChr>            main chromosome for post-BFB merging
    I1:<chr>:<chr>:...     pre-BFB insertion  (mode 1)
    I2:<chr>:<chr>:...     post-BFB insertion (mode 2)
    I:<chr>:...            post-BFB insertion (bare I == mode 2)
    C1:<chr>:<chr>         pre-BFB concatenation
    C2:<chr>:<chr>         post-BFB concatenation
    S:<segId>[:<segId>...] insertion start segments
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class BfbProps:
    main_chr: str = ""
    ins_mode: int = 0
    ins_chr: List[str] = field(default_factory=list)
    con_mode: int = 0
    con_chr: List[str] = field(default_factory=list)
    start_segs: List[int] = field(default_factory=list)


def _split_tail(prop: str, last_pos: int) -> List[str]:
    """Reproduce the find(':')/substr chunking loop (LGM.cpp:3959-3963)."""
    out = []
    while True:
        pos = prop.find(":", last_pos)
        if pos == -1:
            out.append(prop[last_pos:])
            return out
        out.append(prop[last_pos:pos])
        last_pos = pos + 1


def parse_bfb_props(lh_path: str) -> BfbProps:
    """Read PROP directives from an LH file. A missing/unopenable file
    yields empty props (the reference's ifstream getline loop simply
    never runs, LGM.cpp:3943-3945 — this is how sc_bfb's comma-joined
    filename degrades)."""
    props = BfbProps()
    try:
        with open(lh_path, "r") as f:
            lines = f.read().split("\n")
    except OSError:
        return props
    for line in lines:
        tokens = line.split()
        if not tokens or tokens[0] != "PROP":
            continue
        for prop in tokens[1:]:
            if not prop:
                continue
            if prop[0] == "M":
                props.main_chr = prop[2:]
            elif prop[0] == "I":
                if len(prop) > 1 and prop[1] != ":":
                    props.ins_mode = ord(prop[1]) - ord("0")
                    last_pos = 3
                else:
                    props.ins_mode = 2
                    last_pos = 2
                props.ins_chr.extend(_split_tail(prop, last_pos))
            elif prop[0] == "C":
                if len(prop) > 1 and prop[1] != ":":
                    props.con_mode = ord(prop[1]) - ord("0")
                    last_pos = 3
                else:
                    props.con_mode = 2
                    last_pos = 2
                props.con_chr.extend(_split_tail(prop, last_pos))
            elif prop[0] == "S":
                props.start_segs.extend(int(x) for x in _split_tail(prop, 2) if x)
    return props
