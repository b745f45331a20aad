"""The benchmark's case generator: a frozen copy of the port's
`scripts/simulate.py` (`simulate_bfb_case` in its "process" mode,
`simulate_sc_case`, `case_from_path`, `write_case`, `write_sc_clones`
and their helpers, without the options no configuration uses), so that
no later change to the program moves the inputs. It imports nothing of
the program.

One departure: `chain_to_path` replays a nested loop chain by the rule
the program's DAG replay follows for such chains (each loop is a fold
pair; a child that shares its parent's right end is walked from that
end at the parent's fold there, one that shares the left end is walked
from the left at the parent's fold at that end, or after the root
returns), instead of calling the program's replay.
`tests/test_bfbbench_gen.py` holds it equal to the program's on
random chains.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

Step = Tuple[int, str]  # (segment id, '+'/'-')


@dataclass
class BfbCase:
    n_segments: int
    truth_path: List[Step]
    seg_cn: np.ndarray
    fbi: Dict[int, int]
    coverage: float
    lh_text: str
    sv_text: str
    seg_text: str

    @property
    def truth_string(self) -> str:
        return format_steps(self.truth_path)


def format_steps(path: List[Step]) -> str:
    """`1+2+|2-1-`: a `|` wherever the direction turns."""
    out = []
    for k, (seg, d) in enumerate(path):
        out.append("%d%s" % (seg, d))
        if k + 1 < len(path) and path[k + 1][1] != d:
            out.append("|")
    return "".join(out)


def bfb_process(rng: np.random.Generator, n_segments: int, rounds: int) -> List[Step]:
    """`rounds` break-fusion-bridge cycles on the arm 1..n."""
    path: List[Step] = [(i, "+") for i in range(1, n_segments + 1)]
    for _ in range(rounds):
        b = int(rng.integers(1, len(path)))
        prefix = path[:b]
        mirrored = [(seg, "-" if d == "+" else "+") for seg, d in reversed(prefix)]
        path = prefix + mirrored
        last_seg, last_dir = path[-1]
        if last_dir == "-" and last_seg == 1:
            path = path + [(i, "+") for i in range(1, n_segments + 1)]
    last_seg, last_dir = path[-1]
    if last_dir == "+" and last_seg < n_segments:
        path = path + [(i, "+") for i in range(last_seg + 1, n_segments + 1)]
    elif last_dir == "-" and last_seg > 1:
        path = path + [(i, "-") for i in range(last_seg - 1, 0, -1)]
    return path


def random_nested_chain(rng: np.random.Generator, n_segments: int, max_depth: int = 5) -> List[Tuple[int, int]]:
    """A strictly nested loop chain whose sides of shrinking alternate."""
    a, b = 1, n_segments
    chain = [(a, b)]
    last_side = None
    for _ in range(max_depth - 1):
        if b - a < 1:
            break
        if last_side is None:
            side = "right" if rng.random() < 0.5 else "left"
        else:
            side = "left" if last_side == "right" else "right"
        if side == "right":
            b = int(rng.integers(a, b))
        else:
            a = int(rng.integers(a + 1, b + 1))
        last_side = side
        chain.append((a, b))
        if rng.random() < 0.25:
            break
    return chain


def chain_to_path(chain: List[Tuple[int, int]]) -> List[Step]:
    """The path of a nested loop chain, as the program's replay walks it."""

    def up(a: int, b: int) -> List[Step]:
        return [(i, "+") for i in range(a, b + 1)]

    def down(b: int, a: int) -> List[Step]:
        return [(i, "-") for i in range(b, a - 1, -1)]

    def visit(k: int, from_left: bool) -> List[Step]:
        a, b = chain[k]
        child = chain[k + 1] if k + 1 < len(chain) else None
        first, second = (up(a, b), down(b, a)) if from_left else (down(b, a), up(a, b))
        if child is None:
            return first + second
        if from_left and child[1] == b and child[0] != a:
            return first + visit(k + 1, False) + second
        if not from_left and child[0] == a:
            return first + visit(k + 1, True) + second
        if from_left and child[0] == a:
            return first + second + visit(k + 1, True)
        raise ValueError("chain %r is not nested with alternating sides" % (chain,))

    return visit(0, True)


def path_stats(path: List[Step], n_segments: int) -> Tuple[np.ndarray, Dict[int, int]]:
    seg_cn = np.zeros(n_segments, dtype=np.int64)
    fbi: Dict[int, int] = {}
    for seg, _d in path:
        seg_cn[seg - 1] += 1
    for k in range(len(path) - 1):
        (s1, d1), (s2, d2) = path[k], path[k + 1]
        if d1 != d2:
            fbi[s1] = fbi.get(s1, 0) + 1
    return seg_cn, fbi


def simulate_bfb_case(
    seed: int = 0,
    n_segments: int = 8,
    rounds: int = 3,
    coverage: float = 30.0,
    noise: float = 0.0,
) -> BfbCase:
    """A bulk case of the original's "process" mode: `rounds` BFB cycles
    played on the arm, read depths with relative noise `noise`."""
    rng = np.random.default_rng(seed)
    path = bfb_process(rng, n_segments, rounds)
    return case_from_path(path, n_segments, rng, seed=seed, coverage=coverage, noise=noise)


def case_from_path(
    path: List[Step],
    n_segments: int,
    rng: np.random.Generator,
    seed: int = 0,
    coverage: float = 30.0,
    chrom: str = "chr7",
    seg_len: int = 1000,
    start_pos: int = 1000,
    noise: float = 0.0,
    sample_name: str = "",
) -> BfbCase:
    """Every input file of a case (SEG and SV tables, LH, JUNCS) for a
    known truth path."""
    seg_cn, fbi = path_stats(path, n_segments)
    seg_lines = []
    for i in range(n_segments):
        s = start_pos + i * seg_len
        depth = seg_cn[i] * coverage / 2.0
        if noise:
            depth = max(0.0, depth * (1.0 + rng.normal(0, noise)))
        seg_lines.append("%s:%d-%d\t%g" % (chrom, s, s + seg_len - 1, depth))
    seg_text = "\n".join(seg_lines) + "\n"

    sv_lines = ["chrom_5p\tbkpos_5p\tstrand_5p\tchrom_3p\tbkpos_3p\tstrand_3p\tavg_cn"]
    agg: Dict[Tuple, int] = {}
    for k in range(len(path) - 1):
        (s1, d1), (s2, d2) = path[k], path[k + 1]
        if d1 != d2:
            agg[(s1, d1, s2, d2)] = agg.get((s1, d1, s2, d2), 0) + 1
    for (s1, d1, s2, d2), cn in agg.items():
        seg_s = start_pos + (s1 - 1) * seg_len
        pos1 = seg_s + seg_len - 1 if d1 == "+" else seg_s
        seg_s2 = start_pos + (s2 - 1) * seg_len
        pos2 = seg_s2 if d2 == "+" else seg_s2 + seg_len - 1
        sv_lines.append("%s\t%d\t%s\t%s\t%d\t%s\t%d" % (chrom, pos1, d1, chrom, pos2, d2, cn))
    sv_text = "\n".join(sv_lines) + "\n"

    lh = [
        "SAMPLE_NAME %s" % (sample_name or "sim%d" % seed),
        "AVG_CHR_SEG_DP %g" % coverage,
        "AVG_WHOLE_HOST_DP %g" % coverage,
        "AVG_JUNC_DP %g" % coverage,
        "PURITY 1",
        "AVG_TUMOR_PLOIDY 2",
        "PLOIDY 2m1",
        "VIRUS_START %d" % (n_segments + 1),
        "SOURCE 1",
        "SINK %d" % n_segments,
    ]
    for i in range(n_segments):
        s = start_pos + i * seg_len
        depth = seg_cn[i] * coverage / 2.0
        cn = float(seg_cn[i])
        if noise:
            depth = max(0.0, depth * (1.0 + rng.normal(0, noise)))
            cn = -1.0
        lh.append("SEG H:%d:%s:%d:%d %g %g" % (i + 1, chrom, s, s + seg_len - 1, depth, cn))
    for (s1, d1, s2, d2), cn in agg.items():
        lh.append("JUNC H:%d:%s H:%d:%s %g %g U B" % (s1, d1, s2, d2, cn * coverage / 2.0, float(cn)))
    lh_text = "\n".join(lh) + "\n"

    return BfbCase(
        n_segments=n_segments,
        truth_path=path,
        seg_cn=seg_cn,
        fbi=fbi,
        coverage=coverage,
        lh_text=lh_text,
        sv_text=sv_text,
        seg_text=seg_text,
    )


def mutate_nested_chain(
    rng: np.random.Generator, chain: List[Tuple[int, int]], n_segments: int, max_extra: int = 3
) -> List[Tuple[int, int]]:
    """A child clone's chain: a random prefix of the parent's, regrown."""
    keep = int(rng.integers(1, len(chain) + 1))
    out = list(chain[:keep])
    last_side = None
    if keep >= 2:
        last_side = "right" if out[-1][1] < out[-2][1] else "left"
    a, b = out[-1]
    for _ in range(int(rng.integers(0, max_extra + 1))):
        if b - a < 1:
            break
        if last_side is None:
            side = "right" if rng.random() < 0.5 else "left"
        else:
            side = "left" if last_side == "right" else "right"
        if side == "right":
            b = int(rng.integers(a, b))
        else:
            a = int(rng.integers(a + 1, b + 1))
        last_side = side
        out.append((a, b))
    return out


@dataclass
class ScCase:
    cases: List[BfbCase]
    chains: List[List[Tuple[int, int]]]
    edges: List[Tuple[int, int]]


def simulate_sc_case(
    seed: int = 0,
    n_clones: int = 3,
    n_segments: int = 12,
    coverage: float = 30.0,
    noise: float = 0.0,
    topology: str = "chain",
) -> ScCase:
    """K subclones: the root plays a nested chain, each child keeps a
    prefix of its parent's and adds private rounds."""
    rng = np.random.default_rng(seed)
    chains = [random_nested_chain(rng, n_segments)]
    edges: List[Tuple[int, int]] = []
    for k in range(1, n_clones):
        parent = 0 if topology == "star" else k - 1
        chains.append(mutate_nested_chain(rng, chains[parent], n_segments))
        edges.append((parent, k))
    cases = [
        case_from_path(
            chain_to_path(chain), n_segments, rng, seed=seed, coverage=coverage, noise=noise,
            sample_name="sc%d_clone%d" % (seed, k),
        )
        for k, chain in enumerate(chains)
    ]
    return ScCase(cases=cases, chains=chains, edges=edges)


def write_case(case: BfbCase, prefix: str) -> Dict[str, str]:
    """`<prefix>.lh` and its tables; returns their paths by kind."""
    contents = {
        "lh": (prefix + ".lh", case.lh_text),
        "sv": (prefix + "_sv.txt", case.sv_text),
        "seg": (prefix + "_seg.txt", case.seg_text),
        "truth": (prefix + "_truth.txt", case.truth_string + "\n"),
    }
    for fn, text in contents.values():
        with open(fn, "w") as f:
            f.write(text)
    return {key: fn for key, (fn, _) in contents.items()}


def write_sc_clones(sc: ScCase, prefix: str) -> List[str]:
    """Clone k's LH text to `<prefix><k>.lh` (and its truth beside it);
    returns the LH file names."""
    names = []
    for k, case in enumerate(sc.cases):
        names.append(write_case(case, "%s%d" % (prefix, k))["lh"])
    return names
