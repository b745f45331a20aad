"""Reconstruction evaluation against ground truth.

Generic port of the reference's evaluation capability:
- per-segment multiplicity diff vs truth (script/compare.py:21-55)
- per-SV-type junction correctness (script/sim_true_haps.py:140-202,
  minus that script's dataset-specific coordinate remapping)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

Step = Tuple[int, str]


def parse_path_string(s: str) -> List[Step]:
    """Parse "1+2+3+|3-2-||7+..." into (segment, dir) steps."""
    steps: List[Step] = []
    num = ""
    for ch in s:
        if ch.isdigit():
            num += ch
        elif ch in "+-":
            if num:
                steps.append((int(num), ch))
                num = ""
        # '|' separators carry no content
    return steps


def segment_multiplicity(steps: List[Step]) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for seg, _d in steps:
        counts[seg] = counts.get(seg, 0) + 1
    return counts


def multiplicity_diff(truth: str, predicted: str) -> int:
    """Total absolute per-segment count difference (compare.py port)."""
    t = segment_multiplicity(parse_path_string(truth))
    p = segment_multiplicity(parse_path_string(predicted))
    segs = set(t) | set(p)
    return sum(abs(t.get(s, 0) - p.get(s, 0)) for s in segs)


def junctions_of(steps: List[Step]) -> Dict[Tuple[int, str, int, str], int]:
    """Multiset of non-reference adjacencies, canonicalized so that a
    junction and its reverse complement coincide."""
    juncs: Dict[Tuple[int, str, int, str], int] = {}
    for k in range(len(steps) - 1):
        (s1, d1), (s2, d2) = steps[k], steps[k + 1]
        if d1 == d2 and (
            (d1 == "+" and s2 - s1 == 1) or (d1 == "-" and s1 - s2 == 1)
        ):
            continue  # reference adjacency
        rc = (s2, "+" if d2 == "-" else "-", s1, "+" if d1 == "-" else "-")
        key = min((s1, d1, s2, d2), rc)
        juncs[key] = juncs.get(key, 0) + 1
    return juncs


def classify_junction(key: Tuple[int, str, int, str]) -> str:
    s1, d1, s2, d2 = key
    if d1 != d2:
        return "fbi" if abs(s1 - s2) <= 2 else "inversion"
    if d1 == "+" and s2 > s1 + 1:
        return "deletion"
    if d1 == "+" and s2 <= s1:
        return "duplication"
    return "other"


@dataclass
class JunctionScore:
    precision: float
    recall: float
    by_type: Dict[str, Tuple[int, int, int]]  # type -> (tp, fp, fn)


def junction_score(truth: str, predicted: str) -> JunctionScore:
    tj = junctions_of(parse_path_string(truth))
    pj = junctions_of(parse_path_string(predicted))
    tp = fp = fn = 0
    by_type: Dict[str, List[int]] = {}
    for key in set(tj) | set(pj):
        t = tj.get(key, 0)
        p = pj.get(key, 0)
        kind = classify_junction(key)
        rec = by_type.setdefault(kind, [0, 0, 0])
        tp_k = min(t, p)
        fp_k = max(0, p - t)
        fn_k = max(0, t - p)
        rec[0] += tp_k
        rec[1] += fp_k
        rec[2] += fn_k
        tp += tp_k
        fp += fp_k
        fn += fn_k
    precision = tp / (tp + fp) if tp + fp else 1.0
    recall = tp / (tp + fn) if tp + fn else 1.0
    return JunctionScore(
        precision=precision,
        recall=recall,
        by_type={k: tuple(v) for k, v in by_type.items()},
    )
