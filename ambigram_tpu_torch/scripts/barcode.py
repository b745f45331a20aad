"""10x linked-read barcode evidence -> .juncs file.

Behavioral port of script/process_barcode.py, written
array-first: barcode intervals snap to segment spans with one
vectorized nearest-endpoint query per BED row (read_barcode), and link
weights come from a running AND over a barcode x segment incidence
matrix (link_weights) instead of pairwise Python set intersections.

The snapping rule reproduces the reference's exact iteration
semantics (process_barcode.py:13-49), including its quirks:

- the global FIRST segment captures an interval whose start lies at or
  before it — but any later same-chromosome segment steals the match
  because the nearest-start scan starts from an infinite best;
  effectively the special case only survives when no other segment
  participates;
- the global LAST segment captures an interval whose end lies at or
  beyond it, and that assignment wins over the nearest-end scan
  because it happens last;
- a segment claimed by either special case is excluded from BOTH
  nearest-endpoint scans for that row (if/elif chain);
- ties in the nearest-endpoint scans keep the lowest index (strict <).
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np


def read_seg(seg_path: str) -> List[List]:
    """SEG file rows (`chrom:start-end<TAB>...`) -> [chrom, start, end,
     1-based id] records (the shape downstream emitters consume)."""
    segs: List[List] = []
    for line in open(seg_path, "r").read().splitlines():
        if not line:
            continue
        loc = line.split("\t")[0]
        chrom, span = loc.split(":")
        start, end = span.split("-")
        segs.append([chrom, int(start), int(end), len(segs) + 1])
    return segs


def _snap(
    chroms: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    chrom: str,
    pos1: int,
    pos2: int,
) -> Tuple[int, int]:
    """Snap one barcode interval to a [start, end] segment-index span
    (reference iteration semantics, vectorized)."""
    n = len(chroms)
    match = chroms == chrom
    first_special = bool(match[0]) and pos1 <= starts[0]
    # for a single segment the first branch shadows the last (if/elif)
    last_special = (
        bool(match[n - 1]) and pos2 >= ends[n - 1] and not (n == 1 and first_special)
    )
    part = match.copy()
    if first_special:
        part[0] = False
    if last_special:
        part[n - 1] = False
    idx = np.nonzero(part)[0]
    if idx.size:
        start = int(idx[np.argmin(np.abs(starts[idx] - pos1))])
        end = int(idx[np.argmin(np.abs(ends[idx] - pos2))])
    else:
        start = 0 if first_special else -1
        end = -1
    if last_special:
        end = n - 1
    return start, end


def read_barcode(bed_path: str, segs: List[List]) -> List[List[str]]:
    """Per-segment barcode lists: each BED interval's barcode joins
    every segment in its snapped span."""
    chroms = np.array([s[0] for s in segs])
    starts = np.array([s[1] for s in segs], dtype=np.int64)
    ends = np.array([s[2] for s in segs], dtype=np.int64)
    n = len(segs)
    group: List[List[str]] = [[] for _ in segs]
    for line in open(bed_path, "r").read().splitlines():
        if not line:
            continue
        chrom, p1, p2, code = line.split("\t")[:4]
        if chrom[0] != "c":
            chrom = "chr" + chrom
        start, end = _snap(chroms, starts, ends, chrom, int(p1), int(p2))
        if start > end or not (0 <= start < n) or not (0 <= end < n):
            continue
        for i in range(start, end + 1):
            group[i].append(code)
    return group


def incidence_matrix(group: List[List[str]]) -> Tuple[np.ndarray, List[str]]:
    """Barcode x segment boolean incidence matrix."""
    codes = sorted({c for arr in group for c in arr})
    index = {c: i for i, c in enumerate(codes)}
    mat = np.zeros((len(codes), len(group)), dtype=bool)
    for s, arr in enumerate(group):
        for c in arr:
            mat[index[c], s] = True
    return mat, codes


def link_weights(group: List[List[str]], intervals: List[List[int]]) -> List[List[int]]:
    """Weight = |intersection of barcode sets over [i..j]| * (j - i),
    computed as a running AND over the incidence matrix
    (vectorizes process_barcode.py:51-57,81)."""
    mat, _ = incidence_matrix(group)
    links = []
    for interval in intervals:
        for i in range(interval[0], interval[1]):
            running = mat[:, i].copy()
            for j in range(i + 1, interval[1] + 1):
                running &= mat[:, j]
                w = int(running.sum()) * (j - i)
                links.append([i + 1, j + 1, w])
    links.sort(key=lambda x: x[2], reverse=True)
    return links


def chromosome_intervals(segs: List[List]) -> List[List[int]]:
    """Contiguous same-chromosome index runs, as [first, last] pairs."""
    intervals: List[List[int]] = []
    source = 0
    for i in range(1, len(segs)):
        if segs[i][0] != segs[source][0]:
            intervals.append([source, i - 1])
            source = i
    if source < len(segs):
        intervals.append([source, len(segs) - 1])
    return intervals


def barcode2juncs(seg_path: str, bed_path: str, junc_path: str, top: int = 5) -> str:
    segs = read_seg(seg_path)
    group = read_barcode(bed_path, segs)
    links = link_weights(group, chromosome_intervals(segs))
    lines = []
    for a, b, _w in links[:top]:
        lines.append(" ".join("%d+" % s for s in range(a, b + 1)))
    with open(junc_path, "w") as f:
        f.write("".join(line + "\n" for line in lines))
    return junc_path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Generate .juncs from 10x barcode BED + SEG file."
    )
    parser.add_argument("-bed", "--bed_file", dest="bedPath", required=True)
    parser.add_argument("-seg", "--seg_file", dest="segPath", required=True)
    parser.add_argument("-s", "--sample_name", dest="sampleName", default="sample")
    args = parser.parse_args(argv)
    barcode2juncs(args.segPath, args.bedPath, "%s.juncs" % args.sampleName)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
