"""LH file ingestion.

Parses the `.lh` local-haplotype format into a plain record structure.
Behavioral parity target: the reference parser at
src/Graph.cpp:109-237, including its quirks:

- tokens split on spaces/tabs; lines whose first non-blank char is '#'
  are skipped; unknown header keys are silently ignored (so the
  `SAMPLE` key in the reference README is ignored — only `SAMPLE_NAME`
  is recognized, Graph.cpp:140).
- `SEG` coverage is clamped to >= 0 (Graph.cpp:184).
- `JUNC` rows with coverage <= 0 and copy number <= 0 are dropped
  (Graph.cpp:211).
- `SOURCE`/`SINK` accept comma-separated id lists (multi-chromosome).
- `PLOIDY 2m1` style strings keep the raw string; the integer part
  before 'm' is the expected ploidy (Graph.cpp:164-167).

The LEGACY grammar of the localHap lineage is also accepted (the
reference's own live parser hits strtok-NULL UB on it; its one real
fixture script/test.lh:1-8 is in this form, emitted by
the commented-out writer in script/config.py:208-214):

- `SAMPLE <name>`            (vs SAMPLE_NAME)
- `AVG_DP <depth>`           (whole-sample average depth)
- `SOURCE H:1` / `SINK H:75` (H:<id> tokens instead of bare ids)
- `SEG H:<id> <depth> [<cn>]`  (no interval; CN auto from depth when absent)
- `JUNC H:<i>:<d> H:<j>:<d> <depth> [<cn>]`  (no flag columns)

The optional trailing `<cn>` column is how `--op check` writes balanced
copy numbers back into a legacy-dialect `.balanced.lh`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class SegRecord:
    seg_id: int
    chrom: str
    start: int
    end: int
    coverage: float
    copy_num: float


@dataclass
class JuncRecord:
    source_id: int
    source_dir: str
    target_id: int
    target_dir: str
    coverage: float
    copy_num: float
    inferred: bool
    bounded: bool


@dataclass
class LhFile:
    """Raw parsed contents of one .lh file."""

    sample_name: str = ""
    avg_chr_seg_dp: List[float] = field(default_factory=list)
    avg_whole_host_dp: float = -1.0
    avg_virus_seg_dp: float = -1.0
    # Reference leaves this uninitialized when VIRUS_START is absent
    # (Graph.cpp:36-49 never sets mVirusSegStart); we use "no virus
    # segment" as the defined default.
    virus_seg_start: Optional[int] = None
    avg_junc_dp: float = -1.0
    purity: float = -1.0
    avg_tumor_ploidy: float = -1.0
    # Graph(const char*) ctor initializes mAvgPloidy to 0 (not -1),
    # which calculateHapDepth treats as "not provided via the <0 test
    # but overridable by the tumor-ploidy computation" (Graph.cpp:38,318).
    avg_ploidy: float = 0.0
    ploidy_string: str = ""
    expected_ploidy: int = 0
    source_ids: List[int] = field(default_factory=list)
    sink_ids: List[int] = field(default_factory=list)
    segs: List[SegRecord] = field(default_factory=list)
    juncs: List[JuncRecord] = field(default_factory=list)
    prop_tokens: List[str] = field(default_factory=list)


def _atof(tok: str) -> float:
    """C atof(): parse a leading float prefix, 0.0 on failure."""
    i, n = 0, len(tok)
    while i < n and tok[i].isspace():
        i += 1
    j = i
    if j < n and tok[j] in "+-":
        j += 1
    seen = False
    while j < n and (tok[j].isdigit() or tok[j] == "."):
        j += 1
        seen = True
    if j < n and seen and tok[j] in "eE":
        k = j + 1
        if k < n and tok[k] in "+-":
            k += 1
        if k < n and tok[k].isdigit():
            j = k + 1
            while j < n and tok[j].isdigit():
                j += 1
    try:
        return float(tok[i:j]) if seen else 0.0
    except ValueError:
        return 0.0


def _atoi(tok: str) -> int:
    """C atoi(): parse a leading integer prefix, 0 on failure."""
    i, n = 0, len(tok)
    while i < n and tok[i].isspace():
        i += 1
    j = i
    if j < n and tok[j] in "+-":
        j += 1
    k = j
    while k < n and tok[k].isdigit():
        k += 1
    return int(tok[i:k]) if k > j else 0


def _split_colon_node(node: str) -> List[str]:
    """Split an `H:1:chr7:55281001:55282000` style token on ':'."""
    return node.split(":")


def _node_id(tok: str) -> int:
    """SOURCE/SINK id: bare `1` (modern) or `H:1` (legacy)."""
    return _atoi(tok.split(":")[-1]) if ":" in tok else _atoi(tok)


def parse_lh(path: str) -> LhFile:
    with open(path, "r") as f:
        text = f.read()
    return parse_lh_text(text)


def parse_lh_text(text: str) -> LhFile:
    lh = LhFile()
    for raw_line in text.split("\n"):
        stripped = raw_line.lstrip(" \t")
        if stripped.startswith("#"):
            continue
        tokens = raw_line.split()
        if not tokens:
            continue
        key = tokens[0]
        if key in ("SAMPLE_NAME", "SAMPLE"):
            lh.sample_name = tokens[1]
        elif key == "AVG_CHR_SEG_DP":
            lh.avg_chr_seg_dp = [_atof(t) for t in tokens[1].split(",") if t != ""]
        elif key in ("AVG_WHOLE_HOST_DP", "AVG_DP"):
            lh.avg_whole_host_dp = _atof(tokens[1])
        elif key == "AVG_VIRUS_SEG_DP":
            lh.avg_virus_seg_dp = _atof(tokens[1])
        elif key == "VIRUS_START":
            lh.virus_seg_start = _atoi(tokens[1])
        elif key == "AVG_JUNC_DP":
            lh.avg_junc_dp = _atof(tokens[1])
        elif key == "PURITY":
            lh.purity = _atof(tokens[1])
        elif key == "AVG_TUMOR_PLOIDY":
            lh.avg_tumor_ploidy = _atof(tokens[1])
        elif key == "AVG_PLOIDY":
            lh.avg_ploidy = _atof(tokens[1])
        elif key == "PLOIDY":
            lh.ploidy_string = tokens[1]
            lh.expected_ploidy = _atoi(tokens[1].split("m")[0])
        elif key == "SOURCE":
            lh.source_ids = [_node_id(t) for t in tokens[1].split(",") if t != ""]
        elif key == "SINK":
            lh.sink_ids = [_node_id(t) for t in tokens[1].split(",") if t != ""]
        elif key == "SEG":
            node = _split_colon_node(tokens[1])
            coverage = max(_atof(tokens[2]), 0.0)
            if len(node) >= 5:
                chrom, start, end = node[2], _atoi(node[3]), _atoi(node[4])
                copy_num = _atof(tokens[3]) if len(tokens) > 3 else 0.0
            elif len(node) == 2:
                # legacy `SEG H:<id> <depth> [<cn>]`: no interval
                chrom, start, end = node[0], 0, 0
                copy_num = _atof(tokens[3]) if len(tokens) > 3 else -1.0
            else:
                raise ValueError("malformed SEG node %r" % tokens[1])
            lh.segs.append(
                SegRecord(
                    seg_id=_atoi(node[1]),
                    chrom=chrom,
                    start=start,
                    end=end,
                    coverage=coverage,
                    copy_num=copy_num,
                )
            )
        elif key == "JUNC":
            src = _split_colon_node(tokens[1])
            tgt = _split_colon_node(tokens[2])
            if len(src) < 3 or len(tgt) < 3:
                raise ValueError("malformed JUNC nodes %r %r" % (tokens[1], tokens[2]))
            coverage = _atof(tokens[3])
            if len(tokens) >= 7:
                copy_num = _atof(tokens[4])
                inferred = tokens[5][0] == "I"
                bounded = tokens[6][0] == "B"
            elif len(tokens) in (4, 5):
                # legacy `JUNC H:i:+ H:j:+ <depth> [<cn>]`
                copy_num = _atof(tokens[4]) if len(tokens) > 4 else -1.0
                inferred = False
                bounded = False
            else:
                raise ValueError("malformed JUNC line (%d tokens)" % len(tokens))
            if coverage <= 0 and copy_num <= 0:
                continue
            lh.juncs.append(
                JuncRecord(
                    source_id=_atoi(src[1]),
                    source_dir=src[2][0],
                    target_id=_atoi(tgt[1]),
                    target_dir=tgt[2][0],
                    coverage=coverage,
                    copy_num=copy_num,
                    inferred=inferred,
                    bounded=bounded,
                )
            )
        elif key == "PROP":
            lh.prop_tokens = tokens[1:]
    if len(lh.source_ids) != len(lh.sink_ids):
        raise ValueError(
            "SOURCE/SINK count mismatch: %d vs %d"
            % (len(lh.source_ids), len(lh.sink_ids))
        )
    return lh
