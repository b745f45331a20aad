"""Genome graph model: segments, strand vertices, SV junctions.

This is the host-side object model used by the exactness-critical cold
path (path replay, graph rewrites). The hot compute path never touches
these objects — it consumes dense arrays derived via
:meth:`Genome.arrays`.

Behavioral parity targets in the reference:
- segment / vertex pair / junction-as-two-edges representation:
  include/Segment.hpp, include/Vertex.hpp, src/Junction.cpp:26-42
- depth -> copy-number normalization: src/Graph.cpp:312-405
- junction lookup/insert semantics: src/Graph.cpp:489-610
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ambigram_tpu_torch.io.lh import LhFile, parse_lh


def _cdiv(a: float, b: float) -> float:
    """C++ double division: x/0 is +-inf (or nan for 0/0), not an error."""
    if b == 0:
        if a == 0:
            return float("nan")
        return float("inf") if a > 0 else float("-inf")
    return a / b


class Weight:
    """Coverage + copy number with backup/restore (reference src/Weight.cpp)."""

    __slots__ = ("coverage", "copy_num", "copy_num_backup", "corrected_coverage", "inferred")

    def __init__(self, coverage: float):
        self.coverage = coverage
        self.corrected_coverage = coverage
        self.copy_num = 0.0
        self.copy_num_backup = 0.0
        self.inferred = False

    def set_copy_num(self, cn: float) -> None:
        self.copy_num = cn
        self.copy_num_backup = cn

    def backup(self) -> None:
        self.copy_num_backup = self.copy_num

    def restore(self) -> None:
        self.copy_num = self.copy_num_backup


class Vertex:
    """One strand of a segment. Vertices are singletons per (segment, dir),
    so identity comparison == (id, dir) comparison, like the reference's
    pointer equality."""

    __slots__ = ("seg", "dir", "edges_as_source", "edges_as_target")

    def __init__(self, seg: "Segment", direction: str):
        self.seg = seg
        self.dir = direction
        self.edges_as_source: List["Edge"] = []
        self.edges_as_target: List["Edge"] = []

    @property
    def id(self) -> int:
        return self.seg.id

    @property
    def weight(self) -> Weight:
        return self.seg.weight

    def info(self) -> str:
        # reference src/Vertex.cpp:33 — "<id><dir>"
        return "%d%s" % (self.seg.id, self.dir)

    def complement(self) -> "Vertex":
        return self.seg.neg if self.dir == "+" else self.seg.pos

    def __repr__(self) -> str:  # pragma: no cover
        return "Vertex(%s)" % self.info()


class Segment:
    __slots__ = (
        "id",
        "chr_id",
        "chrom",
        "start",
        "end",
        "credibility",
        "partition",
        "has_lower_bound_limit",
        "weight",
        "pos",
        "neg",
    )

    def __init__(
        self,
        seg_id: int,
        chr_id: int,
        chrom: str,
        start: int,
        end: int,
        coverage: float,
        credibility: float,
        copy_num: float,
    ):
        self.id = seg_id
        self.chr_id = chr_id
        self.chrom = chrom
        self.start = start
        self.end = end
        self.credibility = credibility
        self.partition = 0
        self.has_lower_bound_limit = True
        self.weight = Weight(coverage)
        self.weight.set_copy_num(copy_num)
        self.pos = Vertex(self, "+")
        self.neg = Vertex(self, "-")

    @classmethod
    def clone(cls, seg_id: int, chr_id: int, other: "Segment") -> "Segment":
        # reference Segment(int, int, Segment*) copy ctor (src/Segment.cpp:27-45)
        return cls(
            seg_id,
            chr_id,
            other.chrom,
            other.start,
            other.end,
            other.weight.coverage,
            other.credibility,
            other.weight.copy_num,
        )

    def __repr__(self) -> str:  # pragma: no cover
        return "Segment(%d %s:%d-%d cn=%.3g)" % (
            self.id,
            self.chrom,
            self.start,
            self.end,
            self.weight.copy_num,
        )


class Edge:
    __slots__ = ("source", "target", "weight", "junction")

    def __init__(self, source: Vertex, target: Vertex, weight: Weight):
        self.source = source
        self.target = target
        self.weight = weight
        self.junction: Optional["Junction"] = None

    def info(self) -> str:
        return "%s->%s" % (self.source.info(), self.target.info())


class Junction:
    """SV adjacency: two complementary edges sharing one weight
    (reference src/Junction.cpp:7-43, edge wiring :95-121)."""

    __slots__ = (
        "source",
        "target",
        "source_dir",
        "target_dir",
        "credibility",
        "inferred",
        "has_lower_bound_limit",
        "weight",
        "edge_a",
        "edge_b",
    )

    def __init__(
        self,
        source: Segment,
        target: Segment,
        source_dir: str,
        target_dir: str,
        coverage: float,
        credibility: float,
        copy_num: float,
        inferred: bool,
        bounded: bool,
        is_source_sink_junction: bool = False,
    ):
        self.source = source
        self.target = target
        self.source_dir = source_dir
        self.target_dir = target_dir
        self.credibility = credibility
        self.inferred = inferred
        self.has_lower_bound_limit = bounded
        self.weight = Weight(coverage)
        self.weight.set_copy_num(copy_num)
        self.weight.inferred = is_source_sink_junction

        sv, tv = source, target
        if source_dir == "+" and target_dir == "+":
            self.edge_a = Edge(sv.pos, tv.pos, self.weight)
            self.edge_b = Edge(tv.neg, sv.neg, self.weight)
        elif source_dir == "-" and target_dir == "-":
            self.edge_a = Edge(sv.neg, tv.neg, self.weight)
            self.edge_b = Edge(tv.pos, sv.pos, self.weight)
        elif source_dir == "+" and target_dir == "-":
            self.edge_a = Edge(sv.pos, tv.neg, self.weight)
            self.edge_b = Edge(tv.pos, sv.neg, self.weight)
        else:  # '-', '+'
            self.edge_a = Edge(sv.neg, tv.pos, self.weight)
            self.edge_b = Edge(tv.neg, sv.pos, self.weight)
        self.edge_a.junction = self
        self.edge_b.junction = self

    def info(self) -> Tuple[str, str]:
        return (self.edge_a.info(), self.edge_b.info())

    def insert_edges_to_vertices(self) -> None:
        # reference src/Junction.cpp:95-121 incl. the self-inversion
        # special case (source == target with opposite dirs inserts
        # only edge A's endpoints).
        sd, td = self.source_dir, self.target_dir
        s, t = self.source, self.target
        a, b = self.edge_a, self.edge_b
        if sd == "+" and td == "+":
            s.pos.edges_as_source.append(a)
            t.pos.edges_as_target.append(a)
            s.neg.edges_as_target.append(b)
            t.neg.edges_as_source.append(b)
        elif sd == "-" and td == "-":
            s.neg.edges_as_source.append(a)
            t.neg.edges_as_target.append(a)
            s.pos.edges_as_target.append(b)
            t.pos.edges_as_source.append(b)
        elif sd == "+" and td == "-":
            s.pos.edges_as_source.append(a)
            t.neg.edges_as_target.append(a)
            if s is not t:
                s.neg.edges_as_target.append(b)
                t.pos.edges_as_source.append(b)
        else:
            s.neg.edges_as_source.append(a)
            t.pos.edges_as_target.append(a)
            if s is not t:
                s.pos.edges_as_target.append(b)
                t.neg.edges_as_source.append(b)

    def __repr__(self) -> str:  # pragma: no cover
        return "Junction(%d%s -> %d%s cn=%.3g)" % (
            self.source.id,
            self.source_dir,
            self.target.id,
            self.target_dir,
            self.weight.copy_num,
        )


@dataclass
class GenomeArrays:
    """Dense, device-friendly view of a Genome (one LH case).

    seg_cn[s]      copy number of segment s (0-based: segment id s+1)
    junc[j, :]     (source_id, source_dir(+1/-1), target_id, target_dir,
                    copy_num_as_float_bits? no - separate), int columns
    junc_cn[j]     junction copy number
    """

    seg_cn: np.ndarray  # float64 [S]
    seg_coverage: np.ndarray  # float64 [S]
    seg_chr_id: np.ndarray  # int32 [S]
    junc_src: np.ndarray  # int32 [J]
    junc_src_dir: np.ndarray  # int8 [J]  (+1 / -1)
    junc_tgt: np.ndarray  # int32 [J]
    junc_tgt_dir: np.ndarray  # int8 [J]
    junc_cn: np.ndarray  # float64 [J]
    sources: np.ndarray  # int32 [C]
    sinks: np.ndarray  # int32 [C]


class Genome:
    """The breakpoint graph for one LH case (reference `Graph`)."""

    def __init__(self) -> None:
        self.sample_name = ""
        self.purity = -1.0
        self.avg_ploidy = 0.0
        self.avg_tumor_ploidy = -1.0
        self.avg_coverage_raw = -1.0
        self.avg_virus_dp = -1.0
        self.avg_coverage = 0.0
        self.avg_coverage_junc = 0.0
        self.avg_coverage_raw_junc = 0.0
        self.haploid_depth = 0.0
        self.haploid_depth_junc = 0.0
        self.ratio = 0.0
        self.ploidy_string = ""
        self.expected_ploidy = 0
        self.virus_seg_start: Optional[int] = None
        self.avg_coverages: List[float] = []

        self.segments: List[Segment] = []
        self.junctions: List[Junction] = []
        self.sources: List[Segment] = []
        self.sinks: List[Segment] = []
        self._seg_by_id: Dict[int, Segment] = {}
        self.prop_tokens: List[str] = []

    # ---------------------------------------------------------------- build

    @classmethod
    def from_lh(cls, path: str) -> "Genome":
        return cls.from_records(parse_lh(path))

    @classmethod
    def from_records(cls, lh: LhFile) -> "Genome":
        g = cls()
        g.sample_name = lh.sample_name
        g.purity = lh.purity
        g.avg_ploidy = lh.avg_ploidy
        g.avg_tumor_ploidy = lh.avg_tumor_ploidy
        g.avg_coverage_raw = lh.avg_whole_host_dp
        g.avg_virus_dp = lh.avg_virus_seg_dp
        g.avg_coverage_junc = lh.avg_junc_dp
        g.avg_coverage_raw_junc = lh.avg_junc_dp
        g.ploidy_string = lh.ploidy_string
        g.expected_ploidy = lh.expected_ploidy
        g.virus_seg_start = lh.virus_seg_start
        g.avg_coverages = list(lh.avg_chr_seg_dp)
        g.prop_tokens = list(lh.prop_tokens)

        for rec in lh.segs:
            chr_id = 0
            for i, (src, snk) in enumerate(zip(lh.source_ids, lh.sink_ids)):
                if src <= rec.seg_id <= snk:
                    chr_id = i
            g.add_segment(rec.seg_id, chr_id, rec.chrom, rec.start, rec.end, rec.coverage, 1.0, rec.copy_num)
        for rec in lh.juncs:
            g.add_junction(
                rec.source_id,
                rec.source_dir,
                rec.target_id,
                rec.target_dir,
                rec.coverage,
                1.0,
                rec.copy_num,
                rec.inferred,
                rec.bounded,
                False,
            )
        for src, snk in zip(lh.source_ids, lh.sink_ids):
            g.sources.append(g.segment_by_id(src))
            g.sinks.append(g.segment_by_id(snk))
        # partition = chromosome index (localhap.cpp:94-98)
        for i, (src, snk) in enumerate(zip(g.sources, g.sinks)):
            for seg_id in range(src.id, snk.id + 1):
                g.segment_by_id(seg_id).partition = i
        return g

    @classmethod
    def from_parts(
        cls,
        segs: List[Segment],
        juncs: List[Junction],
        sources: List[Segment],
        sinks: List[Segment],
    ) -> "Genome":
        # reference Graph(vector<Segment*>, ...) used by the TRX rewrites
        g = cls()
        g.segments = list(segs)
        g.junctions = list(juncs)
        g.sources = list(sources)
        g.sinks = list(sinks)
        g._seg_by_id = {s.id: s for s in segs}
        for j in juncs:
            j.insert_edges_to_vertices()
        for i, (src, snk) in enumerate(zip(g.sources, g.sinks)):
            for seg_id in range(src.id, snk.id + 1):
                g.segment_by_id(seg_id).partition = i
        return g

    def add_segment(
        self,
        seg_id: int,
        chr_id: int,
        chrom: str,
        start: int,
        end: int,
        coverage: float,
        credibility: float,
        copy_num: float,
    ) -> Segment:
        seg = Segment(seg_id, chr_id, chrom, start, end, coverage, credibility, copy_num)
        self.segments.append(seg)
        self._seg_by_id[seg_id] = seg
        return seg

    def add_junction(
        self,
        source_id: int,
        source_dir: str,
        target_id: int,
        target_dir: str,
        coverage: float,
        credibility: float,
        copy_num: float,
        inferred: bool,
        bounded: bool,
        is_source_sink: bool,
    ) -> Optional[Junction]:
        # reference src/Graph.cpp:579-610: silently returns the duplicate
        # junction (without inserting) if it already exists.
        source = self.segment_by_id(source_id)
        target = self.segment_by_id(target_id)
        if not source.has_lower_bound_limit or not target.has_lower_bound_limit:
            return None
        junc = Junction(
            source, target, source_dir, target_dir, coverage, credibility, copy_num, inferred, bounded, is_source_sink
        )
        existing = self.find_junction(junc)
        if existing is not None:
            return junc
        junc.insert_edges_to_vertices()
        self.junctions.append(junc)
        return junc

    # -------------------------------------------------------------- queries

    def segment_by_id(self, seg_id: int) -> Segment:
        try:
            return self._seg_by_id[seg_id]
        except KeyError:
            raise KeyError("segment %d does not exist" % seg_id)

    def find_junction(self, junc: Junction) -> Optional[Junction]:
        # matches either edge string pair in either order
        # (reference src/Graph.cpp:501-511)
        a_info = junc.info()
        for j in self.junctions:
            info = j.info()
            if (info[0] == a_info[0] and info[1] == a_info[1]) or (
                info[0] == a_info[1] and info[1] == a_info[0]
            ):
                return j
        return None

    # -------------------------------------------------- depth normalization

    def calculate_hap_depth(self) -> None:
        """reference src/Graph.cpp:312-367."""
        if self.avg_ploidy < 0:
            if self.avg_tumor_ploidy < 0:
                raise ValueError(
                    "no ploidy information provided; need AVG_PLOIDY or AVG_TUMOR_PLOIDY"
                )
            if self.purity < 0:
                raise ValueError("no purity information provided")
            self.avg_ploidy = self.purity * self.avg_tumor_ploidy + (1 - self.purity) * 2
        else:
            if self.avg_tumor_ploidy >= 0 and self.purity >= 0:
                pt = self.purity * self.avg_tumor_ploidy
                ratio = 1 - pt / (pt + (1 - self.purity) * 2)
                avg_ploidy = pt + (1 - self.purity) * 2
                self.ratio = ratio
                if abs(self.avg_ploidy - avg_ploidy) > 0.1:
                    self.avg_ploidy = avg_ploidy
        self.haploid_depth = _cdiv(self.avg_coverage_raw * self.purity, self.avg_ploidy)
        self.haploid_depth_junc = self.haploid_depth
        self.avg_coverage = self.avg_ploidy * self.haploid_depth
        self.avg_coverage_junc = self.avg_ploidy * self.haploid_depth_junc

    def calculate_copy_num(self) -> None:
        """reference src/Graph.cpp:369-405: only fills CNs that are <= 0."""
        ratio = self.ratio
        hdp = self.haploid_depth
        virus_start = self.virus_seg_start if self.virus_seg_start is not None else 1 << 60
        for seg in self.segments:
            if seg.weight.copy_num > 0:
                continue
            if seg.id >= virus_start:
                seg_copy = _cdiv(seg.weight.coverage, self.avg_coverage_raw) * 2
            else:
                depth_t = seg.weight.coverage - self.avg_coverage_raw * ratio
                seg.weight.corrected_coverage = depth_t
                seg_copy = _cdiv(depth_t, hdp)
            seg.weight.set_copy_num(max(seg_copy, 0.0))
        for junc in self.junctions:
            if junc.weight.copy_num > 0:
                continue
            depth_t = junc.weight.coverage - self.avg_coverage_raw * ratio
            junc.weight.corrected_coverage = depth_t
            junc.weight.set_copy_num(max(_cdiv(depth_t, hdp), 0.0))

    # ------------------------------------------------------------- export

    def arrays(self) -> GenomeArrays:
        dirmap = {"+": 1, "-": -1}
        return GenomeArrays(
            seg_cn=np.array([s.weight.copy_num for s in self.segments], dtype=np.float64),
            seg_coverage=np.array([s.weight.coverage for s in self.segments], dtype=np.float64),
            seg_chr_id=np.array([s.chr_id for s in self.segments], dtype=np.int32),
            junc_src=np.array([j.source.id for j in self.junctions], dtype=np.int32),
            junc_src_dir=np.array([dirmap[j.source_dir] for j in self.junctions], dtype=np.int8),
            junc_tgt=np.array([j.target.id for j in self.junctions], dtype=np.int32),
            junc_tgt_dir=np.array([dirmap[j.target_dir] for j in self.junctions], dtype=np.int8),
            junc_cn=np.array([j.weight.copy_num for j in self.junctions], dtype=np.float64),
            sources=np.array([s.id for s in self.sources], dtype=np.int32),
            sinks=np.array([s.id for s in self.sinks], dtype=np.int32),
        )

    def write_lh(self, path: str) -> None:
        """reference Graph::writeGraph (src/Graph.cpp:239-266)."""

        def fmt(x: float) -> str:
            # std::ostream default formatting for double (6 significant digits)
            return "%.6g" % x

        lines = [
            "SAMPLE_NAME TEST",
            "AVG_SEG_DP " + fmt(self.avg_coverage),
            "AVG_JUNC_DP " + fmt(self.avg_coverage_junc),
            "PURITY " + fmt(self.purity),
            "AVG_PLOIDY " + fmt(self.avg_ploidy),
            "PLOIDY " + self.ploidy_string,
            "SOURCE " + "".join(str(s.id) + "," for s in self.sources),
            "SINK " + "".join(str(s.id) + "," for s in self.sinks),
        ]
        for seg in self.segments:
            lines.append(
                "SEG H:%d:%s:%d:%d %s %s %s"
                % (
                    seg.id,
                    seg.chrom,
                    seg.start,
                    seg.end,
                    fmt(seg.weight.coverage),
                    fmt(seg.weight.copy_num),
                    "B" if seg.has_lower_bound_limit else "U",
                )
            )
        for junc in self.junctions:
            e = junc.edge_a
            lines.append(
                "JUNC H:%d:%s H:%d:%s %s %s %s %s"
                % (
                    e.source.id,
                    e.source.dir,
                    e.target.id,
                    e.target.dir,
                    fmt(junc.weight.coverage),
                    fmt(junc.weight.copy_num),
                    "I" if junc.inferred else "U",
                    "B" if junc.has_lower_bound_limit else "U",
                )
            )
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


VertexPath = List[Vertex]
