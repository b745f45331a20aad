"""SNP-support profiling and simulator support counting.

Capability ports of the reference's deprecated haplotype-support mains:

- LocusDB            src/LocusDB.cpp (VCF SNP loci in a
                     region, binary-searchable positions, locus->segment
                     assignment; the LEGEND mode is a no-op upstream,
                     LocusDB.cpp:55, and stays one here)
- SupportProfile     src/SupportProfile.cpp (per-sample
                     genotypes, read-backed allele-pair support counts
                     rr/ra/ar/aa between het loci, gz support file I/O)
- HaploidProfile     src/HaploidProfile.cpp (two solved
                     haploid strings, CN-normal segment detection, greedy
                     variant placement per normal segment)
- countsupport main  countsupport.cpp:8-24
- count_support tool count_support.cpp:368-439 (simulated
                     SV map -> segment sequence -> junctions, depth and
                     split-read support tabulation, seg/junc/LH writers)

Core logic (cigar walks, pair counting, phasing, junction derivation) is
pure Python over plain records so it is testable without BAM files; BAM
and tabix access is gated on pysam and degrades with a clear error.
"""

from __future__ import annotations

import argparse
import gzip
import sys
from bisect import bisect_left, bisect_right
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ambigram_tpu_torch.scripts.juncdb_tool import Seg, SegmentDB


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


# ------------------------------------------------------------------ LocusDB


@dataclass
class Locus:
    """One biallelic SNP (LocusDB.hpp:10-17); pos is 0-based."""

    id: int
    pos: int
    ref: str
    alt: str
    seg: Optional[Seg] = None


class LocusDB:
    """SNP loci of a region, ordered by position (LocusDB.cpp:9-83)."""

    MODE_VCF = 0
    MODE_LEGEND = 1

    def __init__(self, chrom: str, start: int, end: int):
        self.chrom = chrom
        self.start = start
        self.end = end
        self.loci: List[Locus] = []
        self._pos: List[int] = []
        self.seg_db: Optional[SegmentDB] = None

    def read(self, path: str, mode: int = MODE_VCF) -> None:
        if mode == self.MODE_VCF:
            self.read_vcf(path)
        # MODE_LEGEND: intentionally a no-op (LocusDB.cpp:55)

    def read_vcf(self, path: str) -> None:
        """First-allele biallelic records in the region (LocusDB.cpp:36-53).

        Matches htslib's region semantics: 1-based inclusive [start, end]
        filter on the record position, 0-based stored positions.
        """
        self.loci = []
        self._pos = []
        idx = 0
        with _open_text(path) as fin:
            for line in fin:
                if not line or line.startswith("#"):
                    continue
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 5 or cols[0] != self.chrom:
                    continue
                pos1 = int(cols[1])
                if pos1 < self.start or pos1 > self.end:
                    continue
                ref, alt = cols[3], cols[4].split(",")[0]
                self.loci.append(Locus(idx, pos1 - 1, ref[0], alt[0]))
                self._pos.append(pos1 - 1)
                idx += 1

    def find_loci_in_range(self, start: int, end: int) -> Tuple[int, int]:
        """[begin, end) locus-index window covering 0-based positions
        [start, end] (LocusDB.cpp:57-61)."""
        return bisect_left(self._pos, start), bisect_right(self._pos, end)

    def set_seg_ref(self, seg_db: SegmentDB) -> None:
        self.seg_db = seg_db

    def assign_locus_to_seg(self) -> None:
        """Walk loci and segments in lockstep (LocusDB.cpp:65-75)."""
        assert self.seg_db is not None
        segs = self.seg_db.segs
        seg_loci: Dict[int, List[Locus]] = {}
        si = 0
        for l in self.loci:
            while si < len(segs) and l.pos > segs[si].end:
                si += 1
            if si >= len(segs):
                break
            l.seg = segs[si]
            seg_loci.setdefault(segs[si].id, []).append(l)
        self.seg_loci = seg_loci


# ----------------------------------------------------------- SupportProfile


@dataclass
class ReadCount:
    """Allele-combination counts for one locus pair
    (SupportProfile.hpp readCount: rr/ra/ar/aa)."""

    rr: int = 0
    ra: int = 0
    ar: int = 0
    aa: int = 0


@dataclass
class AlnRead:
    """Minimal alignment record for the pure-Python counting path."""

    qname: str
    pos: int  # 0-based leftmost mapped position
    cigar: Sequence[Tuple[int, int]]  # (op, len); op in sam codes 0..8
    seq: str
    mapq: int = 60
    flag: int = 0


_CIGAR_CODE = {c: i for i, c in enumerate("MIDNSHP=X")}


def parse_cigar(text: str) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    n = ""
    for ch in text:
        if ch.isdigit():
            n += ch
        else:
            out.append((_CIGAR_CODE[ch], int(n)))
            n = ""
    return out


def cigar_rlen(cigar: Sequence[Tuple[int, int]]) -> int:
    """Reference-consumed length (htslib bam_cigar2rlen)."""
    return sum(ln for op, ln in cigar if op in (0, 2, 3, 7, 8))


def get_base_idx(read: AlnRead, pos: int) -> int:
    """Query-sequence index of reference position `pos`, or -1 when the
    position falls in a deletion / outside the alignment
    (SupportProfile.cpp:236-266 — including its M-only walk: matches
    advance both cursors, D advances reference, I and S advance query)."""
    aln_start = read.pos
    idx = 0
    rlen = cigar_rlen(read.cigar)
    for op, oplen in read.cigar:
        if op == 0:  # M
            if aln_start + oplen < pos:
                aln_start += oplen
                idx += oplen
            else:
                idx += pos - aln_start
                if idx >= rlen:
                    return -1
                return idx
        elif op == 2:  # D
            if aln_start + oplen < pos:
                aln_start += oplen
            else:
                return -1
        elif op in (1, 4):  # I, S
            idx += oplen
    return -1


class SupportProfile:
    """Genotypes + pairwise allele support between het loci
    (SupportProfile.cpp:14-282)."""

    def __init__(self, sample_name: str):
        self.sample_name = sample_name
        self.loci_ref: Optional[LocusDB] = None
        self.gt: List[int] = []
        # per locus id: sorted list of (paired locus id, ReadCount)
        self.pair_loci: List[List[int]] = []
        self.pair_counts: List[List[ReadCount]] = []
        self.num_het = self.num_hom = self.num_unknown = 0

    def set_loci_ref(self, db: LocusDB) -> None:
        self.loci_ref = db
        n = len(db.loci)
        self.gt = [-1] * n
        self.pair_loci = [[] for _ in range(n)]
        self.pair_counts = [[] for _ in range(n)]

    def read_genotypes(self, vcf_path: str) -> None:
        """GT of `sample_name` per locus, summed alleles: 0/2 hom, 1 het
        (SupportProfile.cpp:39-66)."""
        assert self.loci_ref is not None
        sample_col = None
        idx = 0
        with _open_text(vcf_path) as fin:
            for line in fin:
                if line.startswith("##"):
                    continue
                cols = line.rstrip("\n").split("\t")
                if line.startswith("#CHROM"):
                    try:
                        sample_col = cols.index(self.sample_name)
                    except ValueError:
                        sample_col = 9 if len(cols) > 9 else None
                    continue
                if len(cols) < 5 or cols[0] != self.loci_ref.chrom:
                    continue
                pos1 = int(cols[1])
                if pos1 < self.loci_ref.start or pos1 > self.loci_ref.end:
                    continue
                if idx >= len(self.gt):
                    break
                g = -1
                if sample_col is not None and sample_col < len(cols):
                    gt_txt = cols[sample_col].split(":")[0]
                    alleles = gt_txt.replace("|", "/").split("/")
                    try:
                        g = sum(int(a) for a in alleles)
                    except ValueError:
                        g = -1
                self.gt[idx] = g
                if g in (0, 2):
                    self.num_hom += 1
                elif g == 1:
                    self.num_het += 1
                else:
                    self.num_unknown += 1
                idx += 1

    # -- pair counting ---------------------------------------------------

    def _add_pair(self, i_id: int, j_id: int, a_i: int, a_j: int) -> None:
        """Record one co-observation of locus i (allele a_i) with locus j
        (allele a_j); mirrors SupportProfile.cpp:161-198."""
        lst, cnts = self.pair_loci[i_id], self.pair_counts[i_id]
        k = bisect_left(lst, j_id)
        if k == len(lst) or lst[k] != j_id:
            lst.insert(k, j_id)
            cnts.insert(k, ReadCount())
        rc = cnts[k]
        comb = a_i + a_j
        if comb == 0:
            rc.rr += 1
        elif comb == 2:
            rc.aa += 1
        elif a_i == 0:
            rc.ra += 1
        else:
            rc.ar += 1

    def count_support_reads(self, read_groups: Iterable[List[AlnRead]]) -> None:
        """Pure-Python core of countSupport (SupportProfile.cpp:90-204):
        each group holds all alignments of one read/fragment name; loci
        covered with ref/alt base in the same group pair up."""
        assert self.loci_ref is not None
        loci = self.loci_ref.loci
        for group in read_groups:
            covered: List[Tuple[Locus, int]] = []
            for read in group:
                if read.mapq < 20 or (read.flag & 0x900) != 0:
                    continue
                begin, end = self.loci_ref.find_loci_in_range(
                    read.pos, read.pos + cigar_rlen(read.cigar)
                )
                for li in range(begin, end):
                    l = loci[li]
                    gt = self.gt[l.id]
                    if gt < 0 or gt % 2 == 0:
                        continue  # only het loci pair up
                    bi = get_base_idx(read, l.pos)
                    if bi < 0 or bi >= len(read.seq):
                        continue
                    base = read.seq[bi]
                    if base == l.ref:
                        covered.append((l, 0))
                    elif base == l.alt:
                        covered.append((l, 1))
            if len(covered) > 1:
                for i in range(len(covered)):
                    for j in range(len(covered)):
                        if i == j:
                            continue
                        self._add_pair(
                            covered[i][0].id, covered[j][0].id, covered[i][1], covered[j][1]
                        )

    def count_support(self, bam_path: str) -> None:
        """BAM-driven counting; requires pysam (SupportProfile.cpp:90-204)."""
        try:
            import pysam  # type: ignore
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("count_support over BAM requires pysam") from e

        def groups():
            current: List[AlnRead] = []
            name = None
            with pysam.AlignmentFile(bam_path, "rb") as bam:  # pragma: no cover
                for aln in bam:
                    if aln.is_unmapped or aln.cigartuples is None:
                        continue
                    rd = AlnRead(
                        aln.query_name,
                        aln.reference_start,
                        aln.cigartuples,
                        aln.query_sequence or "",
                        aln.mapping_quality,
                        aln.flag,
                    )
                    if name is None or aln.query_name == name:
                        current.append(rd)
                        name = aln.query_name
                    else:
                        yield current
                        current = [rd]
                        name = aln.query_name
                if current:
                    yield current

        self.count_support_reads(groups())

    # -- support file I/O ------------------------------------------------

    def read_support(self, path: str) -> None:
        """`id1 id2 rr ra ar aa` rows, 1-based ids
        (SupportProfile.cpp:68-88)."""
        with _open_text(path) as fin:
            for line in fin:
                parts = line.split()
                if len(parts) < 6:
                    continue
                i1, i2 = int(parts[0]) - 1, int(parts[1]) - 1
                rr, ra, ar, aa = (int(v) for v in parts[2:6])
                self.pair_loci[i1].append(i2)
                self.pair_counts[i1].append(ReadCount(rr, ra, ar, aa))

    def write_support(self, path: str) -> None:
        """gz rows mirroring writeSupport (SupportProfile.cpp:206-220)."""
        with gzip.open(path, "wt") as fout:
            for i, lst in enumerate(self.pair_loci):
                for j, rc in zip(lst, self.pair_counts[i]):
                    fout.write("%d %d %d %d %d %d\n" % (i + 1, j + 1, rc.rr, rc.ra, rc.ar, rc.aa))

    def in_same_seg_supports(self, l: Locus) -> List[Tuple[Locus, ReadCount]]:
        """Paired loci of `l` on the same segment
        (SupportProfile.cpp:223-234)."""
        assert self.loci_ref is not None
        loci = self.loci_ref.loci
        out = []
        for j, rc in zip(self.pair_loci[l.id], self.pair_counts[l.id]):
            other = loci[j]
            if other.seg is l.seg and other is not l:
                out.append((other, rc))
        return out

    def statistics(self) -> Tuple[int, int, int, int]:
        return self.num_hom, self.num_het, self.num_unknown, len(self.gt)


# ----------------------------------------------------------- HaploidProfile


@dataclass
class Strand:
    seg: Seg
    sign: str


class HaploidProfile:
    """Greedy per-segment variant phasing over a solved haploid pair
    (HaploidProfile.cpp:24-233)."""

    def __init__(self, sample_name: str):
        self.sample_name = sample_name
        self.hap1: List[Strand] = []
        self.hap2: List[Strand] = []
        self.seg_ref: Optional[SegmentDB] = None
        self.seg_normal: List[bool] = []
        self.sp: Optional[SupportProfile] = None

    def set_seg_ref(self, db: SegmentDB) -> None:
        self.seg_ref = db
        self.seg_normal = [False] * len(db.segs)

    def set_support_profile(self, sp: SupportProfile) -> None:
        self.sp = sp

    def _parse_hap_line(self, line: str) -> List[Strand]:
        assert self.seg_ref is not None
        out = []
        for tok in line.split():
            sid, sign = int(tok[:-1]), tok[-1]
            out.append(Strand(self.seg_ref.segs[sid - 1], sign))
        # the reference pops the trailing node of each haploid line
        # (HaploidProfile.cpp:61,78)
        if out:
            out.pop()
        return out

    def read_haploids(self, path: str) -> None:
        with open(path, "r") as fin:
            lines = fin.read().splitlines()
        self.hap1 = self._parse_hap_line(lines[0]) if lines else []
        self.hap2 = self._parse_hap_line(lines[1]) if len(lines) > 1 else []

    def identify_normal(self) -> None:
        """Segments appearing exactly once per haploid are CN-normal
        (HaploidProfile.cpp:87-103)."""
        assert self.seg_ref is not None
        n = len(self.seg_ref.segs)
        c1 = [0] * n
        c2 = [0] * n
        id2idx = {s.id: i for i, s in enumerate(self.seg_ref.segs)}
        for s in self.hap1:
            c1[id2idx[s.seg.id]] += 1
        for s in self.hap2:
            c2[id2idx[s.seg.id]] += 1
        self.seg_normal = [c1[i] == 1 and c2[i] == 1 for i in range(n)]

    def place_variants_in_seg(self, seg: Seg, loci: List[Locus]) -> List[Tuple[Locus, int]]:
        """Greedy left-to-right assignment: hom loci are fixed, each het
        locus takes the haplotype with more consistent pair support
        against already-placed loci (HaploidProfile.cpp:109-188).
        Returns (locus, type) with type 0/1 = hap0/hap1 allele, -2 unknown."""
        assert self.sp is not None
        hap: List[Tuple[Locus, int]] = []
        for l in loci:
            gt = self.sp.gt[l.id]
            if gt != 1:
                hap.append((l, 0 if gt == 0 else (1 if gt == 2 else -2)))
                continue
            pairs = self.sp.in_same_seg_supports(l)
            if not pairs:
                hap.append((l, -2))
                continue
            h0 = h1 = 0
            placed = {v.id: t for v, t in hap}
            for other, rc in pairs:
                if other.id not in placed:
                    continue
                t = placed[other.id]
                if t == 0:
                    h0 += rc.rr + rc.aa
                    h1 += rc.ra + rc.ar
                else:
                    # non-ref types (1 and unknown -2) share the else
                    # branch, as in HaploidProfile.cpp:150-156
                    h0 += rc.ra + rc.ar
                    h1 += rc.rr + rc.aa
            hap.append((l, 0 if h0 >= h1 else 1))
        return hap

    def place_variants(self, out=sys.stdout) -> Dict[int, List[Tuple[Locus, int]]]:
        """Per-normal-segment placement + the reference's summary row
        (HaploidProfile.cpp:190-200,182-186)."""
        assert self.seg_ref is not None and self.sp is not None
        assert self.sp.loci_ref is not None
        seg_loci = getattr(self.sp.loci_ref, "seg_loci", {})
        out.write(
            "segId hom het unknown solvedHet hom+solvedHet noSupportHet total "
            "solvedHet/total hom_solvedHet/total solvedHet/het\n"
        )
        placements: Dict[int, List[Tuple[Locus, int]]] = {}
        for i, seg in enumerate(self.seg_ref.segs):
            if not self.seg_normal[i]:
                continue
            loci = seg_loci.get(seg.id, [])
            hap = self.place_variants_in_seg(seg, loci)
            placements[seg.id] = hap
            n_hom = sum(1 for l in loci if self.sp.gt[l.id] in (0, 2))
            n_het = sum(1 for l in loci if self.sp.gt[l.id] == 1)
            n_unk = sum(1 for l in loci if self.sp.gt[l.id] not in (0, 1, 2))
            no_support = sum(
                1 for l, t in hap if self.sp.gt[l.id] == 1 and t == -2
            )
            solved = n_het - no_support
            total = len(loci)
            out.write(
                "%d %d %d %d %d %d %d %d %g %g %g\n"
                % (
                    seg.id,
                    n_hom,
                    n_het,
                    n_unk,
                    solved,
                    solved + n_hom,
                    no_support,
                    total,
                    (solved * 100.0 / total) if total else 0,
                    ((n_hom + solved) * 100.0 / total) if total else 0,
                    (solved * 100.0 / n_het) if n_het else 0,
                )
            )
        return placements


# ------------------------------------------------- count_support simulator


SV_TYPE = {"dup": 0, "del": 1, "trans": 2, "inv": 3, "ins": 4}


@dataclass
class SimSeg:
    id: int
    chrom: str
    start: int
    end: int
    depth: float = 0.0
    is_inv: bool = False
    is_ins: bool = False


@dataclass
class SeqMap:
    s_start: int
    s_end: int
    r_start: int
    r_end: int
    inv_indicator: str = "\0"


@dataclass
class SimJunc:
    left: SimSeg
    right: SimSeg
    support: int = 0


def read_sim_data(path: str, sv_type: int) -> List[SeqMap]:
    """Simulated SV map rows (count_support.cpp:52-85); inv rows carry a
    5th I/N indicator column."""
    out: List[SeqMap] = []
    with open(path, "r") as fin:
        lines = fin.read().splitlines()
    for line in lines[1:]:
        parts = line.split()
        if sv_type in (0, 1, 2) and len(parts) >= 4:
            out.append(SeqMap(*(int(v) for v in parts[:4])))
        elif sv_type == 3 and len(parts) >= 5:
            out.append(SeqMap(*(int(v) for v in parts[:4]), parts[4]))
    return out


def read_sim_segs(path: str) -> List[SimSeg]:
    """`id chrom start end count` rows after a header
    (count_support.cpp:87-106)."""
    out: List[SimSeg] = []
    with open(path, "r") as fin:
        lines = fin.read().splitlines()
    for line in lines[1:]:
        parts = line.split()
        if len(parts) >= 4:
            out.append(SimSeg(int(parts[0]), parts[1], int(parts[2]), int(parts[3])))
    return out


def get_seg_seq(seq_maps: List[SeqMap], segs: List[SimSeg]) -> List[SimSeg]:
    """Map each SV-map row to the segment starting at r_start
    (count_support.cpp:109-118)."""
    seq: List[SimSeg] = []
    for row in seq_maps:
        seg = next(s for s in segs if s.start == row.r_start)
        seg.is_inv = row.inv_indicator == "I"
        seq.append(seg)
    return seq


def get_sim_juncs(seg_seq: List[SimSeg]) -> List[SimJunc]:
    """Distinct adjacent (left, right) pairs (count_support.cpp:120-141)."""
    juncs: List[SimJunc] = []
    for left, right in zip(seg_seq, seg_seq[1:]):
        if not any(j.left is left and j.right is right for j in juncs):
            juncs.append(SimJunc(left, right))
    return juncs


def read_depth_table(path: str) -> Dict[str, Dict[int, int]]:
    """`chrom pos depth` rows (samtools-depth style, optionally gz)."""
    table: Dict[str, Dict[int, int]] = {}
    with _open_text(path) as fin:
        for line in fin:
            parts = line.split()
            if len(parts) >= 3:
                table.setdefault(parts[0], {})[int(parts[1])] = int(parts[2])
    return table


def fill_avg_depth(segs: List[SimSeg], depth_table: Dict[str, Dict[int, int]]) -> None:
    """Mean depth over [start, end-1] 1-based — the reference queries
    tabix with (start-1, end-1) but divides by end-start+1
    (count_support.cpp:275-298)."""
    for seg in segs:
        per_pos = depth_table.get(seg.chrom, {})
        tot = sum(per_pos.get(p, 0) for p in range(seg.start, seg.end))
        seg.depth = tot * 1.0 / (seg.end - seg.start + 1)


def junction_windows(junc: SimJunc) -> Tuple[int, int, Tuple[int, int], Tuple[int, int]]:
    """Breakpoint positions and ±10bp overlap windows for split-read
    support (count_support.cpp:180-226): a non-inverted left partner
    breaks at its end, an inverted one at its start; symmetrically for
    the right partner."""
    left_pos = junc.left.start if junc.left.is_inv else junc.left.end
    right_pos = junc.right.end if junc.right.is_inv else junc.right.start
    if junc.left.is_inv:
        left_win = (left_pos - 1, left_pos - 1 + 10)
    else:
        left_win = (left_pos - 9 - 1 - 1, left_pos - 1)
    if junc.right.is_inv:
        right_win = (right_pos - 9 - 1 - 1, right_pos - 1)
    else:
        right_win = (right_pos - 1, right_pos - 1 + 10)
    return left_pos, right_pos, left_win, right_win


def overlap_len(aln_start: int, aln_end: int, start: int, end: int) -> int:
    """Closed-interval overlap, negative when disjoint
    (count_support.cpp:143-160)."""
    return min(aln_end, end) - max(aln_start, start) + 1


def count_split_support(
    juncs: List[SimJunc],
    reads: List[AlnRead],
    sa_pairs: Dict[str, List[AlnRead]],
) -> None:
    """Pure core of count_support (count_support.cpp:162-250): a read
    overlapping both breakpoint windows by >=10bp (via its SA supplement)
    supports the junction; a self-junction (left_pos == right_pos) counts
    reads spanning the point by >=20bp."""
    for junc in juncs:
        left_pos, right_pos, left_win, right_win = junction_windows(junc)
        for read in reads:
            aln_end = read.pos + cigar_rlen(read.cigar) - 1
            if left_pos == right_pos:
                if overlap_len(read.pos, aln_end, left_pos - 11, right_pos + 9) >= 20:
                    junc.support += 1
                continue
            for mate in sa_pairs.get(read.qname, []):
                if mate is read:
                    continue
                mate_end = mate.pos + cigar_rlen(mate.cigar) - 1
                lo = overlap_len(read.pos, aln_end, *left_win)
                ro = overlap_len(mate.pos, mate_end, *right_win)
                if lo >= 10 and ro >= 10:
                    junc.support += 1


def median_int(values: List[float]) -> int:
    """The reference's "median": element at index n/2 of the sorted list
    (count_support.cpp:300-316), not the statistical median."""
    vals = sorted(int(v) for v in values)
    return vals[len(vals) // 2] if vals else 0


def write_sim_lh(path: str, segs: List[SimSeg], juncs: List[SimJunc], sample: str) -> None:
    """Legacy-format LH writer (count_support.cpp:318-340). Keeps the
    reference's `SAMPLE` header key even though the LH parser only
    recognizes SAMPLE_NAME (src/Graph.cpp:140) — a preserved quirk."""
    with open(path, "w") as f:
        f.write("SAMPLE %s\n" % sample)
        f.write("AVG_SEG_DP %d\n" % median_int([s.depth for s in segs]))
        f.write("AVG_JUNC_DP %d\n" % median_int([float(j.support) for j in juncs]))
        f.write("PURITY 1\nAVG_PLOIDY 1\nPLOIDY 1\n")
        f.write("SOURCE H:1\n")
        f.write("SINK H:%d\n" % segs[-1].id)
        for s in segs:
            f.write("SEG H:%d:%s:%d:%d %g -1\n" % (s.id, s.chrom, s.start, s.end, s.depth))
        for j in juncs:
            f.write("JUNC H:%d:+ H:%d:+ %d -1 U B\n" % (j.left.id, j.right.id, j.support))


def write_sim_segs(path: str, segs: List[SimSeg]) -> None:
    with open(path, "w") as f:
        f.write("id\tchrom\tstart\tend\tdepth\tis_inv\tis_ins\n")
        for s in segs:
            f.write(
                "%d\t%s\t%d\t%d\t%g\t%s\t%s\n"
                % (s.id, s.chrom, s.start, s.end, s.depth, s.is_inv, s.is_ins)
            )


def write_sim_juncs(path: str, juncs: List[SimJunc]) -> None:
    with open(path, "w") as f:
        f.write("id_5p\tid_3p\tsupport\n")
        for j in juncs:
            f.write("%d\t%d\t%d\n" % (j.left.id, j.right.id, j.support))


def _bam_reads_and_sa(bam_path: str):  # pragma: no cover - needs pysam+BAM
    import pysam  # type: ignore

    reads: List[AlnRead] = []
    sa_pairs: Dict[str, List[AlnRead]] = {}
    with pysam.AlignmentFile(bam_path, "rb") as bam:
        for aln in bam:
            if aln.is_unmapped or aln.cigartuples is None:
                continue
            rd = AlnRead(
                aln.query_name,
                aln.reference_start,
                aln.cigartuples,
                aln.query_sequence or "",
                aln.mapping_quality,
                aln.flag,
            )
            reads.append(rd)
            if aln.has_tag("SA"):
                sa_pairs.setdefault(aln.query_name, []).append(rd)
    return reads, sa_pairs


def main(argv=None) -> int:
    """CLI covering countsupport.cpp:8-24 and count_support.cpp:368-439."""
    parser = argparse.ArgumentParser(prog="support_profile")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("countsupport", help="allele-pair support from VCF+BAM")
    p.add_argument("vcf")
    p.add_argument("bam")
    p.add_argument("sample")
    p.add_argument("out")
    p.add_argument("--chrom", default="chr6")
    p.add_argument("--start", type=int, default=28460000)
    p.add_argument("--end", type=int, default=33500000)

    p = sub.add_parser("count_support", help="simulated SV support tables")
    p.add_argument("--seg_file", "-s", required=True)
    p.add_argument("--data_file", "-j", required=True)
    p.add_argument("--bam", "-b", default="")
    p.add_argument("--depth", "-d", default="")
    p.add_argument("--svtype", "-t", required=True, choices=sorted(SV_TYPE))
    p.add_argument("--seg_out", "-S", required=True)
    p.add_argument("--junc_out", "-J", required=True)
    p.add_argument("--lh_out", default="")
    p.add_argument("--sample", default="sim")

    args = parser.parse_args(argv)
    if args.cmd == "countsupport":
        db = LocusDB(args.chrom, args.start, args.end)
        db.read_vcf(args.vcf)
        sp = SupportProfile(args.sample)
        sp.set_loci_ref(db)
        sp.read_genotypes(args.vcf)
        sp.count_support(args.bam)
        sp.write_support(args.out)
    else:
        seq_maps = read_sim_data(args.data_file, SV_TYPE[args.svtype])
        segs = read_sim_segs(args.seg_file)
        seg_seq = get_seg_seq(seq_maps, segs)
        juncs = get_sim_juncs(seg_seq)
        if args.depth:
            fill_avg_depth(segs, read_depth_table(args.depth))
        if args.bam:
            reads, sa_pairs = _bam_reads_and_sa(args.bam)
            count_split_support(juncs, reads, sa_pairs)
        write_sim_segs(args.seg_out, segs)
        write_sim_juncs(args.junc_out, juncs)
        if args.lh_out:
            write_sim_lh(args.lh_out, segs, juncs, args.sample)
    return 0


if __name__ == "__main__":
    sys.exit(main())
