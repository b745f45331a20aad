"""Ports of the reference's deprecated C++ profiling tools.

Capability ports of the (commented-out) deprecated mains:
- `juncdb segs/indv/create`  (juncdb.cpp:12-95)
- SVprofile                  (src/SVprofile.cpp — raw
  seeksv-style SV parsing, clip/cigar filtering, pos->segment-id
  mapping, per-segment depth, normal-junction counting, legacy-LH and
  normal/abnormal junction writers)
- SegmentDB                  (src/SegmentDB.cpp —
  breakpoint union -> segment list)
- count_support / SupportProfile (allele-support counting; BAM access
  gated on pysam)

All coordinates follow the reference's 0-based internal convention
(inputs are 1-based and shifted on read, outputs shifted back).
"""

from __future__ import annotations

import gzip
import sys
from bisect import bisect_left
from dataclasses import dataclass
from typing import List, Optional, Tuple

SVInfo = Tuple[str, int, str, str, int, str]
SVSupport = Tuple[int, str, int, str]  # left_clip, left_cigar, right_clip, right_cigar


@dataclass
class Seg:
    id: int
    chr: str
    start: int
    end: int


class SegmentDB:
    """Breakpoint set -> segment list (SegmentDB.cpp)."""

    def __init__(self, chrom: str, region_start: int, region_end: int):
        self.chr = chrom
        self.region_start = region_start
        self.region_end = region_end
        self.bps: List[int] = []
        self.segs: List[Seg] = []

    def read_segs(self, path: str) -> None:
        self.segs = []
        self.bps = []
        for line in open(path).read().splitlines():
            if not line:
                continue
            chrom, seg_id, start, end = line.split()[:4]
            self.segs.append(Seg(int(seg_id) - 1, chrom, int(start) - 1, int(end) - 1))
            self.bps.append(int(end) - 1)
        if self.bps:
            self.bps.pop()

    def update_bps(self, profile: "SVProfile") -> None:
        for bp in profile.bps:
            idx = bisect_left(self.bps, bp)
            if idx == len(self.bps) or self.bps[idx] != bp:
                self.bps.insert(idx, bp)

    def construct_segs_from_bps(self) -> None:
        self.segs = [Seg(0, self.chr, self.region_start, self.bps[0])]
        for i in range(len(self.bps) - 1):
            self.segs.append(Seg(i + 1, self.chr, self.bps[i], self.bps[i + 1]))
        self.segs.append(Seg(len(self.bps), self.chr, self.bps[-1], self.region_end))

    def write_segs(self, path: str) -> None:
        with open(path, "w") as f:
            for s in self.segs:
                f.write("%s %d %d %d\n" % (s.chr, s.id + 1, s.start + 1, s.end + 1))


def cigar_match_num(cigar: str) -> int:
    """Total M length in a CIGAR string (SVprofile::getMatchNum)."""
    match = 0
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        elif ch in "MIDNSHP=X":
            if ch == "M" and num:
                match += int(num)
            num = ""
    return match


class SVProfile:
    """Raw SV profile from a seeksv-style table (SVprofile.cpp).

    Raw columns: leftChr leftPos leftStrand leftClip rightChr rightPos
    rightStrand rightClip <11 skipped> leftCigar rightCigar.
    """

    def __init__(self, raw_sv_path: Optional[str], sample: str):
        self.sample = sample
        self.bps: List[int] = []
        self.abnormal_info: List[SVInfo] = []
        self.abnormal_supports: List[SVSupport] = []
        self._raw_info: List[SVInfo] = []
        self._raw_supports: List[SVSupport] = []
        self.normal_info: List[SVInfo] = []
        self.normal_supports: List[SVSupport] = []
        self.avg_dp = 0.0
        self.seg_depth: List[float] = []
        self.segdb: Optional[SegmentDB] = None
        if raw_sv_path:
            self.read_raw_sv(raw_sv_path)

    def read_raw_sv(self, path: str) -> None:
        lines = open(path).read().splitlines()
        for line in lines[1:]:
            tok = line.split()
            if len(tok) < 21:
                continue
            left_chr, left_pos, left_strand, left_clip = tok[0], int(tok[1]), tok[2], int(tok[3])
            right_chr, right_pos, right_strand, right_clip = tok[4], int(tok[5]), tok[6], int(tok[7])
            left_cigar, right_cigar = tok[19], tok[20]
            self.insert_sv_entry(
                left_chr, left_pos - 1, left_strand, left_clip, left_cigar,
                right_chr, right_pos - 1, right_strand, right_clip, right_cigar,
            )
        self._raw_info = list(self.abnormal_info)
        self._raw_supports = list(self.abnormal_supports)

    def insert_sv_entry(
        self, lc, lp, ls, lclip, lcig, rc, rp, rs, rclip, rcig
    ) -> None:
        info: SVInfo = (lc, lp, ls, rc, rp, rs)
        idx = bisect_left(self.abnormal_info, info)
        if idx == len(self.abnormal_info) or self.abnormal_info[idx] != info:
            self.abnormal_info.insert(idx, info)
            self.abnormal_supports.insert(idx, (lclip, lcig, rclip, rcig))
            for bp in (lp, rp):
                b = bisect_left(self.bps, bp)
                if b == len(self.bps) or self.bps[b] != bp:
                    self.bps.insert(b, bp)
        else:
            old = self.abnormal_supports[idx]
            self.abnormal_supports[idx] = (old[0] + lclip, old[1], old[2] + rclip, old[3])

    def filter_abnormal(
        self, chrom: str, start: int, end: int, clip_thres: int = 5, match_thres: int = 19
    ) -> None:
        self.bps = []
        self.abnormal_info = []
        self.abnormal_supports = []
        for info, support in zip(self._raw_info, self._raw_supports):
            lc, lp, ls, rc, rp, rs = info
            lclip, lcig, rclip, rcig = support
            if (
                lc == chrom
                and rc == chrom
                and start <= lp <= end
                and start <= rp <= end
                and cigar_match_num(lcig) >= match_thres
                and cigar_match_num(rcig) >= match_thres
                and lclip + rclip >= clip_thres
            ):
                self.insert_sv_entry(lc, lp, ls, lclip, lcig, rc, rp, rs, rclip, rcig)

    def set_segdb(self, segdb: SegmentDB) -> None:
        self.segdb = segdb

    def pos2id(self) -> None:
        """Map breakpoint positions to segment ids (SVprofile::pos2id)."""
        bps = self.segdb.bps
        out = []
        for (lc, lp, ls, rc, rp, rs) in self.abnormal_info:
            id_left = bisect_left(bps, lp)
            id_right = bisect_left(bps, rp) + 1
            out.append((lc, id_left, ls, rc, id_right, rs))
        self.abnormal_info = out

    def count_seg_depth(self, depth_path: str) -> None:
        """Average depth per segment from a (chr pos depth) text file,
        gz or plain (SVprofile::countSegDepth)."""
        segs = self.segdb.segs
        self.seg_depth = [0.0] * len(segs)
        opener = gzip.open if depth_path.endswith(".gz") else open
        seg_idx = 0
        s = segs[seg_idx]
        tot_depth = 0.0
        self.avg_dp = 0.0
        with opener(depth_path, "rt") as f:
            for line in f:
                tok = line.split()
                if len(tok) < 3:
                    continue
                chrom, pos, depth = tok[0], int(tok[1]), float(tok[2])
                if chrom != s.chr:
                    continue
                tot_depth += depth
                self.avg_dp += depth
                if pos - 1 == s.end:
                    self.seg_depth[seg_idx] = tot_depth / (s.end - s.start + 1)
                    tot_depth = depth
                    seg_idx += 1
                    if seg_idx >= len(segs):
                        break
                    s = segs[seg_idx]
        self.avg_dp /= segs[-1].end - segs[0].start + 1

    def count_normal(self, bam_path: str, end_match_thres: int = 5) -> None:
        """Reads spanning each internal segment boundary (needs pysam)."""
        try:
            import pysam  # type: ignore
        except ImportError as e:
            raise RuntimeError("count_normal requires pysam") from e
        self.normal_info = []
        self.normal_supports = []
        bam = pysam.AlignmentFile(bam_path, "rb")
        for i in range(len(self.segdb.segs) - 1):
            s = self.segdb.segs[i]
            support = 0
            for aln in bam.fetch(s.chr, s.end, s.end + 1):
                covered = aln.reference_length or 0
                if (
                    s.end - aln.reference_start + 1 >= end_match_thres
                    and aln.reference_start + 1 + covered - s.end >= end_match_thres
                ):
                    support += 1
            self.normal_info.append((s.chr, s.id, "+", s.chr, s.id + 1, "+"))
            self.normal_supports.append((support, "", support, ""))

    def set_normal_from_counts(self, counts: List[int]) -> None:
        """Inject boundary-spanning read counts directly (the logic path
        of count_normal, testable without a BAM)."""
        self.normal_info = []
        self.normal_supports = []
        for i in range(len(self.segdb.segs) - 1):
            s = self.segdb.segs[i]
            support = counts[i] if i < len(counts) else 0
            self.normal_info.append((s.chr, s.id, "+", s.chr, s.id + 1, "+"))
            self.normal_supports.append((support, "", support, ""))

    # -------------------------------------------------------------- writers

    def write_local_hap(self, path: str) -> None:
        """Legacy-format LH (SVprofile::writeLocalHap; cf. script/test.lh)."""
        segs = self.segdb.segs
        with open(path, "w") as f:
            f.write("SAMPLE %s\n" % self.sample)
            f.write("AVG_DP %g\n" % self.avg_dp)
            f.write("PURITY 1\nAVG_PLOIDY 2\nPLOIDY 2m1\n")
            f.write("SOURCE H:%d\n" % (segs[0].id + 1))
            f.write("SINK H:%d\n" % (segs[-1].id + 1))
            for s in segs:
                f.write("SEG H:%d %g\n" % (s.id + 1, self.seg_depth[s.id]))
            for info, sup in zip(self.abnormal_info, self.abnormal_supports):
                f.write(
                    "JUNC H:%d:%s H:%d:%s %d\n"
                    % (info[1] + 1, info[2], info[4] + 1, info[5], sup[0] + sup[2])
                )
            for info, sup in zip(self.normal_info, self.normal_supports):
                f.write(
                    "JUNC H:%d:%s H:%d:%s %d\n"
                    % (info[1] + 1, info[2], info[4] + 1, info[5], sup[0])
                )

    def _write_junc_table(self, path: str, infos, sups, sum_clips: bool) -> None:
        with open(path, "w") as f:
            for info, sup in zip(infos, sups):
                val = sup[0] + sup[2] if sum_clips else sup[0] + sup[2]
                f.write(
                    "%d %s %d %s %d\n" % (info[1] + 1, info[2], info[4] + 1, info[5], val)
                )

    def write_abnormal(self, path: str) -> None:
        self._write_junc_table(path, self.abnormal_info, self.abnormal_supports, True)

    def write_normal(self, path: str) -> None:
        self._write_junc_table(path, self.normal_info, self.normal_supports, True)


# ------------------------------------------------------------- juncdb ops

def juncdb_segs(raw_sv_list: str, chrom: str, start: int, end: int, out_segs: str) -> None:
    """Breakpoint union across samples -> SegmentDB (juncdb.cpp:13-38)."""
    segdb = SegmentDB(chrom, start - 1, end - 1)
    for line in open(raw_sv_list).read().splitlines():
        if not line:
            continue
        sample, path = line.split()[:2]
        sv = SVProfile(path, sample)
        sv.filter_abnormal(chrom, start - 1, end - 1)
        segdb.update_bps(sv)
    segdb.construct_segs_from_bps()
    segdb.write_segs(out_segs)


def juncdb_create(normal_list: str, abnormal_list: str, out_db: str) -> None:
    """Merge per-sample junction tables into one DB (juncdb.cpp:72-94).
    Input lines: leftId leftStrand rightId rightStrand support."""
    from ambigram_tpu_torch.legacy.juncdb import JunctionDB

    db = JunctionDB()
    for list_path in (normal_list, abnormal_list):
        for fn in open(list_path).read().splitlines():
            if not fn:
                continue
            for line in open(fn).read().splitlines():
                tok = line.split()
                if len(tok) < 5:
                    continue
                db.insert_record(
                    tok[0], int(tok[0]) if tok[0].isdigit() else 0, tok[1][0],
                    tok[2], int(tok[2]) if tok[2].isdigit() else 0, tok[3][0],
                    int(float(tok[4])),
                )
    with open(out_db, "w") as f:
        f.write("chrom_5p\tpos_5p\tstrand_5p\tchrom_3p\tpos_3p\tstrand_3p\tcount\n")
        for rec in db.records:
            for ent in rec.forward_entries:
                if not ent.is_complement:
                    f.write(
                        "%s\t%d\t%s\t%s\t%d\t%s\t%d\n"
                        % (rec.chrom, rec.pos, rec.strand, ent.chrom, ent.pos, ent.strand, ent.support)
                    )


def count_allele_support(reads: List[Tuple[int, str]], pos: int, alleles: Tuple[str, str]) -> Tuple[int, int]:
    """Allele-support counting at a SNP position given (read_start,
    sequence) pairs — the pileup logic of SupportProfile.cpp:92-150
    without htslib."""
    ref_n = alt_n = 0
    for start, seq in reads:
        off = pos - start
        if 0 <= off < len(seq):
            base = seq[off].upper()
            if base == alleles[0].upper():
                ref_n += 1
            elif base == alleles[1].upper():
                alt_n += 1
    return ref_n, alt_n


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: juncdb_tool {segs,indv,create} ...", file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "segs":
        raw_list, chrom, start, end, out = rest[:5]
        juncdb_segs(raw_list, chrom, int(start), int(end), out)
    elif cmd == "indv":
        (segs_fn, raw_sv, bam, depth, chrom, start, end, out_lh, out_norm, out_abn, sample) = rest[:11]
        segdb = SegmentDB(chrom, int(start), int(end))
        segdb.read_segs(segs_fn)
        sv = SVProfile(raw_sv, sample)
        sv.filter_abnormal(chrom, int(start) - 1, int(end) - 1)
        sv.set_segdb(segdb)
        sv.pos2id()
        sv.count_seg_depth(depth)
        if bam and bam != "-":
            sv.count_normal(bam)
        else:
            sv.set_normal_from_counts([0] * len(segdb.segs))
        sv.write_local_hap(out_lh)
        sv.write_normal(out_norm)
        sv.write_abnormal(out_abn)
    elif cmd == "create":
        normal_list, abnormal_list, out_db = rest[:3]
        juncdb_create(normal_list, abnormal_list, out_db)
    else:
        print("unknown subcommand: %s" % cmd, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
