"""Preprocessing subcommands: SV/SEG/LH generation and converters.

Port of the reference's `script/bfb_scripts.py` dispatcher
(script/bfb_scripts.py:6-613) with the same subcommand
names and file formats:

  seg2bed      SEG file -> BED               (bfb_scripts.py:14-29)
  sniffles2sv  sniffles VCF -> SV table      (bfb_scripts.py:210-243)
  svaba2sv     svaba VCF -> SV table         (bfb_scripts.py:244-279)
  OM2juncs     SegAligner output -> .juncs   (bfb_scripts.py:280-298)
  cluster_sv   distance-cluster SVs,
               keep FBI-containing clusters  (bfb_scripts.py:352-403)
  generate_seg SV (+BAM) -> SEG              (bfb_scripts.py:412-473)
  call_depth   SEG + BAM -> per-base depth   (bfb_scripts.py:474-500)
  generate_lh  SV + SEG -> LH                (bfb_scripts.py:528-611)

BAM access requires pysam; commands degrade exactly like the reference
("no BAM => depth 100", bfb_scripts.py:443-447) or fail with a clear
message when pysam is genuinely required.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence

INF = float("inf")


# ------------------------------------------------------------------ seg2bed

def seg2bed(seg_path: str, prefix: str = "test") -> str:
    segments = []
    for line in open(seg_path, "r").read().splitlines():
        info = line.split(" ")
        chr_name, bkp = info[0].split(":")
        start, end = bkp.split("-")
        segments.append([chr_name, start, end] + info[1:])
    out_path = "%s_seg.bed" % prefix
    with open(out_path, "w") as output:
        for segment in segments:
            output.write("\t".join(segment) + "\n")
    return out_path


# -------------------------------------------------------------- converters

def sniffles2sv(vcf_path: str, prefix: str = "test") -> str:
    """sniffles VCF -> SV table (strand remap per bfb_scripts.py:226-234)."""
    sv = []
    for line in open(vcf_path, "r").read().splitlines():
        if line.startswith("#") or not line:
            continue
        info = line.split("\t")
        prop = {}
        for elem in info[7].split(";")[1:]:
            if "=" in elem:
                k, v = elem.split("=", 1)
                prop[k] = v
        chr1, pos1 = info[0], info[1]
        chr2, pos2 = prop["CHR2"], prop["END"]
        str1, str2 = "+", "+"
        strands = prop.get("STRANDS", "")
        if strands == "++":
            str1, str2 = "+", "-"
        elif strands == "--":
            str1, str2 = "-", "+"
        elif strands == "+-":
            str1, str2 = "+", "+"
        elif strands == "-+":
            str1, str2 = "-", "-"
        depth = info[-1].split(":")[-1]
        sv.append([chr1, pos1, str1, chr2, pos2, str2, depth])
    out_path = "%s_sv.txt" % prefix
    with open(out_path, "w") as f:
        f.write("chr_3p\tbkp_3p\tstr_3p\tchr_5p\tbkp_5p\tstr_5p\tdepth\n")
        for info in sv:
            f.write("\t".join(info) + "\n")
    return out_path


def svaba2sv(vcf_path: str, prefix: str = "test") -> str:
    """svaba VCF -> SV table (breakend bracket parsing, bfb_scripts.py:251-272)."""
    sv = []
    for line in open(vcf_path, "r").read().splitlines():
        if line.startswith("#") or not line:
            continue
        info = line.split("\t")
        if info[2][-1] == "2":
            continue  # keep only breakend mate 1
        end = info[4].split("[")
        str1, str2 = "+", "+"
        if "]" in info[4]:
            end = info[4].split("]")
            str2 = "-"
        if end[0] == "":
            str1 = "-"
        chr1, bkp1 = info[0], info[1]
        chr2, bkp2 = end[1].split(":")
        key, num = info[8].split(":"), info[12].split(":")
        data = dict(zip(key, num))
        sv.append([chr1, bkp1, str1, chr2, bkp2, str2, data["AD"]])
    out_path = "%s_sv.txt" % prefix
    with open(out_path, "w") as f:
        f.write("chr_3p\tbkp_3p\tstr_3p\tchr_5p\tbkp_5p\tstr_5p\tdepth\n")
        for info in sv:
            f.write("\t".join(info) + "\n")
    return out_path


def om2juncs(input_path: str, prefix: str = "test") -> str:
    """SegAligner optical-map alignment -> one .juncs line."""
    res = ""
    for line in open(input_path, "r").read().splitlines():
        if line.startswith("#") or not line:
            continue
        seg = line.split("\t")[0]
        if seg.startswith("-"):
            res += seg[1:] + seg[0] + " "
        else:
            res += seg + "+ "
    out_path = "%s.juncs" % prefix
    with open(out_path, "w") as f:
        f.write(res[:-1])
    return out_path


# -------------------------------------------------------------- cluster_sv

def _min_dis(sv1: List[str], sv2: List[str]) -> float:
    diff1 = abs(int(sv1[1]) - int(sv2[1])) if sv1[0] == sv2[0] else INF
    diff2 = abs(int(sv1[1]) - int(sv2[4])) if sv1[0] == sv2[3] else INF
    diff3 = abs(int(sv1[4]) - int(sv2[1])) if sv1[3] == sv2[0] else INF
    diff4 = abs(int(sv1[4]) - int(sv2[4])) if sv1[3] == sv2[3] else INF
    return min(diff1, diff2, diff3, diff4)


def _set_range(chr_range: Dict[str, List[int]], sv: List[str]) -> Dict[str, List[int]]:
    for chrom, pos in ((sv[0], int(sv[1])), (sv[3], int(sv[4]))):
        if chrom in chr_range:
            chr_range[chrom][0] = min(chr_range[chrom][0], pos)
            chr_range[chrom][1] = max(chr_range[chrom][1], pos)
        else:
            chr_range[chrom] = [pos, pos]
    return chr_range


def _check_range(chr_range: Dict[str, List[int]], max_range: int) -> bool:
    return all(v[1] - v[0] <= max_range for v in chr_range.values())


def _has_fbi(sv_ids: List[int], sv: List[List[str]]) -> bool:
    return any(sv[i][0] == sv[i][3] and sv[i][2] != sv[i][5] for i in sv_ids)


def cluster_sv(
    sv_path: str,
    max_dis: int = 1000000,
    max_range: int = 10000000,
    sample_name: str = "test",
) -> List[str]:
    """BFS distance-clustering of SVs; only clusters containing a
    fold-back inversion are emitted (bfb_scripts.py:393)."""
    juncs: List[List[str]] = []
    for line in open(sv_path).read().splitlines()[1:]:
        if not line:
            continue
        info = line.split("\t")
        if info[2] == "-" and info[5] == "-":
            info[2], info[5] = "+", "+"
            info[0], info[3] = info[3], info[0]
            info[1], info[4] = info[4], info[1]
        juncs.append(info)
    juncs.sort(key=lambda x: x[0])
    cluster: List[List[int]] = []
    sv_idx = list(range(len(juncs)))
    while sv_idx:
        subcluster = [sv_idx[0]]
        queue = [sv_idx[0]]
        chr_range: Dict[str, List[int]] = {}
        _set_range(chr_range, juncs[sv_idx[0]])
        sv_idx.pop(0)
        while queue:
            idx = queue.pop(0)
            for i in list(sv_idx):
                if _min_dis(juncs[i], juncs[idx]) < max_dis:
                    temp_range = {k: list(v) for k, v in chr_range.items()}
                    _set_range(temp_range, juncs[i])
                    if _check_range(temp_range, max_range):
                        _set_range(chr_range, juncs[i])
                        queue.append(i)
                        subcluster.append(i)
                        sv_idx.remove(i)
        if _has_fbi(subcluster, juncs):
            cluster.append(subcluster)
    out_paths = []
    for i, sub in enumerate(cluster):
        path = "%s_%d_sv.txt" % (sample_name, i + 1)
        with open(path, "w") as f:
            f.write("chrom_5p\tbkpos_5p\tstrand_5p\tchrom_3p\tbkpos_3p\tstrand_3p\tavg_cn\n")
            for idx in sub:
                f.write("\t".join(juncs[idx]) + "\n")
        out_paths.append(path)
    return out_paths


# ------------------------------------------------------------ generate_seg

def depth2cn(sample_depth: float, wgs_depth: float, purity: float) -> float:
    ploidy = 2
    haplo_depth = wgs_depth * purity / ploidy
    return sample_depth / haplo_depth


def coverage_mean(count_matrix: Sequence[Sequence[float]]) -> float:
    """Mean total depth over positions given a 4 x L ACGT count matrix —
    the vectorized equivalent of the reference's per-position loop
    (bfb_scripts.py:452-460)."""
    import numpy as np

    arr = np.asarray(count_matrix, dtype=np.float64)
    return float(arr.sum(axis=0).mean())


def generate_seg(
    sv_path: str,
    bam_path: Optional[str] = None,
    sample_name: str = "test",
    wgs_depth: int = 30,
    purity: float = 1.0,
) -> str:
    sv, pos = [], {}
    for line in open(sv_path, "r").read().splitlines()[1:]:
        if not line:
            continue
        info = line.split("\t")
        info[1], info[4] = int(info[1]), int(info[4])
        sv.append(info)
        pos.setdefault(info[0], []).append(info[1])
        pos.setdefault(info[3], []).append(info[4])
    for key in pos:
        arr = sorted(set(pos[key]))
        arr.insert(0, max(1, arr[0] - 1000))
        arr.append(arr[-1] + 1000)
        pos[key] = arr

    seg_depth: Dict[str, float] = {}
    if bam_path is None:
        for chrom, arr in pos.items():
            for n in range(1, len(arr)):
                key = "%s:%d-%d" % (chrom, arr[n - 1], arr[n])
                seg_depth[key] = 100
    else:
        try:
            import pysam  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "generate_seg with a BAM file requires pysam; run without "
                "--bam_file to use the depth=100 stub"
            ) from e
        bam = pysam.AlignmentFile(bam_path, "rb")
        for chrom, arr in pos.items():
            for n in range(1, len(arr)):
                cnt = bam.count_coverage(chrom, arr[n - 1], arr[n], quality_threshold=0)
                name = "%s:%d-%d" % (chrom, arr[n - 1], arr[n])
                seg_depth[name] = coverage_mean(cnt)
    if wgs_depth != 30 and purity != 1:
        for key in seg_depth:
            seg_depth[key] = depth2cn(seg_depth[key], wgs_depth, purity)
    out_path = "%s_seg.txt" % sample_name
    with open(out_path, "w") as f:
        for key, value in seg_depth.items():
            f.write("%s\t%s\n" % (key, value))
    return out_path


def call_depth(seg_path: str, bam_path: str, sample_name: str = "test") -> str:
    try:
        import pysam  # type: ignore
    except ImportError as e:
        raise RuntimeError("call_depth requires pysam") from e
    import numpy as np

    bam = pysam.AlignmentFile(bam_path, "rb")
    out_path = "%s_coverage.txt" % sample_name
    with open(out_path, "w") as out:
        for line in open(seg_path).read().splitlines():
            region = line.split("\t")[0]
            ref, bkp = region.split(":")[0], region.split(":")[1].split("-")
            cnt = bam.count_coverage(ref, int(bkp[0]), int(bkp[1]) + 1, quality_threshold=0)
            depth = np.asarray(cnt).sum(axis=0)
            start = int(bkp[0])
            for i, d in enumerate(depth):
                out.write("%s\t%d\t%d\n" % (ref, start + i, int(d)))
    return out_path


# ------------------------------------------------------------- generate_lh

def find_segment(segs: List[List], bkp: Sequence, is_start: bool):
    """Nearest-segment breakpoint snap (bfb_scripts.py:500-512)."""
    is_left = True
    if (is_start and bkp[2] == "+") or (not is_start and bkp[2] == "-"):
        is_left = False
    seg_id = len(segs)
    min_dis = INF
    for seg in segs:
        if bkp[0] == seg[1]:
            if is_left and abs(int(seg[2]) - int(bkp[1])) < min_dis:
                seg_id, min_dis = seg[0], abs(int(seg[2]) - int(bkp[1]))
            elif not is_left and abs(int(seg[3]) - int(bkp[1])) < min_dis:
                seg_id, min_dis = seg[0], abs(int(seg[3]) - int(bkp[1]))
    return seg_id


def has_duplicate_sv(sv: List[List], info: List) -> int:
    """Dedup matching either orientation (bfb_scripts.py:514-526)."""
    for junc in sv:
        if junc[0] == info[0] and junc[2] == info[2]:
            if junc[1] == info[1] and junc[3] == info[3]:
                return sv.index(junc)
        elif junc[0] == info[2] and junc[2] == info[0]:
            if info[1] != info[3]:
                if junc[1] == info[1] and junc[3] == info[3]:
                    return sv.index(junc)
            else:
                if junc[1] != info[1] and junc[3] != info[3]:
                    return sv.index(junc)
    return -1


def generate_lh(
    sv_path: str,
    seg_path: str,
    coverage: int = 30,
    purity: float = 1.0,
    is_depth: bool = False,
    is_seg_depth: bool = False,
    is_sv_depth: bool = False,
    sample_name: str = "test",
    prop: str = "",
) -> str:
    segs = []
    source_segs, sink_segs = [1], []
    cnt = 1
    for line in open(seg_path, "r").read().splitlines():
        if not line:
            continue
        info = line.split("\t")
        chr_name, interval = info[0].split(":")
        start, end = interval.split("-")
        segs.append([cnt, chr_name, start, end, info[1]])
        if chr_name != segs[source_segs[-1] - 1][1]:
            sink_segs.append(cnt - 1)
            source_segs.append(cnt)
        cnt += 1
    sink_segs.append(cnt - 1)

    sv = []
    for line in open(sv_path, "r").read().splitlines()[1:]:
        if not line:
            continue
        info = line.split("\t")
        seg1 = find_segment(segs, info[:3], True)
        seg2 = find_segment(segs, info[3:6], False)
        # skip reference adjacencies (bfb_scripts.py:562-565)
        if int(seg1) + 1 == int(seg2) and info[2] == info[5] and info[2] == "+":
            continue
        if int(seg1) == int(seg2) + 1 and info[2] == info[5] and info[2] == "-":
            continue
        junc_index = has_duplicate_sv(sv, [seg1, info[2], seg2, info[5]])
        if junc_index != -1:
            if float(info[6]) > float(sv[junc_index][-1]):
                sv[junc_index][-1] = info[6]
        else:
            sv.append([seg1, info[2], seg2, info[5], info[6]])

    res = (
        "SAMPLE group1\n"
        "AVG_CHR_SEG_DP {c}\n"
        "AVG_WHOLE_HOST_DP {c}\n"
        "AVG_JUNC_DP {c}\n"
        "PURITY {p}\n"
        "AVG_TUMOR_PLOIDY 2\n"
        "PLOIDY 2m1\n"
        "VIRUS_START 7\n"
        "SOURCE {src}\n"
        "SINK {snk}\n"
    ).format(
        c=coverage,
        p=purity,
        src=",".join(str(e) for e in source_segs),
        snk=",".join(str(e) for e in sink_segs),
    )
    for i in range(len(segs)):
        # reference hard-maps chr18 to "virus" (bfb_scripts.py:578-580)
        if segs[i][1] == "chr18":
            segs[i][1] = "virus"
    if not is_seg_depth and not is_depth:
        for seg in segs:
            res += "SEG H:{}:{}:{}:{} {} {}\n".format(
                seg[0], seg[1], seg[2], seg[3], float(seg[4]) * 30, seg[4]
            )
    else:
        for seg in segs:
            res += "SEG H:{}:{}:{}:{} {} {}\n".format(
                seg[0], seg[1], seg[2], seg[3], seg[4], -1
            )
    if not is_sv_depth and not is_depth:
        for junc in sv:
            res += "JUNC H:{}:{} H:{}:{} {} {} U B\n".format(
                junc[0], junc[1], junc[2], junc[3], float(junc[4]) * 30, junc[4]
            )
    else:
        for junc in sv:
            res += "JUNC H:{}:{} H:{}:{} {} {} U B\n".format(
                junc[0], junc[1], junc[2], junc[3], junc[4], -1
            )
    res += prop
    out_path = "%s.lh" % sample_name
    with open(out_path, "w") as f:
        f.write(res)
    return out_path


# --------------------------------------------------------------- dispatcher

def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="preBFB")
    parser.add_argument(
        "subfunc",
        help="Available sub-functions: seg2bed, sniffles2sv, svaba2sv, "
        "OM2juncs, cluster_sv, generate_seg, call_depth, generate_lh",
    )
    args = parser.parse_args(argv[:1])
    rest = argv[1:]
    sub = args.subfunc

    def _bool(v):
        return str(v).lower() in ("1", "true", "yes", "on")

    if sub == "seg2bed":
        p = argparse.ArgumentParser()
        p.add_argument("-s", "--seg_file", dest="seg", required=True)
        p.add_argument("-p", "--prefix", dest="prefix", default="test")
        a = p.parse_args(rest)
        seg2bed(a.seg, a.prefix)
    elif sub == "sniffles2sv":
        p = argparse.ArgumentParser()
        p.add_argument("-v", "--vcf", required=True)
        p.add_argument("-p", "--prefix", default="test")
        a = p.parse_args(rest)
        sniffles2sv(a.vcf, a.prefix)
    elif sub == "svaba2sv":
        p = argparse.ArgumentParser()
        p.add_argument("-v", "--vcf", required=True)
        p.add_argument("-p", "--prefix", default="test")
        a = p.parse_args(rest)
        svaba2sv(a.vcf, a.prefix)
    elif sub == "OM2juncs":
        p = argparse.ArgumentParser()
        p.add_argument("-i", "--input", required=True)
        p.add_argument("-p", "--prefix", default="test")
        a = p.parse_args(rest)
        om2juncs(a.input, a.prefix)
    elif sub == "cluster_sv":
        p = argparse.ArgumentParser()
        p.add_argument("-sv", "--sv_file", dest="svPath", required=True)
        p.add_argument("-d", "--max_dis", type=int, default=1000000)
        p.add_argument("-r", "--max_range", type=int, default=10000000)
        p.add_argument("-s", "--sample_name", default="test")
        a = p.parse_args(rest)
        cluster_sv(a.svPath, a.max_dis, a.max_range, a.sample_name)
    elif sub == "generate_seg":
        p = argparse.ArgumentParser()
        p.add_argument("-sv", "--sv_file", dest="svPath", required=True)
        p.add_argument("-bam", "--bam_file", dest="bamPath", default=None)
        p.add_argument("-s", "--sample_name", default="test")
        p.add_argument("-d", "--wgs_depth", type=int, default=30)
        p.add_argument("-p", "--tumor_purity", type=float, default=1.0)
        a = p.parse_args(rest)
        generate_seg(a.svPath, a.bamPath, a.sample_name, a.wgs_depth, a.tumor_purity)
    elif sub == "call_depth":
        p = argparse.ArgumentParser()
        p.add_argument("-seg", "--seg_file", dest="segPath", required=True)
        p.add_argument("-bam", "--bam_file", dest="bamPath", required=True)
        p.add_argument("-s", "--sample_name", default="test")
        a = p.parse_args(rest)
        call_depth(a.segPath, a.bamPath, a.sample_name)
    elif sub == "generate_lh":
        p = argparse.ArgumentParser()
        p.add_argument("-sv", "--sv_file", dest="svPath", required=True)
        p.add_argument("-seg", "--seg_file", dest="segPath", required=True)
        p.add_argument("-c", "--coverage", type=int, default=30)
        p.add_argument("-p", "--tumor_purity", dest="purity", type=float, default=1.0)
        p.add_argument("-d", "--is_depth", default=False)
        p.add_argument("-d1", "--is_seg_depth", default=False)
        p.add_argument("-d2", "--is_sv_depth", default=False)
        p.add_argument("-s", "--sample_name", default="test")
        p.add_argument("-pr", "--property", dest="prop", default="")
        a = p.parse_args(rest)
        generate_lh(
            a.svPath,
            a.segPath,
            a.coverage,
            a.purity,
            _bool(a.is_depth),
            _bool(a.is_seg_depth),
            _bool(a.is_sv_depth),
            a.sample_name,
            a.prop,
        )
    else:
        print("unknown subfunction: %s" % sub, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
