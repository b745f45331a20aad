"""Legacy localhap pipeline utilities.

Capability ports of the reference's `script/main.py`, `script/bpsmap.py`,
`script/config.py` and `script/e_size.py` (pandas/pysam/pybedtools
pipelines), with pure-Python replacements where the external tool added
nothing (e.g. fasta extraction instead of pybedtools):

- vcf2sv / parse_snif_vcf        main.py:590-708, :742-788
- path2bed                       localhap.cpp:353-381 (bed writer)
- bfb2fasta / seg2fasta          main.py:537-588, :709-741
- merge_near_pos / map_bps       bpsmap.py:214-276
- mergedb                        main.py:361-438 (junction DB merge)
- segmentation / dedup           config.py:46-70
- hg38 chromosome sizes          e_size.py
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

# effective hg38 chromosome sizes used by the simulation drivers
# (reference script/e_size.py)
HG38_SIZES: Dict[str, int] = {
    "chr1": 230481121,
    "chr2": 240548241,
    "chr3": 198100144,
    "chr4": 189752667,
    "chr5": 181265378,
    "chr6": 170078524,
    "chr7": 158970135,
    "chr8": 144768136,
    "chr9": 121790553,
    "chr10": 133263006,
    "chr11": 134533742,
    "chr12": 133137821,
    "chr13": 97983128,
    "chr14": 90568149,
    "chr15": 84641328,
    "chr16": 81805944,
    "chr17": 82920216,
    "chr18": 80089650,
    "chr19": 58440758,
    "chr20": 63944268,
    "chr21": 40088623,
    "chr22": 39159782,
}


# ------------------------------------------------------------------ fasta

_COMP = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def read_fasta(path: str) -> Dict[str, str]:
    seqs: Dict[str, str] = {}
    name = None
    chunks: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs


def extract_bed_sequence(fasta: Dict[str, str], bed_rows: Iterable[Sequence]) -> str:
    """Concatenate (chrom, start, end, strand) rows into one sequence
    (strand-aware; 0-based half-open like bedtools getfasta -s)."""
    out = []
    for row in bed_rows:
        chrom, start, end = row[0], int(row[1]), int(row[2])
        strand = row[3] if len(row) > 3 else "+"
        seq = fasta[chrom][start:end]
        out.append(revcomp(seq) if strand == "-" else seq)
    return "".join(out)


def path_to_bed(path_steps: List[Tuple[int, str]], segments) -> List[Tuple[str, int, int, str]]:
    """BFB path -> bed rows of maximal same-strand runs
    (reference localhap.cpp:353-381, the commented bed writer).
    `segments`: seg_id -> object with .chrom/.start/.end."""
    if not path_steps:
        return []
    rows: List[Tuple[str, int, int, str]] = []
    run_start = 0
    for k in range(1, len(path_steps) + 1):
        if k == len(path_steps) or path_steps[k][1] != path_steps[run_start][1]:
            first = segments[path_steps[run_start][0]]
            last = segments[path_steps[k - 1][0]]
            strand = path_steps[run_start][1]
            if strand == "+":
                rows.append((first.chrom, first.start, last.end, "+"))
            else:
                # on '-' a vertex's "end" is the segment start
                # (src/Vertex.cpp:28-30), so the run spans
                # [last segment's start, first segment's end]
                rows.append((first.chrom, last.start, first.end, "-"))
            run_start = k
    return rows


def bfb2fasta(ref_fasta_path: str, bed_rows: Iterable[Sequence], out_fasta: str, name: str = "BFBPATH") -> None:
    """Path bed -> one concatenated sequence (main.py bfb2fasta without
    the pybedtools dependency)."""
    fasta = read_fasta(ref_fasta_path)
    seq = extract_bed_sequence(fasta, bed_rows)
    with open(out_fasta, "w") as f:
        f.write(">%s\n%s\n" % (name, seq))


def seg2fasta(seg_path: str, ref_fasta_path: str, out_fasta: str) -> None:
    """SEG file -> per-segment fasta (main.py:709-741)."""
    fasta = read_fasta(ref_fasta_path)
    with open(out_fasta, "w") as out:
        for line in open(seg_path).read().splitlines():
            if not line:
                continue
            info = line.split("\t")[0]
            chrom, interval = info.split(":")
            start, end = interval.split("-")
            out.write(
                ">%s:%s-%s(+)\n%s\n"
                % (chrom, start, end, fasta[chrom][int(start) : int(end)])
            )


# ----------------------------------------------------------------- vcf2sv

def vcf2sv(vcf_path: str, output_prefix: str) -> str:
    """longranger-style SV table -> sv.txt, keeping inter-chromosomal /
    inversion entries and their FBI-adjacent neighbors
    (main.py:610-637)."""
    arr = []
    for line in open(vcf_path).read().splitlines():
        if not line:
            continue
        entry = line.split("\t")
        depth = entry[13].split("DP:")[1].split(" ")[0]
        arr.append([entry[0], entry[1], entry[2], entry[3], entry[4], entry[5], depth])
    sv = []

    def is_fbi(e):
        return e[0] == e[3] and e[2] != e[5]

    if len(arr) > 1 and is_fbi(arr[1]):
        sv.append(arr[0])
    for i in range(1, len(arr) - 1):
        if arr[i][0] != arr[i][3] or arr[i][2] != arr[i][5]:
            sv.append(arr[i])
        elif is_fbi(arr[i - 1]) or is_fbi(arr[i + 1]):
            sv.append(arr[i])
    if len(arr) > 1 and is_fbi(arr[-2]):
        sv.append(arr[-1])
    out_path = "%s_sv.txt" % output_prefix
    with open(out_path, "w") as f:
        f.write("chrom_5p\tbkpos_5p\tstrand_5p\tchrom_3p\tbkpos_3p\tstrand_3p\tavg_cn\n")
        for d in sv:
            f.write("\t".join(d) + "\n")
    return out_path


def parse_snif_vcf(vcf_path: str, out_sv: str) -> str:
    """Sniffles VCF -> sv.txt with strand remapping (main.py:742-788)."""
    inv = ("++", "--")
    trans = ("[", "]", "N")
    rows = []
    for line in open(vcf_path).read().splitlines():
        if not line or line[0] == "#":
            continue
        entry = line.split("\t")
        strands = ""
        for item in entry[7].split(";"):
            if item[:8] == "STRANDS=":
                strands = item[-2:]
                break
        if strands in inv or (entry[4][0] in trans and len(entry[4]) > 1) or entry[4] == "<TRA>":
            new_str = {"+-": "++", "++": "+-", "--": "-+", "-+": "--"}.get(strands, strands)
            info = entry[7].split(";")
            chrom_3p = info[2][5:]
            pos_3p = info[3][4:]
            num_v_reads = entry[9].split(":")[-1]
            if chrom_3p and chrom_3p[0] != "c":
                chrom_3p = "chr" + chrom_3p
            chrom_5p = entry[0] if entry[0][0] == "c" else "chr" + entry[0]
            rows.append(
                "%s\t%s\t%s\t%s\t%s\t%s\t%s"
                % (chrom_5p, entry[1], new_str[0], chrom_3p, pos_3p, new_str[1], num_v_reads)
            )
    with open(out_sv, "w") as f:
        f.write("chrom_5p\tbkpos_5p\tstrand_5p\tchrom_3p\tbkpos_3p\tstrand_3p\tavg_cn\n")
        f.write("\n".join(rows) + ("\n" if rows else ""))
    return out_sv


# ----------------------------------------------------------------- bpsmap

def merge_near_pos(poses: Sequence[int], threshold: int) -> List[int]:
    """Collapse positions within `threshold` of the previous kept one
    (bpsmap.py:214-222)."""
    r = [poses[0]]
    for i in range(1, len(poses)):
        if poses[i] - poses[i - 1] > threshold:
            r.append(poses[i])
    return r


def map_bps(bps: Sequence[int], r: int = 20, radius: int = 10) -> List[Tuple[int, int]]:
    """Cluster breakpoints within `radius` and map each to the
    most-central pivot (bpsmap.py:249-268, without sklearn)."""
    bps = sorted(bps)
    clusters: List[List[int]] = []
    cur = [bps[0]]
    for p in bps[1:]:
        if p - cur[-1] <= radius:
            cur.append(p)
        else:
            clusters.append(cur)
            cur = [p]
    clusters.append(cur)
    out: List[Tuple[int, int]] = []
    for cluster in clusters:
        counts = [sum(1 for q in cluster if abs(q - p) < r) for p in cluster]
        pivot = cluster[counts.index(max(counts))]
        for p in cluster:
            out.append((p, pivot))
    return out


def get_breakpoints(pos_5p: Sequence[int], pos_3p: Sequence[int], is_virus: bool = False) -> List[int]:
    """Union of SV breakpoints with +-300 flanks for host chromosomes
    (bpsmap.py:223-229)."""
    svs = sorted(set(pos_5p) | set(pos_3p))
    if not is_virus:
        svs.insert(0, svs[0] - 300)
        svs.append(svs[-1] + 300)
    return svs


# ----------------------------------------------------------------- config

def dedup_sv(rows: List[List]) -> List[List]:
    """Drop duplicate SV rows by (5p, 3p) key (config.py:46-51)."""
    seen = set()
    out = []
    for row in rows:
        key = (row[0], row[1], row[2], row[3], row[4], row[5])
        if key not in seen:
            seen.add(key)
            out.append(row)
    return out


def segmentation(
    breakpoints: Dict[str, List[int]], id_start: int = 1
) -> List[Tuple[int, str, int, int]]:
    """Breakpoints per chromosome -> (id, chrom, start, end) segments
    (config.py:52-70's core)."""
    segs = []
    seg_id = id_start
    for chrom in breakpoints:
        bps = sorted(set(breakpoints[chrom]))
        for a, b in zip(bps[:-1], bps[1:]):
            segs.append((seg_id, chrom, a, b))
            seg_id += 1
    return segs


def mergedb(db_paths: Sequence[str], out_path: str) -> str:
    """Merge junction DB TSVs, summing support of identical records
    (main.py mergedb capability)."""
    agg: Dict[Tuple, int] = {}
    header = "chrom_5p\tpos_5p\tstrand_5p\tchrom_3p\tpos_3p\tstrand_3p\tcount"
    for path in db_paths:
        lines = open(path).read().splitlines()
        for line in lines[1:]:
            if not line:
                continue
            tok = line.split("\t")
            key = tuple(tok[:6])
            agg[key] = agg.get(key, 0) + int(float(tok[6]))
    with open(out_path, "w") as f:
        f.write(header + "\n")
        for key in sorted(agg):
            f.write("\t".join(key) + "\t%d\n" % agg[key])
    return out_path


def get_fasta(bed_rows: Iterable[Sequence], ref_fasta_path: str, out_fasta: str) -> str:
    """BED -> one merged, strand-aware `>BFB` sequence
    (bfb_scripts.py:31-49, replacing the bedtools-getfasta + merge
    two-step with a direct extraction)."""
    fasta = read_fasta(ref_fasta_path)
    seq = extract_bed_sequence(fasta, bed_rows)
    with open(out_fasta, "w") as f:
        f.write(">BFB\n%s\n" % seq)
    return out_fasta


# ------------------------------------------------------------- unmap2ins

_SV_COLS = [
    "chrom_5p",
    "pos_5p",
    "strand_5p",
    "chrom_3p",
    "pos_3p",
    "strand_3p",
    "inner_ins",
    "span_reads",
    "junc_reads",
    "id",
    "qual",
    "filter",
    "meta_info",
    "anno_info",
]


def read_sv_table(path: str) -> List[Dict[str, object]]:
    """14-column headerless SV table -> row dicts (main.py:42-46)."""
    rows: List[Dict[str, object]] = []
    for line in open(path).read().splitlines():
        if not line:
            continue
        tok = line.split("\t")
        row: Dict[str, object] = dict(zip(_SV_COLS, tok + [""] * (len(_SV_COLS) - len(tok))))
        row["pos_5p"] = int(row["pos_5p"])
        row["pos_3p"] = int(row["pos_3p"])
        try:
            row["junc_reads"] = int(row["junc_reads"])
        except (ValueError, TypeError):
            pass
        rows.append(row)
    return rows


def unmap2ins(
    sv_rows: List[Dict[str, object]], unmapped_str: str, ref_str: str
) -> List[Dict[str, object]]:
    """Collapse junction pairs through unmapped contigs into single
    insertion rows (main.py:20-76): each contig whose name contains
    `unmapped_str` is replaced by one SV row connecting its reference
    partners, carrying the contig name in inner_ins and the minimum
    junction support; reference-only rows (both chroms contain
    `ref_str`) pass through."""
    contigs: List[str] = []
    seen = set()
    for r in sv_rows:
        for key in ("chrom_3p", "chrom_5p"):
            c = str(r[key])
            if unmapped_str in c and c not in seen:
                seen.add(c)
                contigs.append(c)
    out: List[Dict[str, object]] = []
    for c in contigs:
        rows = [r for r in sv_rows if r["chrom_5p"] == c or r["chrom_3p"] == c]
        uniq5 = {r["chrom_5p"] for r in rows}
        uniq3 = {r["chrom_3p"] for r in rows}
        new = dict(rows[0])
        if len(uniq5) == 1 or len(uniq3) == 1:
            if len(rows) > 1:
                other = rows[1]
                if len(uniq5) == 1:
                    new["chrom_5p"] = other["chrom_3p"]
                    new["pos_5p"] = other["pos_3p"]
                    new["strand_5p"] = "+" if other["strand_3p"] == "-" else "-"
                else:
                    new["chrom_3p"] = other["chrom_5p"]
                    new["pos_3p"] = other["pos_5p"]
                    new["strand_3p"] = "+" if other["strand_5p"] == "-" else "-"
        else:
            into = next(r for r in rows if r["chrom_3p"] == c)
            outof = next(r for r in rows if r["chrom_5p"] == c)
            new = dict(into)
            new["chrom_3p"] = outof["chrom_3p"]
            new["pos_3p"] = outof["pos_3p"]
            new["strand_3p"] = outof["strand_3p"]
        new["inner_ins"] = c
        new["junc_reads"] = min(r["junc_reads"] for r in rows)
        out.append(new)
    for r in sv_rows:
        if ref_str in str(r["chrom_5p"]) and ref_str in str(r["chrom_3p"]):
            out.append(r)
    return out


def write_sv_table(rows: List[Dict[str, object]], path: str) -> str:
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(str(r[c]) for c in _SV_COLS) + "\n")
    return path


# -------------------------------------------------------------- updateBed

def update_bed(
    sv_rows: List[Dict[str, object]], bed_rows: List[List[object]]
) -> List[List[object]]:
    """Snap BED interval ends to the SV breakpoints that join adjacent
    path rows (main.py:460-535): for each boundary between rows of
    different chrom or orientation, find the SV whose two positions
    fall in the two intervals and overwrite the facing coordinates.
    bed rows: [chrom, start, end, orientation('forward'/'reverse'),
    ..., strand('+'/'-')]."""
    bed = [list(r) for r in bed_rows]
    for i in range(len(bed) - 1):
        a, b = bed[i], bed[i + 1]
        if a[0] == b[0] and a[3] == b[3]:
            continue
        for info in sv_rows:
            chroms = (info["chrom_5p"], info["chrom_3p"])
            if a[0] not in chroms or b[0] not in chroms:
                continue
            p5, p3 = int(info["pos_5p"]), int(info["pos_3p"])
            in_a5 = a[1] <= p5 <= a[2] and b[1] <= p3 <= b[2]
            in_a3 = a[1] <= p3 <= a[2] and b[1] <= p5 <= b[2]
            if not (in_a5 or in_a3):
                continue
            if info["strand_5p"] == a[-1] and info["strand_3p"] == b[-1]:
                pos1, pos2 = p5, p3
            elif info["strand_3p"] == a[-1] and info["strand_5p"] == b[-1]:
                pos1, pos2 = p3, p5
            else:
                continue
            if info["chrom_5p"] != info["chrom_3p"]:
                if a[1] <= p5 <= a[2]:
                    pos1, pos2 = p5, p3
                else:
                    pos1, pos2 = p3, p5
            if a[3] == "forward":
                a[2] = pos1
            else:
                a[1] = pos1
            if b[3] == "forward":
                b[1] = pos2
            else:
                b[2] = pos2
    return bed


# ---------------------------------------------------- junction DB update

def update_junc_db_by_sv(
    sv_rows: List[Dict[str, object]], junc_db: List[Dict[str, object]]
) -> List[Dict[str, object]]:
    """Register each SV junction in the DB: new records enter with
    count 1, existing records gain a count only when junction support
    exceeds 5 reads (config.py:71-120)."""
    for row in sv_rows:
        key_fields = ("chrom_5p", "pos_5p", "strand_5p", "chrom_3p", "pos_3p", "strand_3p")
        hit = None
        for rec in junc_db:
            if all(rec[k] == row[k] for k in key_fields):
                hit = rec
                break
        if hit is None:
            junc_db.append({k: row[k] for k in key_fields} | {"count": 1})
        elif int(row.get("junc_reads", 0)) > 5:
            hit["count"] = int(hit["count"]) + 1
    return junc_db


def update_junc_db_by_seg(
    segs: List[Tuple[int, str, int, int]],
    junc_db: List[Dict[str, object]],
    normal_count,
    ext: int = 5,
) -> List[Dict[str, object]]:
    """Register reference adjacencies whose spanning-read count exceeds
    5 (config.py:134-185). `normal_count(chrom, pos) -> int` abstracts
    the BAM fetch (config.py:123-131)."""
    for seg_id, chrom, start, end in segs[:-1]:
        n = normal_count(chrom, end)
        if n <= 5:
            continue
        hit = None
        for rec in junc_db:
            if (
                rec["chrom_5p"] == chrom
                and rec["pos_5p"] == end
                and rec["strand_5p"] == "+"
                and rec["chrom_3p"] == chrom
                and rec["pos_3p"] == end
                and rec["strand_3p"] == "+"
            ):
                hit = rec
                break
        if hit is None:
            junc_db.append(
                {
                    "chrom_5p": chrom,
                    "pos_5p": end,
                    "strand_5p": "+",
                    "chrom_3p": chrom,
                    "pos_3p": end,
                    "strand_3p": "+",
                    "count": 1,
                }
            )
        else:
            hit["count"] = int(hit["count"]) + 1
    return junc_db


def write_junc_db(path: str, junc_db: List[Dict[str, object]]) -> str:
    """TSV sorted by (chrom_5p, pos_5p, strand_5p, count)
    (config.py:187-188)."""
    cols = ["chrom_5p", "pos_5p", "strand_5p", "chrom_3p", "pos_3p", "strand_3p", "count"]
    rows = sorted(
        junc_db, key=lambda r: (str(r["chrom_5p"]), int(r["pos_5p"]), str(r["strand_5p"]), int(r["count"]))
    )
    with open(path, "w") as f:
        f.write("\t".join(cols) + "\n")
        for r in rows:
            f.write("\t".join(str(r[c]) for c in cols) + "\n")
    return path


def make_normal_counter(bam_path: str, ext: int = 5):  # pragma: no cover
    """pysam-backed spanning-read counter (config.py:123-131)."""
    import pysam  # type: ignore

    bam = pysam.AlignmentFile(bam_path)

    def count(chrom: str, pos: int) -> int:
        n = 0
        for r in bam.fetch(chrom, pos - 1, pos):
            if r.get_overlap(max(0, pos - 1 - ext), pos + ext) == pos + ext - (pos - 1 - ext):
                n += 1
        return n

    return count


# --------------------------------------------------------------- config

def generate_config(
    filename: str,
    samplename: str,
    sv_rows: List[Dict[str, object]],
    segs: List[Tuple[int, str, int, int]],
    avg_depth,
    normal_count,
    avg_whole_dp: float,
    ploidy: int = 2,
) -> str:
    """Emit the legacy multi-chromosome LH config (config.py:197-349):
    per-segment depths, reference adjacencies with >5 spanning reads,
    one JUNC per SV with (left_read+right_read)/2 support, sources and
    sinks at every chromosome switch, AVG_CHR_SEG_DP from the first
    chromosome, VIRUS_START at the last source. `avg_depth(chrom,
    start, end)` and `normal_count(chrom, pos)` abstract the tabix and
    BAM dependencies."""
    total_len: Dict[str, float] = {}
    total_dp: Dict[str, float] = {}
    output_segs: List[str] = []
    sources: List[str] = []
    sinks: List[str] = []
    preseg = None
    for seg_id, chrom, start, end in segs:
        seg_depth = avg_depth(chrom, start, end)
        total_len[chrom] = total_len.get(chrom, 0.0) + (end - start + 1)
        total_dp[chrom] = total_dp.get(chrom, 0.0) + seg_depth * (end - start + 1)
        if preseg is None:
            sources.append(str(seg_id))
        elif chrom != preseg[1]:
            sources.append(str(seg_id))
            sinks.append(str(preseg[0]))
        preseg = (seg_id, chrom)
        output_segs.append("SEG H:%d:%s:%d:%d %s -1" % (seg_id, chrom, start, end, seg_depth))
    sinks.append(str(len(segs)))

    output_juncs: List[str] = []
    juncs_depth: List[float] = []
    left = segs[0]
    for right in segs[1:]:
        if left[1] == right[1]:
            support = normal_count(left[1], left[3])
            if support > 5:
                juncs_depth.append(support)
                output_juncs.append("JUNC H:%d:+ H:%d:+ %s -1 U B" % (left[0], right[0], support))
        left = right

    def find_seg(chrom, pos, at_end):
        for s in segs:
            if s[1] == chrom and (s[3] == pos if at_end else s[2] == pos):
                return s
        return None

    for row in sv_rows:
        s5, s3 = str(row["strand_5p"]), str(row["strand_3p"])
        p5, p3 = int(row["pos_5p"]), int(row["pos_3p"])
        lseg = find_seg(row["chrom_5p"], p5, at_end=(s5 == "+"))
        rseg = find_seg(row["chrom_3p"], p3, at_end=(s3 != s5 if s5 == "+" else s3 == s5))
        if lseg is None or rseg is None:
            continue
        support = (float(row.get("left_read", 0) or 0) + float(row.get("right_read", 0) or 0)) / 2
        juncs_depth.append(support)
        output_juncs.append("JUNC H:%d:%s H:%d:%s %s -1 U B" % (lseg[0], s5, rseg[0], s3, support))

    with open(filename, "w") as fout:
        fout.write("SAMPLE %s\n" % samplename)
        first_chrom = segs[0][1] if segs else ""
        avg_chr = (
            "%s " % (total_dp[first_chrom] / total_len[first_chrom]) if first_chrom else ""
        )
        fout.write("AVG_CHR_SEG_DP %s\n" % avg_chr)
        fout.write("AVG_WHOLE_HOST_DP %s\n" % avg_whole_dp)
        mean_junc = sum(juncs_depth) / len(juncs_depth) if juncs_depth else 0.0
        fout.write("AVG_JUNC_DP %s\n" % mean_junc)
        fout.write("PURITY 1\n")
        fout.write("AVG_TUMOR_PLOIDY %d\n" % ploidy)
        fout.write("PLOIDY %dm1\n" % ploidy)
        fout.write("VIRUS_START %s\n" % sources[-1])
        fout.write("SOURCE %s\n" % ",".join(sources))
        fout.write("SINK %s\n" % ",".join(sinks))
        fout.write("\n".join(output_segs + output_juncs) + "\n")
    return filename


# ------------------------------------------------------------------- CLI

def main(argv=None) -> int:
    """Subcommand dispatcher mirroring the reference's `script/main.py`
    surface for the capabilities ported above."""
    import argparse

    parser = argparse.ArgumentParser(prog="legacy_pipeline")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("vcf2sv")
    p.add_argument("-v", "--vcf", required=True)
    p.add_argument("-o", "--output_prefix", required=True)

    p = sub.add_parser("parse_snif_vcf")
    p.add_argument("-v", "--vcf", required=True)
    p.add_argument("-o", "--out_sv", required=True)

    p = sub.add_parser("mergedb")
    p.add_argument("-i", "--in_dbs", required=True, help="comma-separated junction DB TSVs")
    p.add_argument("-o", "--out_db", required=True)

    p = sub.add_parser("bfb2fasta")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-b", "--bed_file", required=True)
    p.add_argument("-o", "--out_fasta", required=True)

    p = sub.add_parser("seg2fasta")
    p.add_argument("-s", "--seg_file", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-o", "--out_fasta", required=True)

    p = sub.add_parser("getFasta")
    p.add_argument("-b", "--bed_file", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-s", "--sample_name", default="test")

    p = sub.add_parser("unmap2ins")
    p.add_argument("-f", "--sv_file", required=True)
    p.add_argument("-u", "--unmapped_common_string", required=True)
    p.add_argument("-r", "--ref_common_string", required=True)
    p.add_argument("-o", "--out_sv", required=True)

    p = sub.add_parser("updateBed")
    p.add_argument("-i", "--in_sv", required=True)
    p.add_argument("-b", "--bed_file", required=True)

    args = parser.parse_args(argv)
    if args.cmd == "vcf2sv":
        vcf2sv(args.vcf, args.output_prefix)
    elif args.cmd == "parse_snif_vcf":
        parse_snif_vcf(args.vcf, args.out_sv)
    elif args.cmd == "mergedb":
        mergedb(args.in_dbs.split(","), args.out_db)
    elif args.cmd == "bfb2fasta":
        bed_rows = [
            (r.split()[0], int(r.split()[1]), int(r.split()[2]), r.split()[-1][0])
            for r in open(args.bed_file).read().splitlines()
            if r.strip()
        ]
        bfb2fasta(args.reference, bed_rows, args.out_fasta)
    elif args.cmd == "seg2fasta":
        seg2fasta(args.seg_file, args.reference, args.out_fasta)
    elif args.cmd == "getFasta":
        bed_rows = [
            (r.split()[0], int(r.split()[1]), int(r.split()[2]), r.split()[-1][0])
            for r in open(args.bed_file).read().splitlines()
            if r.strip()
        ]
        get_fasta(bed_rows, args.reference, "%s.fa" % args.sample_name)
    elif args.cmd == "unmap2ins":
        rows = read_sv_table(args.sv_file)
        write_sv_table(
            unmap2ins(rows, args.unmapped_common_string, args.ref_common_string),
            args.out_sv,
        )
    elif args.cmd == "updateBed":
        sv_rows = []
        for line in open(args.in_sv).read().splitlines():
            if line.startswith("chrom_5p") or not line.strip():
                continue
            t = line.split("\t")
            sv_rows.append(
                {
                    "chrom_5p": t[0],
                    "pos_5p": int(t[1]),
                    "strand_5p": t[2],
                    "chrom_3p": t[3],
                    "pos_3p": int(t[4]),
                    "strand_3p": t[5],
                }
            )
        bed = []
        for line in open(args.bed_file).read().splitlines():
            if not line.strip():
                continue
            arr = line.split(" ")
            bed.append([arr[0], int(arr[1]), int(arr[2])] + arr[3:-1] + [arr[-1][0]])
        new_bed = update_bed(sv_rows, bed)
        # in-place rewrite like the reference (main.py:529-535)
        with open(args.bed_file, "w") as f:
            for info in new_bed:
                f.write(" ".join(str(e) for e in info) + " \n")
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
