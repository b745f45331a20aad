"""The port's copies of the host-only scripts against their JAX originals.

`ambigram_tpu_torch/scripts/{prep,barcode,legacy_pipeline,juncdb_tool,
support_profile,virus_sim}.py` are line-for-line copies of the JAX
package's, with imports rewritten to the port. Each case below runs one
scenario of tests/test_scripts.py, test_legacy_scripts.py,
test_support_profile.py or test_virus_sim.py twice, once through each
package's modules, on the same inputs and in a fresh working directory
each: the returned values must be equal (objects compared by their
attributes, paths relative to the working directory) and every file
written must be equal byte for byte.

`golden_suite.py` is a copy too, with `--device` in place of the JAX
platform pin: both suites' reports are compared check for check.
"""

import gzip
import importlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("ambigram_tpu", "ambigram_tpu_torch")
COPIED = ("prep", "barcode", "legacy_pipeline", "juncdb_tool", "support_profile", "virus_sim", "golden_suite")


def _norm(value, workdir: str):
    """`value` in a form two packages' results compare equal in: the
    working directory replaced by a marker, objects by their class name
    and attributes, arrays by lists."""
    if isinstance(value, str):
        return value.replace(workdir, "<out>")
    if isinstance(value, (bool, int, float, type(None))):
        return value
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, np.ndarray):
        return ("ndarray", str(value.dtype), value.tolist())
    if isinstance(value, dict):
        return {_norm(k, workdir): _norm(v, workdir) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value).__name__, [_norm(v, workdir) for v in value]
    if isinstance(value, io.StringIO):
        return value.getvalue()
    if hasattr(value, "__dict__") or hasattr(value, "__slots__"):
        attrs = dict(vars(value)) if hasattr(value, "__dict__") else {}
        for name in getattr(type(value), "__slots__", ()):
            attrs[name] = getattr(value, name, None)
        return type(value).__name__, _norm(attrs, workdir)
    raise TypeError("cannot compare %r" % type(value))


def _files(workdir: str) -> dict:
    out = {}
    for root, _dirs, names in os.walk(workdir):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                data = f.read()
            if name.endswith(".gz"):
                data = gzip.decompress(data)  # the gzip header holds a time stamp
            out[os.path.relpath(path, workdir)] = data
    return out


def run_both(scenario, tmp_path, monkeypatch):
    """Run `scenario(m, inp)` through each package (m(name) imports that
    package's script module `name`) in its own working directory, with
    the shared inputs in `inp`; returns the two (value, files) records."""
    inp = tmp_path / "inputs"
    inp.mkdir()
    records = {}
    for pkg in PACKAGES:
        workdir = tmp_path / pkg
        workdir.mkdir()
        monkeypatch.chdir(workdir)

        def m(name, pkg=pkg):
            return importlib.import_module("%s.scripts.%s" % (pkg, name))

        value = scenario(m, str(inp))
        records[pkg] = (_norm(value, str(workdir)), _files(str(workdir)))
    return records


# ---------------------------------------------------------------- prep, barcode


def _prep_seg_and_lh(m, inp):
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

    paths = write_case(simulate_bfb_case(seed=2, n_segments=6, rounds=2), os.path.join(inp, "sim2"))
    prep = m("prep")
    seg_path = prep.generate_seg(paths["sv"], None, sample_name="stub")
    lh_path = prep.generate_lh(paths["sv"], paths["seg"], sample_name="sim2lh")
    return seg_path, lh_path


def _prep_cluster_sv(m, inp):
    sv = (
        "chrom_5p\tbkpos_5p\tstrand_5p\tchrom_3p\tbkpos_3p\tstrand_3p\tavg_cn\n"
        "chr1\t1000\t+\tchr1\t1000\t-\t2\n"
        "chr1\t2000\t-\tchr1\t2000\t+\t1\n"
        "chr9\t500000000\t+\tchr9\t500000001\t+\t1\n"
    )
    path = os.path.join(inp, "sv.txt")
    with open(path, "w") as f:
        f.write(sv)
    return m("prep").cluster_sv(path, sample_name="cl")


def _prep_sniffles2sv(m, inp):
    path = os.path.join(inp, "a.vcf")
    with open(path, "w") as f:
        f.write(
            "##fileformat=VCFv4.2\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
            "chr7\t1000\t1\tN\t<INV>\t.\tPASS\t"
            "PRECISE;CHR2=chr7;END=2000;STRANDS=++;SVTYPE=INV\tGT:DR:DV\t0/1:10:7\n"
        )
    return m("prep").sniffles2sv(path, "sn")


def _prep_om2juncs(m, inp):
    path = os.path.join(inp, "om.txt")
    with open(path, "w") as f:
        f.write("#hdr\n3\tx\n-2\ty\n5\tz\n")
    return m("prep").om2juncs(path, "om")


def _barcode2juncs(m, inp):
    seg = os.path.join(inp, "seg.txt")
    with open(seg, "w") as f:
        f.write("\n".join("chr1:%d-%d\t2" % (i * 1000 + 1, (i + 1) * 1000) for i in range(4)) + "\n")
    bed = os.path.join(inp, "bc.bed")
    with open(bed, "w") as f:
        f.write("\n".join(["chr1\t500\t3000\tBC%d" % k for k in range(6)] + ["chr1\t500\t2000\tBX"]) + "\n")
    return m("barcode").barcode2juncs(seg, bed, "o.juncs")


def _barcode_read(m, inp):
    rng = np.random.default_rng(42)
    segs, pos = [], 100
    for chrom in ("chr1", "chr1", "chr1", "chr2", "chr2"):
        segs.append([chrom, pos, pos + 99, len(segs) + 1])
        pos += 100
    rows = []
    for k in range(300):
        a = int(rng.integers(0, 700))
        rows.append((str(rng.choice(["chr1", "chr2", "1", "chrX"])), a, a + int(rng.integers(1, 400)), "BC%03d" % k))
    bed = os.path.join(inp, "r.bed")
    with open(bed, "w") as f:
        f.write("".join("%s\t%d\t%d\t%s\n" % r for r in rows))
    return m("barcode").read_barcode(bed, segs)


# ---------------------------------------------------------------- juncdb_tool

RAW_SV_HEADER = "\t".join(["c%d" % i for i in range(21)])


def _raw_sv_line(lc, lp, ls, lclip, rc, rp, rs, rclip, lcig="50M", rcig="50M"):
    return "\t".join([lc, str(lp), ls, str(lclip), rc, str(rp), rs, str(rclip)] + ["x"] * 11 + [lcig, rcig])


def _juncdb_cigar(m, inp):
    return [m("juncdb_tool").cigar_match_num(c) for c in ("50M", "10S40M2D8M", "100S")]


def _juncdb_svprofile_pos2id(m, inp):
    raw = os.path.join(inp, "raw.txt")
    with open(raw, "w") as f:
        f.write(
            "\n".join(
                [
                    RAW_SV_HEADER,
                    _raw_sv_line("chr1", 1500, "+", 10, "chr1", 3500, "+", 10),
                    _raw_sv_line("chr1", 1500, "+", 3, "chr1", 3500, "+", 3),
                    _raw_sv_line("chr2", 100, "+", 10, "chr2", 200, "+", 10),
                    _raw_sv_line("chr1", 2500, "-", 10, "chr1", 2500, "+", 10, lcig="5M"),
                ]
            )
            + "\n"
        )
    jt = m("juncdb_tool")
    sv = jt.SVProfile(raw, "s1")
    sv.filter_abnormal("chr1", 0, 10000)
    segdb = jt.SegmentDB("chr1", 0, 9999)
    segdb.update_bps(sv)
    segdb.construct_segs_from_bps()
    sv.set_segdb(segdb)
    sv.pos2id()
    return sv.abnormal_info, sv.abnormal_supports, [(s.start, s.end) for s in segdb.segs]


def _juncdb_svprofile_lh(m, inp):
    raw = os.path.join(inp, "raw.txt")
    with open(raw, "w") as f:
        f.write(RAW_SV_HEADER + "\n" + _raw_sv_line("chr1", 3, "+", 10, "chr1", 6, "+", 10) + "\n")
    depth = os.path.join(inp, "d.txt.gz")
    with gzip.open(depth, "wt") as f:
        for pos in range(1, 11):
            f.write("chr1\t%d\t%d\n" % (pos, 10))
    jt = m("juncdb_tool")
    sv = jt.SVProfile(raw, "s1")
    sv.filter_abnormal("chr1", 0, 100)
    segdb = jt.SegmentDB("chr1", 0, 9)
    segdb.update_bps(sv)
    segdb.construct_segs_from_bps()
    sv.set_segdb(segdb)
    sv.pos2id()
    sv.count_seg_depth(depth)
    sv.set_normal_from_counts([4, 4])
    sv.write_local_hap("o.lh")
    return sv.seg_depth


def _juncdb_create(m, inp):
    nl, a, j1 = (os.path.join(inp, n) for n in ("nl.txt", "a.txt", "j1.txt"))
    for path, text in ((nl, ""), (j1, "1 + 2 + 5\n"), (a, j1 + "\n")):
        with open(path, "w") as f:
            f.write(text)
    return m("juncdb_tool").juncdb_create(nl, a, "db.tsv")


def _juncdb_allele_support(m, inp):
    return m("juncdb_tool").count_allele_support([(100, "ACGT"), (101, "CGTA"), (100, "AGGT")], 101, ("C", "G"))


# ---------------------------------------------------------------- legacy_pipeline


def _legacy_fasta(m, inp):
    fa = os.path.join(inp, "ref.fa")
    with open(fa, "w") as f:
        f.write(">chr1\nACGTACGTAC\n>chr2\nTTTTGGGG\n")
    lp = m("legacy_pipeline")
    seqs = lp.read_fasta(fa)
    ext = lp.extract_bed_sequence(seqs, [("chr1", 0, 4, "+"), ("chr1", 0, 4, "-")])
    lp.bfb2fasta(fa, [("chr2", 0, 4, "+")], "o.fa")
    return seqs, lp.revcomp("ACGT"), lp.revcomp("AAGG"), ext


def _legacy_path_to_bed(m, inp):
    class S:
        def __init__(self, chrom, start, end):
            self.chrom, self.start, self.end = chrom, start, end

    segs = {1: S("chr1", 100, 199), 2: S("chr1", 200, 299)}
    return m("legacy_pipeline").path_to_bed([(1, "+"), (2, "+"), (2, "-"), (1, "-")], segs)


def _legacy_seg2fasta(m, inp):
    fa, seg = os.path.join(inp, "ref.fa"), os.path.join(inp, "seg.txt")
    with open(fa, "w") as f:
        f.write(">chr1\nACGTACGTAC\n")
    with open(seg, "w") as f:
        f.write("chr1:2-6\t2\n")
    return m("legacy_pipeline").seg2fasta(seg, fa, "o.fa")


def _legacy_vcf2sv(m, inp):
    def entry(c1, p1, s1, c2, p2, s2, dp):
        return "\t".join([c1, str(p1), s1, c2, str(p2), s2] + ["x"] * 7 + ["DP:%d " % dp])

    vcf = os.path.join(inp, "v.txt")
    with open(vcf, "w") as f:
        f.write(
            "\n".join(
                [
                    entry("chr1", 100, "+", "chr1", 200, "+", 10),
                    entry("chr1", 150, "+", "chr1", 150, "-", 20),
                    entry("chr1", 300, "+", "chr1", 400, "+", 10),
                    entry("chr2", 10, "+", "chr3", 20, "+", 5),
                    entry("chr1", 900, "+", "chr1", 950, "+", 10),
                ]
            )
            + "\n"
        )
    return m("legacy_pipeline").vcf2sv(vcf, "x")


def _legacy_snif_vcf(m, inp):
    vcf = os.path.join(inp, "s.vcf")
    with open(vcf, "w") as f:
        f.write(
            "#hdr\n"
            "chr7\t1000\tid\tN\tN]chr7:2000]\t.\tPASS\t"
            "PRECISE;SVMETHOD=x;CHR2=chr7;END=2000;STRANDS=++\tGT:DV\t0/1:9\n"
        )
    return m("legacy_pipeline").parse_snif_vcf(vcf, "o.txt")


def _legacy_bpsmap(m, inp):
    lp = m("legacy_pipeline")
    return lp.merge_near_pos([10, 12, 30, 31, 60], 5), lp.map_bps([100, 103, 105, 400, 402])


def _legacy_segmentation_mergedb(m, inp):
    lp = m("legacy_pipeline")
    hdr = "chrom_5p\tpos_5p\tstrand_5p\tchrom_3p\tpos_3p\tstrand_3p\tcount\n"
    db1, db2 = os.path.join(inp, "a.tsv"), os.path.join(inp, "b.tsv")
    with open(db1, "w") as f:
        f.write(hdr + "chr1\t100\t+\tchr1\t200\t+\t2\n")
    with open(db2, "w") as f:
        f.write(hdr + "chr1\t100\t+\tchr1\t200\t+\t3\nchr2\t5\t-\tchr2\t9\t+\t1\n")
    segs = lp.segmentation({"chr1": [100, 200, 300], "chr2": [10, 20]})
    return segs, lp.mergedb([db1, db2], "m.tsv"), lp.HG38_SIZES


def _legacy_get_fasta(m, inp):
    ref = os.path.join(inp, "ref.fa")
    with open(ref, "w") as f:
        f.write(">chr1\nACGTTTTTAC\n")
    return m("legacy_pipeline").get_fasta([("chr1", 0, 4, "+"), ("chr1", 4, 8, "-")], ref, "o.fa")


def _legacy_unmap2ins(m, inp):
    def row(c5, p5, s5, c3, p3, s3, jr):
        return {
            "chrom_5p": c5, "pos_5p": p5, "strand_5p": s5,
            "chrom_3p": c3, "pos_3p": p3, "strand_3p": s3,
            "inner_ins": ".", "span_reads": 0, "junc_reads": jr,
            "id": "x", "qual": 0, "filter": "PASS", "meta_info": "", "anno_info": "",
        }

    rows = [
        row("chr1", 100, "+", "ctgU1", 5, "+", 8),
        row("ctgU1", 90, "+", "chr1", 500, "+", 6),
        row("chr1", 900, "+", "chr1", 1200, "-", 4),
    ]
    return m("legacy_pipeline").unmap2ins(rows, "ctgU", "chr")


def _legacy_update_bed(m, inp):
    sv = [{"chrom_5p": "chr1", "pos_5p": 150, "strand_5p": "+", "chrom_3p": "chr1", "pos_3p": 260, "strand_3p": "-"}]
    bed = [["chr1", 100, 160, "forward", "+"], ["chr1", 250, 300, "reverse", "-"]]
    return m("legacy_pipeline").update_bed(sv, bed)


def _legacy_junc_db_and_config(m, inp):
    lp = m("legacy_pipeline")
    sv = [{
        "chrom_5p": "chr1", "pos_5p": 200, "strand_5p": "+",
        "chrom_3p": "chr1", "pos_3p": 400, "strand_3p": "-",
        "junc_reads": 9, "left_read": 10, "right_read": 14,
    }]
    db = lp.update_junc_db_by_sv(sv, [])
    db = lp.update_junc_db_by_sv(sv, db)
    segs = [(1, "chr1", 100, 200), (2, "chr1", 200, 400), (3, "chrV", 1, 50)]
    db = lp.update_junc_db_by_seg(segs, db, normal_count=lambda c, p: 7)
    path = lp.write_junc_db("db.tsv", db)
    cfg = lp.generate_config(
        "cfg.lh", "s1", sv, segs, avg_depth=lambda c, s, e: 100.0, normal_count=lambda c, p: 7, avg_whole_dp=95.0
    )
    return db, path, cfg


def _legacy_cli(m, inp):
    main = m("legacy_pipeline").main
    ref, bed, db1 = (os.path.join(inp, n) for n in ("ref.fa", "p.bed", "a.tsv"))
    with open(ref, "w") as f:
        f.write(">chr1\nACGTTTTTAC\n")
    with open(bed, "w") as f:
        f.write("chr1 0 4 forward +\nchr1 4 8 reverse -\n")
    with open(db1, "w") as f:
        f.write("chrom_5p\tpos_5p\tstrand_5p\tchrom_3p\tpos_3p\tstrand_3p\tcount\nchr1\t1\t+\tchr1\t2\t+\t1\n")
    return main(["getFasta", "-b", bed, "-r", ref, "-s", "s1"]), main(["mergedb", "-i", "%s,%s" % (db1, db1), "-o", "m.tsv"])


# ---------------------------------------------------------------- support_profile

VCF = """##fileformat=VCFv4.2
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1
chr1\t100\t.\tA\tC\t.\tPASS\t.\tGT\t0/1
chr1\t200\t.\tG\tT\t.\tPASS\t.\tGT\t0|1
chr1\t300\t.\tT\tA\t.\tPASS\t.\tGT\t1/1
chr1\t400\t.\tC\tG\t.\tPASS\t.\tGT\t0/0
chr1\t900\t.\tA\tG\t.\tPASS\t.\tGT\t0/1
chr2\t150\t.\tA\tG\t.\tPASS\t.\tGT\t0/1
"""


def _locus_db(m, inp):
    vcf = os.path.join(inp, "t.vcf")
    with open(vcf, "w") as f:
        f.write(VCF)
    db = m("support_profile").LocusDB("chr1", 1, 500)
    db.read_vcf(vcf)
    return db, vcf


def _seg_db(m):
    jt = m("juncdb_tool")
    db = jt.SegmentDB("chr1", 0, 1000)
    db.segs = [jt.Seg(0, "chr1", 0, 249), jt.Seg(1, "chr1", 250, 1000)]
    return db


def _profile(m, inp, assign=True):
    db, vcf = _locus_db(m, inp)
    segdb = _seg_db(m)
    if assign:
        db.set_seg_ref(segdb)
        db.assign_locus_to_seg()
    sp = m("support_profile").SupportProfile("s1")
    sp.set_loci_ref(db)
    sp.read_genotypes(vcf)
    return db, segdb, sp


def _support_locus_region(m, inp):
    db, _ = _locus_db(m, inp)
    return [loc.pos for loc in db.loci], db.find_loci_in_range(150, 310)


def _support_locus_assign(m, inp):
    db, _segdb, _sp = _profile(m, inp)
    return [loc.seg.id for loc in db.loci], {seg: [loc.id for loc in loci] for seg, loci in db.seg_loci.items()}


def _support_genotypes(m, inp):
    _db, _segdb, sp = _profile(m, inp, assign=False)
    return sp.gt, sp.statistics()


def _support_base_idx(m, inp):
    sp = m("support_profile")
    r = sp.AlnRead("q", 95, sp.parse_cigar("10M"), "ACGTACGTAC")
    r2 = sp.AlnRead("q", 95, sp.parse_cigar("3S4M2D4M"), "NNNACGTACGT")
    return [sp.get_base_idx(r, 99)] + [sp.get_base_idx(r2, p) for p in (96, 100, 102)]


def _pair_table(sp):
    return sp.pair_loci, [[(c.rr, c.ra, c.ar, c.aa) for c in row] for row in sp.pair_counts]


def _support_count_pairs(m, inp):
    db, _segdb, sp = _profile(m, inp)
    mod = m("support_profile")
    seq = ["N"] * 150
    seq[99 - 90] = "A"
    seq[199 - 90] = "T"
    read = mod.AlnRead("r1", 90, mod.parse_cigar("150M"), "".join(seq))
    sp.count_support_reads([[read], [read]])
    sp2 = mod.SupportProfile("s1")
    sp2.set_loci_ref(db)
    sp2.read_genotypes(os.path.join(inp, "t.vcf"))
    bad1 = mod.AlnRead("r2", 90, mod.parse_cigar("150M"), "".join(seq), mapq=5)
    bad2 = mod.AlnRead("r3", 90, mod.parse_cigar("150M"), "".join(seq), flag=0x800)
    sp2.count_support_reads([[bad1, bad2]])
    return _pair_table(sp), _pair_table(sp2)


def _support_roundtrip(m, inp):
    db, _segdb, sp = _profile(m, inp, assign=False)
    sp._add_pair(0, 1, 0, 1)
    sp.write_support("sup.gz")
    sp2 = m("support_profile").SupportProfile("s1")
    sp2.set_loci_ref(db)
    sp2.read_support("sup.gz")
    return _pair_table(sp2)


def _support_haploid_phasing(m, inp):
    _db, segdb, sp = _profile(m, inp)
    for _ in range(3):
        sp._add_pair(0, 1, 0, 1)
        sp._add_pair(1, 0, 1, 0)
    hp = m("support_profile").HaploidProfile("s1")
    hp.set_seg_ref(segdb)
    hp.set_support_profile(sp)
    hap_file = os.path.join(inp, "haps")
    with open(hap_file, "w") as f:
        f.write("1+ 2+ 0+\n1+ 2- 2+ 0+\n")
    hp.read_haploids(hap_file)
    hp.identify_normal()
    out = io.StringIO()
    placements = hp.place_variants(out=out)
    return (
        [s.seg.id for s in hp.hap1],
        hp.seg_normal,
        {seg: [(loc.id, t) for loc, t in hap] for seg, hap in placements.items()},
        out.getvalue(),
    )


def _support_sim_tables(m, inp):
    sp = m("support_profile")
    segs_txt, map_txt = os.path.join(inp, "segs.txt"), os.path.join(inp, "map.txt")
    with open(segs_txt, "w") as f:
        f.write("id chrom start end count\n1 BOR 1 100 0\n2 BOR 101 200 0\n3 BOR 201 300 0\n")
    with open(map_txt, "w") as f:
        f.write("s_start s_end r_start r_end ind\n1 100 1 100 N\n101 200 201 300 I\n201 300 101 200 N\n")
    segs = sp.read_sim_segs(segs_txt)
    seq = sp.get_seg_seq(sp.read_sim_data(map_txt, 3), segs)
    juncs = sp.get_sim_juncs(seq)
    sp.fill_avg_depth(segs, {"BOR": {p: 10 for p in range(1, 301)}})
    lp, rp, lw, rw = sp.junction_windows(juncs[0])
    r1 = sp.AlnRead("q1", lw[0], [(0, lw[1] - lw[0] + 1)], "")
    r2 = sp.AlnRead("q1", rw[0], [(0, rw[1] - rw[0] + 1)], "")
    sp.count_split_support(juncs, [r1], {"q1": [r1, r2]})
    sp.write_sim_lh("sim.lh", segs, juncs, "simcase")
    return (
        [(s.id, s.is_inv, s.depth) for s in segs],
        [s.id for s in seq],
        [(j.left.id, j.right.id, j.support) for j in juncs],
        (lp, rp, lw, rw),
        sp.median_int([1, 2, 100, 4]),
        sp.overlap_len(10, 20, 15, 30),
        sp.overlap_len(10, 20, 25, 30),
    )


def _support_cli(m, inp):
    segs_txt, map_txt = os.path.join(inp, "segs.txt"), os.path.join(inp, "map.txt")
    with open(segs_txt, "w") as f:
        f.write("id chrom start end count\n1 BOR 1 100 0\n2 BOR 101 200 0\n")
    with open(map_txt, "w") as f:
        f.write("h\n1 100 1 100\n101 200 101 200\n")
    argv = ["count_support", "-s", segs_txt, "-j", map_txt, "-t", "dup", "-S", "segs.out", "-J", "juncs.out",
            "--lh_out", "out.lh"]
    return m("support_profile").main(argv)


# ---------------------------------------------------------------- virus_sim


def _virus_var_file(m, inp):
    return m("virus_sim").generate_var_file(["chr5", "chr9"], "hpv16", 7906, ".", "/x/mix.fa", seed=3)


def _virus_mix_and_depth(m, inp):
    vs = m("virus_sim")
    mix = vs.write_mix_fa(".", {"chr1": "ACGT" * 10, "chr2": "GGCC" * 10}, "hpv", "TTTT" * 5)
    scov = os.path.join(inp, "x.scov")
    with open(scov, "w") as f:
        f.write(
            "#rname\tstart\tend\tnumreads\tcovbases\tcoverage\tmeandepth\tq\tm\n"
            "chr1\t1\t1000\t100\t900\t90\t30.0\t30\t30\n"
            "chr2\t1\t500\t50\t400\t80\t10.0\t20\t20\n"
        )
    return mix, vs.parse_mean_depth(scov, 7000)


def _virus_recipes(m, inp):
    vs = m("virus_sim")
    return (
        vs.seeksv_commands("p", "p.bam", "mix.fa"),
        vs.gc_correction_commands("a.bam", "p", "mix.fa", 123),
        vs.hic_commands("m.fa", 150_000, "p"),
        vs.mutforge_command("v.var", "m.fa", "s.par", "p"),
    )


def _virus_check_solve(m, inp):
    from ambigram_tpu_torch.scripts.simulate import legacy_lh_text, simulate_bfb_case

    case = simulate_bfb_case(seed=2, n_segments=12, rounds=3, coverage=40.0, mode="process")
    lh = os.path.join(inp, "v.lh")
    with open(lh, "w") as f:
        f.write(legacy_lh_text(case))
    return m("virus_sim").run_check_solve(lh, "v")


SCENARIOS = {
    "prep_generate_seg_and_lh": _prep_seg_and_lh,
    "prep_cluster_sv": _prep_cluster_sv,
    "prep_sniffles2sv": _prep_sniffles2sv,
    "prep_om2juncs": _prep_om2juncs,
    "barcode2juncs": _barcode2juncs,
    "barcode_read_barcode": _barcode_read,
    "juncdb_cigar_match_num": _juncdb_cigar,
    "juncdb_svprofile_filter_and_pos2id": _juncdb_svprofile_pos2id,
    "juncdb_svprofile_depth_and_lh": _juncdb_svprofile_lh,
    "juncdb_create": _juncdb_create,
    "juncdb_count_allele_support": _juncdb_allele_support,
    "legacy_fasta_roundtrip": _legacy_fasta,
    "legacy_path_to_bed": _legacy_path_to_bed,
    "legacy_seg2fasta": _legacy_seg2fasta,
    "legacy_vcf2sv": _legacy_vcf2sv,
    "legacy_parse_snif_vcf": _legacy_snif_vcf,
    "legacy_bpsmap": _legacy_bpsmap,
    "legacy_segmentation_and_mergedb": _legacy_segmentation_mergedb,
    "legacy_get_fasta": _legacy_get_fasta,
    "legacy_unmap2ins": _legacy_unmap2ins,
    "legacy_update_bed": _legacy_update_bed,
    "legacy_junc_db_and_config": _legacy_junc_db_and_config,
    "legacy_pipeline_cli": _legacy_cli,
    "support_locus_region": _support_locus_region,
    "support_locus_assign": _support_locus_assign,
    "support_genotypes_and_statistics": _support_genotypes,
    "support_get_base_idx": _support_base_idx,
    "support_count_pairs": _support_count_pairs,
    "support_roundtrip": _support_roundtrip,
    "support_haploid_phasing": _support_haploid_phasing,
    "support_sim_tables": _support_sim_tables,
    "support_cli_count_support": _support_cli,
    "virus_generate_var_file": _virus_var_file,
    "virus_mix_fa_and_depth": _virus_mix_and_depth,
    "virus_external_recipes": _virus_recipes,
    "virus_run_check_solve": _virus_check_solve,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_script_copy_matches_jax(name, tmp_path, monkeypatch):
    records = run_both(SCENARIOS[name], tmp_path, monkeypatch)
    assert records["ambigram_tpu_torch"] == records["ambigram_tpu"]


def test_every_copy_is_the_original_with_port_imports():
    """Each copied script is its original line for line, except lines that
    name the package or a path outside the repo, and golden_suite's
    platform pin, replaced by --device."""
    for name in COPIED:
        orig = open(os.path.join(REPO, "ambigram_tpu", "scripts", name + ".py")).read().splitlines()
        copy = open(os.path.join(REPO, "ambigram_tpu_torch", "scripts", name + ".py")).read().splitlines()
        if name == "golden_suite":
            assert "_honor_platform_env" not in "\n".join(copy) and "jax" not in "\n".join(copy)
            continue
        assert len(orig) == len(copy), name
        for a, b in zip(orig, copy):
            if a != b:
                assert "ambigram_tpu." in a or "reference/" in a, (name, a, b)


# ---------------------------------------------------------------- golden_suite


def _comparable(report):
    return [(c["name"], c["ok"], c["detail"]) for c in report["checks"]]


def test_golden_suite_exact_matches_jax(tmp_path):
    """Both suites with the host MILP: the same 16 checks, each with the
    same `ok` and the same `detail`, byte for byte."""
    from ambigram_tpu.scripts import golden_suite as jgs
    from ambigram_tpu_torch.scripts import golden_suite as tgs

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jrep = jgs.run_suite(solver="exact", workdir=str(tmp_path / "j"))
    trep = tgs.run_suite(solver="exact", workdir=str(tmp_path / "t"), device="cpu")
    assert len(trep["checks"]) == 16
    assert _comparable(trep) == _comparable(jrep)
    assert trep["ok"] and jrep["ok"] and trep["device"] == "cpu"


def test_golden_suite_device_search_on_cpu(tmp_path, monkeypatch, capsys):
    """The port's suite through its device search on the CPU (reduced
    budgets), from the command line: every check ok."""
    from ambigram_tpu_torch.scripts import golden_suite as tgs

    for knob, value in (("POP", "8"), ("ROUNDS", "2"), ("SWEEPS", "32")):
        monkeypatch.setenv("AMBIGRAM_SEARCH_" + knob, value)
    monkeypatch.setenv("AMBIGRAM_LNS_BUDGET", "5")
    monkeypatch.chdir(tmp_path)
    assert tgs.main(["--solver", "device", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["solver"] == "device" and len(report["checks"]) == 16


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_golden_suite_on_cuda_without_card_fails(tmp_path):
    """--device cuda (the default) without a card exits non-zero and
    prints no report: the suite never falls back to the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "ambigram_tpu_torch.scripts.golden_suite", "--solver", "exact"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


# ---------------------------------------------------------------- scaling_proxy


@pytest.mark.parametrize("mesh", [1, 2])
def test_scaling_proxy_matches_jax(mesh, tmp_path, monkeypatch):
    """Both packages' `run_proxy` on the same cases (the JAX test's
    recipe, budgets 4/4/1): the same programs, eps_sum and cases solved
    (the port returns JAX's best_x); the port's mesh is that many
    logical shards of one device, here the CPU."""
    from ambigram_tpu.scripts import scaling_proxy as jsp
    from ambigram_tpu_torch.scripts import scaling_proxy as tsp
    from ambigram_tpu_torch.scripts.simulate import simulate_bfb_case, write_case

    monkeypatch.setenv("AMBIGRAM_SHARD_POP", "4")
    monkeypatch.setenv("AMBIGRAM_SHARD_STEPS", "4")
    monkeypatch.setenv("AMBIGRAM_SHARD_ROUNDS", "1")
    for i in range(2):
        case = simulate_bfb_case(seed=500 + i, n_segments=10, rounds=3, mode="process", noise=0.0)
        write_case(case, str(tmp_path / ("sp%d" % i)))
    want = jsp.run_proxy(str(tmp_path), mesh)
    got = tsp.run_proxy(str(tmp_path), mesh, device="cpu")
    keys = ("mesh", "eps_sum", "solved", "n_programs")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["seconds"] > 0 and got["device"] == "cpu"


def test_bench_scaling_proxy_needs_a_card():
    from ambigram_tpu_torch import bench

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU|none is available"):
        bench.bench_scaling_proxy()


# ------------------------------------------------------------------ bench_docs

PORT_LINES = [
    {"metric": "bfb_candidates_scored_per_sec_per_chip", "value": 73528770.6, "unit": "candidates/s",
     "vs_baseline": 2000.0, "kernel_path": "cuda-fused-int8",
     "int8": {"achieved_tops": 650.5, "utilization_pct": 32.9, "peak_int8_tops": 1979.0},
     "device": "NVIDIA H100 80GB HBM3", "card": "NVIDIA H100 80GB HBM3, 700.00 W"},
    {"metric": "suite_seconds_large_cases", "cases": "4xS48 noise=0.05", "n_cases": 4,
     "device": {"seconds": 33.0, "eps_sum": 35.48, "solved": 4}, "auto": {"seconds": 34.0, "eps_sum": 35.48, "solved": 4},
     "exact": {"seconds": 120.0, "eps_sum": 35.48, "solved": 4}},
    {"metric": "batch_throughput_cases_per_min", "cases": "16x mixed S32/S48 noise=0.05", "warmup_seconds": 119.0,
     "batch_device": {"seconds": 118.0, "cases_per_min": 8.14, "solved": 16, "eps_sum": 900.75},
     "serial_exact": {"seconds": 240.0, "cases_per_min": 4.0, "solved": 16, "eps_sum": 950.0}},
    {"metric": "scaling_proxy_overhead", "mesh1": {"mesh": 1, "seconds": 0.03, "compile_plus_first_run_seconds": 1.2,
     "eps_sum": 54.5, "solved": 8, "n_programs": 8, "cases_per_min": 16000.0, "sharding_overhead_pct_vs_mesh1": 0.0},
     "mesh2": {"mesh": 2, "seconds": 0.04, "compile_plus_first_run_seconds": 0.1, "eps_sum": 54.5, "solved": 8,
               "n_programs": 8, "cases_per_min": 12000.0, "sharding_overhead_pct_vs_mesh1": 33.3}},
]


def _bench_output(lines):
    return "noise on stderr\n" + "\n".join(json.dumps(line) for line in lines) + "\nsuite done\n"


def test_bench_docs_extracts_what_the_jax_script_extracts():
    """The port's `extract_metrics` finds the same metric lines as the
    JAX script's, in raw output and in a BENCH_r*.json artifact, and gives every
    metric the card of the result line before it."""
    from ambigram_tpu.scripts import bench_docs as jbd
    from ambigram_tpu_torch.scripts import bench_docs as tbd

    raw = _bench_output(PORT_LINES)
    artifact = json.dumps({"rc": 0, "tail": raw, "parsed": PORT_LINES[0]})
    for text in (raw, artifact):
        got, want = tbd.extract_metrics(text), jbd.extract_metrics(text)
        assert set(got) == set(want) == {line["metric"] for line in PORT_LINES}
        assert {m["card"] for m in got.values()} == {"NVIDIA H100 80GB HBM3, 700.00 W"}
    block = tbd.render_readme_block(tbd.extract_metrics(raw))
    assert block.startswith(tbd.BEGIN) and block.endswith(tbd.END)
    assert "| device | 33.0 | 35.48 | 4/4 |" in block and "| 2 | 0.04 | 0.1 | 12000.0 | 33.3% | 54.5 | 8/8 |" in block
    assert block.count("on NVIDIA H100 80GB HBM3, 700.00 W") == 4
    # a metric line with no card before it is not published
    assert "Suite" not in tbd.render_readme_block(tbd.extract_metrics(_bench_output(PORT_LINES[1:2])))


def test_bench_docs_writes_only_its_own_block(tmp_path):
    """On a copy of README.md, the port's script rewrites only its marker
    block: the JAX package's BENCH block and every other byte stay, docs/
    is not touched, and a rerun on the same input is byte-identical."""
    from ambigram_tpu_torch.scripts import bench_docs as tbd

    readme = tmp_path / "README.md"
    original = open(os.path.join(REPO, "README.md")).read()
    readme.write_text(original)
    out = tmp_path / "bench_out.txt"
    out.write_text(_bench_output(PORT_LINES))
    docs = {name: open(os.path.join(REPO, "docs", name), "rb").read() for name in sorted(os.listdir(os.path.join(REPO, "docs")))}
    assert tbd.main([str(out), "--readme", str(readme)]) == 0
    first = readme.read_text()
    assert first != original
    pattern = re.compile(re.escape(tbd.BEGIN) + r".*?" + re.escape(tbd.END), re.S)
    assert pattern.sub("", first) == pattern.sub("", original)
    jax_block = re.compile(r"<!-- BENCH:BEGIN.*?<!-- BENCH:END -->", re.S)
    assert jax_block.findall(first) == jax_block.findall(original) and len(jax_block.findall(original)) == 1
    assert tbd.main([str(out), "--readme", str(readme)]) == 0
    assert readme.read_text() == first
    assert {name: open(os.path.join(REPO, "docs", name), "rb").read() for name in sorted(os.listdir(os.path.join(REPO, "docs")))} == docs
    # no card, no block; no markers, no write
    out.write_text(_bench_output(PORT_LINES[1:]))
    assert tbd.main([str(out), "--readme", str(readme)]) == 1
    bare = tmp_path / "bare.md"
    bare.write_text("no markers\n")
    out.write_text(_bench_output(PORT_LINES))
    assert tbd.main([str(out), "--readme", str(bare)]) == 1 and bare.read_text() == "no markers\n"
