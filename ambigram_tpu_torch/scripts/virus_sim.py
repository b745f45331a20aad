"""Virus-integration simulation drivers — the legacy-pipeline side of
script/simu.py and script/seek.sh.

Three layers:

1. Pure, always-runnable pieces: mutforge variant-file generation
   (`generate_var_file`, simu.py:278-316 semantics incl. the
   `i_start % 3` reverse-insert quirk), mixed host+virus FASTA assembly
   from in-memory sequences (`write_mix_fa`, simu.py:257-271), and
   mean-depth parsing of `samtools coverage` output
   (`parse_mean_depth`, simu.py:152-163).

2. Gated argv builders for the external tools this image does not
   ship: seeksv SV calling (`seeksv_commands`, seek.sh), GC-bias
   correction (`gc_correction_commands`, simu.py:168-187), sim3C Hi-C
   read simulation (`hic_commands`, simu.py:109-116), and mutforge
   itself (`mutforge_command`, simu.py:238).

3. The in-process solve stage: `run_check_solve` replaces the
   reference's LOCALHAP-check -> cbc -> parseILP -> LOCALHAP-solve
   chain (simu.py:189-210) with the engine's own check/solve ops.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

# ----------------------------------------------------------- pure pieces


def write_mix_fa(
    out_dir: str, host_seqs: Dict[str, str], v_chr: str, v_seq: str
) -> str:
    """Host chromosomes + one virus chromosome into mix.fa
    (simu.py mk_fa, :257-271)."""
    path = os.path.join(out_dir, "mix.fa")
    with open(path, "w") as f:
        for chrom, seq in host_seqs.items():
            f.write(">%s\n%s\n" % (chrom, seq))
        f.write(">%s\n%s" % (v_chr, v_seq))
    return path


def _in_region(pos: int, regions: Sequence[Tuple[int, int]]) -> bool:
    return any(a <= pos <= b for a, b in regions)


def generate_var_file(
    host_chrs: Sequence[str],
    v_chr: str,
    v_len: int,
    out_dir: str,
    fa_file: str,
    seed: int = 0,
    inserts_per_chr: int = 2,
) -> str:
    """mutforge variant table: per host chromosome, `inserts_per_chr`
    virus-fragment insertions written for BOTH haplotype rows
    (simu.py generate_var, :278-316). Quirks preserved: the insert is
    reverse-oriented when its virus start is divisible by 3, the copy
    count is uniform in 1..3, and the target window walks forward from
    20 Mb in random 2-10 kb hops."""
    rng = np.random.default_rng(seed)
    var_file = os.path.join(out_dir, "mix.var")
    lines: List[str] = []
    r_start = 20_000_000
    for hc in host_chrs:
        r_start = r_start + int(rng.integers(2000, 10001))
        r_end = int(rng.integers(r_start + 2000, r_start + 10001))
        taken: List[Tuple[int, int]] = []
        for i in range(inserts_per_chr):
            pos = int(rng.integers(r_start, r_end + 1))
            i_start = int(rng.integers(700, v_len - 500 + 1))
            i_end = int(rng.integers(i_start + 800, i_start + 2001))
            while _in_region(i_start, taken) or _in_region(i_end, taken):
                i_start = int(rng.integers(700, v_len - 500 + 1))
                i_end = int(rng.integers(i_start + 800, i_start + 2001))
            times = int(rng.integers(1, 4))
            rev = "r" if i_start % 3 == 0 else "f"
            payload = "%s,%s:%d-%d,%d,%s" % (fa_file, v_chr, i_start, i_end, times, rev)
            for hap in (0, 1):
                lines.append(
                    "VAR_%s_%d_%d\tFINS_%d\t1\t%d\t%s\t%d\tFalse\t0\tTrue\t%s"
                    % (hc, hap, i, i, hap, hc, pos, payload)
                )
    with open(var_file, "w") as f:
        f.write("\n".join(lines) + "\n")
    return var_file


def parse_mean_depth(scov_path: str, n_size: int) -> float:
    """Mean depth over a genome of n_size bases from a
    `samtools coverage` table (simu.py:152-163)."""
    o_bp = 0.0
    for line in open(scov_path):
        if "#" in line:
            continue
        tok = re.split(r"\s+", line.strip())
        o_bp += int(tok[2]) * int(float(tok[6]))
    return o_bp / n_size


# ----------------------------------------------- gated external recipes


def seeksv_commands(prefix: str, bam: str, ref: str) -> List[List[str]]:
    """seeksv SV-calling driver (script/seek.sh): index, clip
    extraction, clip realignment, SV calling. The bwa|samtools pipe is
    split into two commands through an intermediate SAM."""
    return [
        ["samtools", "index", "-@", "8", bam],
        ["seeksv", "getclip", "-o", prefix, bam],
        ["bwa", "mem", "-t", "8", ref, prefix + ".clip.fq.gz", "-o", prefix + ".clip.sam"],
        ["samtools", "view", "-Sb", prefix + ".clip.sam", "-o", prefix + ".clip.bam"],
        [
            "seeksv", "getsv", prefix + ".clip.bam", bam, prefix + ".clip.gz",
            prefix + ".seek.sv.txt", prefix + ".unmapped.clip.fq.gz",
        ],
    ]


def gc_correction_commands(
    input_bam: str, out_prefix: str, ref: str, effective_genome_size: int
) -> List[List[str]]:
    """deeptools GC-bias correction (simu.py gc_correction, :168-187):
    2bit ref, bias frequencies, corrected BAM, index."""
    corrected = out_prefix + ".gc.bam"
    return [
        ["samtools", "index", input_bam, "-@", "8"],
        ["faToTwoBit", ref, ref + ".2bit"],
        [
            "computeGCBias", "-b", input_bam,
            "--effectiveGenomeSize", str(effective_genome_size),
            "-g", ref + ".2bit", "--GCbiasFrequenciesFile", ref + ".freq.txt",
        ],
        [
            "correctGCBias", "-b", input_bam,
            "--effectiveGenomeSize", str(effective_genome_size),
            "-g", ref + ".2bit", "--GCbiasFrequenciesFile", ref + ".freq.txt",
            "-o", corrected,
        ],
        ["samtools", "index", corrected, "-@", "8"],
    ]


def hic_commands(muted_fa: str, total_len: int, out_prefix: str) -> List[List[str]]:
    """sim3C Hi-C read simulation (simu.py g_hic, :109-116):
    15x coverage at 150 bp, NlaIII digestion."""
    nreads = int(15 * total_len / 150)
    return [
        ["samtools", "faidx", muted_fa],
        [
            "sim3C", "--simple-reads", "--dist", "uniform", "-n", str(nreads),
            "-l", "150", "-e", "NlaIII", "-m", "hic", muted_fa,
            out_prefix + ".hic.fq",
        ],
    ]


def mutforge_command(
    var_file: str, mix_fa: str, simple_par: str, out_prefix: str
) -> List[str]:
    """mutforge invocation (simu.py:238)."""
    return [
        "mutforge", "-x", "bam", "-n", "128", "-v", var_file,
        mix_fa, simple_par, mix_fa, "-o", out_prefix, "-b", "0",
    ]


# ------------------------------------------------- in-process solve leg


def run_check_solve(
    lh_path: str,
    out_prefix: str,
    juncdb: str = "",
    tgs_order: str = "",
    hic_matrix: str = "",
) -> Dict[str, str]:
    """The check -> solve leg of the legacy virus pipeline
    (simu.py run_local, :189-210), solved in-process instead of
    LOCALHAP + cbc + parseILP. Returns the output file map."""
    from ambigram_tpu_torch.cli import main

    balanced = out_prefix + ".balanced.lh"
    haps = out_prefix + ".haps"
    circuits = out_prefix + ".circuits"
    traversed = out_prefix + ".traversed"
    args = ["--op", "check", "--in_lh", lh_path, "--lp_prefix", out_prefix,
            "--out_lh", balanced]
    if juncdb:
        args += ["--juncdb", juncdb]
    rc = main(args)
    if rc != 0:
        raise RuntimeError("check op failed for %s" % lh_path)
    args = ["--op", "solve", "--in_lh", balanced, "--hap", haps,
            "--circuits", circuits, "--traversed", traversed]
    if juncdb:
        args += ["--juncdb", juncdb]
    if tgs_order:
        args += ["--tgs_order", tgs_order]
    if hic_matrix:
        args += ["--hic_matrix", hic_matrix]
    rc = main(args)
    if rc != 0:
        raise RuntimeError("solve op failed for %s" % balanced)
    return {
        "balanced": balanced,
        "haps": haps,
        "circuits": circuits,
        "traversed": traversed,
    }


# ----------------------------------------------------------------- CLI


def main(argv: Sequence[str] = None) -> int:
    """Subcommands mirroring the simu.py stages that run without
    external tools: `var` (mutforge variant file), `check_solve` (the
    in-process legacy check -> solve leg)."""
    import argparse

    p = argparse.ArgumentParser(prog="virus_sim")
    sub = p.add_subparsers(dest="cmd", required=True)

    pv = sub.add_parser("var", help="generate a mutforge variant file")
    pv.add_argument("--host_chrs", required=True, help="comma list, e.g. chr7,chr11")
    pv.add_argument("--v_chr", required=True, help="virus chromosome name")
    pv.add_argument("--v_len", type=int, required=True)
    pv.add_argument("--out_dir", default=".")
    pv.add_argument("--fa_file", required=True, help="mixed host+virus fasta")
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--inserts_per_chr", type=int, default=2)

    pc = sub.add_parser("check_solve", help="in-process check -> solve leg")
    pc.add_argument("--in_lh", required=True)
    pc.add_argument("--out_prefix", required=True)
    pc.add_argument("--juncdb", default="")
    pc.add_argument("--tgs_order", default="")
    pc.add_argument("--hic_matrix", default="")

    args = p.parse_args(argv)
    if args.cmd == "var":
        path = generate_var_file(
            args.host_chrs.split(","),
            args.v_chr,
            args.v_len,
            args.out_dir,
            args.fa_file,
            seed=args.seed,
            inserts_per_chr=args.inserts_per_chr,
        )
        print(path)
        return 0
    out = run_check_solve(
        args.in_lh,
        args.out_prefix,
        juncdb=args.juncdb,
        tgs_order=args.tgs_order,
        hic_matrix=args.hic_matrix,
    )
    for k, v in out.items():
        print("%s\t%s" % (k, v))
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
