"""Command-line interface of the PyTorch port.

    python -m ambigram_tpu_torch.cli --op bfb --in_lh case.lh [--solver auto] [--device cuda]
    python -m ambigram_tpu_torch.cli --op bfb --manifest --in_lh cases.manifest [--result_store DIR]

The options are the JAX package's (`build_parser`, `_boolish` and
`parse_manifest` are copies of those in ambigram_tpu/cli.py) plus
`--device`, where the search runs (default `cuda`; a CUDA device
without a card is an error, never a silent CPU run). `--op bfb` is
ported, on one case and on a manifest of bulk cases (`run_bfb_many`);
the other ops and single-cell (`sc:`) manifest lines exit non-zero.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ambigram_tpu_torch", description="BFB reconstruction engine, PyTorch/CUDA port"
    )
    p.add_argument(
        "--op",
        required=True,
        choices=["bfb", "sc_bfb", "check", "solve"],
        help="Operate: bfb / sc_bfb (BFB engine); check / solve "
        "(legacy balancer + traversal pipeline, reference "
        "localhap.cpp:24-30)",
    )
    p.add_argument(
        "--in_lh",
        required=True,
        help="Input .lh file (comma list for sc_bfb), or a case MANIFEST "
        "(see --manifest) driving the batched device pipeline over many "
        "cases at once",
    )
    p.add_argument(
        "--manifest",
        action="store_true",
        help="Treat --in_lh as a case manifest: one case per line, "
        "whitespace-separated columns. Bulk line: <lh> [juncs=<path>]. "
        "Single-cell line: sc:<a.lh,b.lh,...> [edges=<parent:child,...>]. "
        "Blank lines and # comments are skipped; relative paths resolve "
        "against the manifest's directory. All bulk cases are solved in "
        "ONE device-sharded batch (run_bfb_many) and all sc samples in "
        "another (run_sc_bfb_many) — the TPU-shaped replacement for "
        "looping the reference binary per sample (localhap.cpp:111-265). "
        "Files named *.manifest are detected automatically.",
    )
    p.add_argument(
        "--result_store",
        default="",
        help="Directory of per-case result checkpoints (manifest mode): "
        "completed cases are skipped on rerun, keyed by input content hash",
    )
    p.add_argument("--lp_prefix", default="sample", help="ILP output file prefix")
    p.add_argument(
        "--juncdb",
        default="",
        help="Input .juncs file with linkage information from linked/long reads",
    )
    p.add_argument(
        "--junc_info",
        default="false",
        help="Whether to use linked/long reads information in ILP (true/false)",
    )
    p.add_argument(
        "--reversed",
        dest="is_reversed",
        default="false",
        help="Find BFB paths starting from the negative strand (true/false)",
    )
    p.add_argument(
        "--all",
        dest="print_all",
        default="false",
        help="Print all possible BFB paths (true/false)",
    )
    p.add_argument(
        "--edges",
        default="",
        help="Sub-clone evolution edges for sc_bfb, e.g. a.lh:b.lh,a.lh:c.lh "
        "or 1:2,1:3 (reference grammar, localhap.cpp:417-430; default: "
        "all-pairs)",
    )
    p.add_argument(
        "--solver",
        default="auto",
        choices=["exact", "device", "auto", "native"],
        help="ILP solver backend (default: auto — in-process exact MILP "
        "for small programs, batched device search + LNS for large)",
    )
    p.add_argument(
        "--no-ledgers",
        action="store_true",
        help="Skip appending simulation_sv.txt / time.csv",
    )
    p.add_argument(
        "--emit_lp",
        action="store_true",
        help="Write <lp_prefix>.lp and <lp_prefix>.mps for each solved "
        "fitting program (the reference's debug/interchange artifact, "
        "LGM.cpp:4749-4750; opt-in here since no external solver runs)",
    )
    p.add_argument(
        "--profile",
        action="store_true",
        help="Print the phase-timer/counter report after the run",
    )
    # legacy check/solve options (reference localhap.cpp:24-30)
    p.add_argument("--out_lh", default="", help="Balanced LH output (op check)")
    p.add_argument(
        "--hap",
        default="",
        help="Haplotype out file (op solve); defaults to "
        "<lp_prefix>.haploids.txt",
    )
    p.add_argument("--traversed", default="", help="Traversed path out file (op solve)")
    p.add_argument("--circuits", default="", help="Circuits out file (op solve)")
    p.add_argument("--hic_matrix", default="", help="Segment Hi-C matrix file (op solve)")
    p.add_argument("--tgs_order", default="", help="Long-fragment local order file (op solve)")
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device the device search runs on (default: cuda)",
    )
    return p


def _boolish(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def parse_manifest(path: str):
    """Parse a case manifest into (bulk, sc) work lists.

    bulk: [{"lh": ..., "juncs": ...}]; sc: [{"lh_paths": ..., "edges": ...}].
    Grammar per --manifest's help text. Raises ValueError with the line
    number on malformed lines — a silently skipped case is a missing
    result a user would misread as "no BFB found"."""
    import os

    base = os.path.dirname(os.path.abspath(path))

    def resolve(p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(base, p)

    bulk, sc = [], []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.split()
            head, opts = cols[0], cols[1:]
            kv = {}
            for o in opts:
                if "=" not in o:
                    raise ValueError(
                        "%s:%d: expected key=value column, got %r"
                        % (path, lineno, o)
                    )
                k, v = o.split("=", 1)
                kv[k] = v
            if head.startswith("sc:"):
                clones = ",".join(
                    resolve(c) for c in head[3:].split(",") if c
                )
                if not clones:
                    raise ValueError(
                        "%s:%d: sc: line names no clone files" % (path, lineno)
                    )
                unknown = set(kv) - {"edges"}
                if unknown:
                    raise ValueError(
                        "%s:%d: unknown sc options %s" % (path, lineno, sorted(unknown))
                    )
                sc.append({"lh_paths": clones, "edges": kv.get("edges", "")})
            else:
                unknown = set(kv) - {"juncs"}
                if unknown:
                    raise ValueError(
                        "%s:%d: unknown options %s" % (path, lineno, sorted(unknown))
                    )
                bulk.append(
                    {
                        "lh": resolve(head),
                        "juncs": resolve(kv["juncs"]) if kv.get("juncs") else "",
                    }
                )
    return bulk, sc


def run(argv=None):
    """Parse `argv` and run it: the BfbResult (a list of them for a
    manifest), or None after an input error (reported on stderr)."""
    args = build_parser().parse_args(argv)
    try:
        return _dispatch(args)
    finally:
        if args.profile:
            from ambigram_tpu_torch.utils.profiling import GLOBAL

            print(GLOBAL.report(), file=sys.stderr)


def _run_manifest(args):
    """Every bulk case of the manifest through `run_bfb_many`, with
    per-case checkpoints in --result_store; a `## <lh>: ...` summary
    line per case on stderr, as the JAX package's CLI prints."""
    from ambigram_tpu_torch.engine.pipeline import run_bfb_many

    bulk, sc = parse_manifest(args.in_lh)
    if sc:
        print(
            "error: single-cell (sc:) manifest lines are not yet ported to ambigram_tpu_torch",
            file=sys.stderr,
        )
        return None
    if not bulk:
        print("error: manifest %s lists no cases" % args.in_lh, file=sys.stderr)
        return None
    results = run_bfb_many(
        [c["lh"] for c in bulk],
        juncs_paths=[c["juncs"] for c in bulk],
        juncs_info=_boolish(args.junc_info),
        is_reversed=_boolish(args.is_reversed),
        solver=args.solver,
        device=args.device,
        out=sys.stdout,
        result_store=args.result_store or None,
        ledger_dir=None if args.no_ledgers else ".",
    )
    for c, r in zip(bulk, results):
        print(
            "## %s: %d path(s), ilp_error %.4f%s"
            % (
                c["lh"],
                sum(1 for p in r.path_strings if p),
                r.ilp_error,
                "" if r.is_resolved else " [unresolved]",
            ),
            file=sys.stderr,
        )
    print("## manifest complete: %d case(s)" % len(results), file=sys.stderr)
    return results


def _dispatch(args):
    if args.manifest or args.in_lh.endswith(".manifest"):
        if args.op != "bfb":
            print("error: --manifest runs --op bfb (got --op %s)" % args.op, file=sys.stderr)
            return None
        # flags that would do nothing in manifest mode are an input error:
        # juncs belong in the manifest's per-case columns
        ignored = [
            name
            for name, val in (
                ("--juncdb", args.juncdb),
                ("--edges", args.edges),
                ("--all", _boolish(args.print_all)),
                ("--emit_lp", args.emit_lp),
            )
            if val
        ]
        if ignored:
            print(
                "error: %s not supported in manifest mode; put juncs= columns on the "
                "manifest lines instead" % ", ".join(ignored),
                file=sys.stderr,
            )
            return None
        return _run_manifest(args)
    if args.op != "bfb":
        print("error: --op %s is not yet ported to ambigram_tpu_torch" % args.op, file=sys.stderr)
        return None
    if args.edges:
        print(
            "error: --edges is only meaningful with --op sc_bfb (got --op %s)" % args.op,
            file=sys.stderr,
        )
        return None
    from ambigram_tpu_torch.engine.pipeline import run_bfb

    return run_bfb(
        args.in_lh,
        juncs_path=args.juncdb,
        juncs_info=_boolish(args.junc_info),
        is_reversed=_boolish(args.is_reversed),
        print_all=_boolish(args.print_all),
        solver=args.solver,
        device=args.device,
        out=sys.stdout,
        ledger_dir=None if args.no_ledgers else ".",
        lp_prefix=args.lp_prefix,
        emit_lp=args.emit_lp,
    )


def main(argv=None) -> int:
    return 0 if run(argv) is not None else 2


if __name__ == "__main__":
    sys.exit(main())
