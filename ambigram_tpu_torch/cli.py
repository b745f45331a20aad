"""Command-line interface of the PyTorch port.

    python -m ambigram_tpu_torch.cli --op bfb --in_lh case.lh [--solver auto] [--device cuda]
    python -m ambigram_tpu_torch.cli --op bfb --manifest --in_lh cases.manifest [--result_store DIR]

The options are the JAX package's (`ambigram_tpu.cli.build_parser`)
plus `--device`, where the search runs (default `cuda`; a CUDA device
without a card is an error, never a silent CPU run). `--op bfb` is
ported, on one case and on a manifest of bulk cases (`run_bfb_many`);
the other ops and single-cell (`sc:`) manifest lines exit non-zero.
"""

from __future__ import annotations

import sys

from ambigram_tpu.cli import _boolish, parse_manifest, build_parser as _reference_parser


def build_parser():
    p = _reference_parser()
    p.prog = "ambigram_tpu_torch"
    p.description = "BFB reconstruction engine, PyTorch/CUDA port"
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device the device search runs on (default: cuda)",
    )
    return p


def run(argv=None):
    """Parse `argv` and run it: the BfbResult (a list of them for a
    manifest), or None after an input error (reported on stderr)."""
    args = build_parser().parse_args(argv)
    try:
        return _dispatch(args)
    finally:
        if args.profile:
            from ambigram_tpu.utils.profiling import GLOBAL

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
