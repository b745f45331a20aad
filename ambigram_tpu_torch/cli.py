"""Command-line interface of the PyTorch port.

    python -m ambigram_tpu_torch.cli --op bfb --in_lh case.lh [--solver auto] [--device cuda]

The options are the JAX package's (`ambigram_tpu.cli.build_parser`)
plus `--device`, where the search runs (default `cuda`; a CUDA device
without a card is an error, never a silent CPU run). Only `--op bfb` on
one case is ported; the other ops and `--manifest` exit non-zero.
"""

from __future__ import annotations

import sys

from ambigram_tpu.cli import _boolish, build_parser as _reference_parser


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
    """Parse `argv` and run it: the BfbResult, or None after an input
    error (reported on stderr)."""
    args = build_parser().parse_args(argv)
    try:
        return _dispatch(args)
    finally:
        if args.profile:
            from ambigram_tpu.utils.profiling import GLOBAL

            print(GLOBAL.report(), file=sys.stderr)


def _dispatch(args):
    if args.manifest or args.in_lh.endswith(".manifest"):
        print("error: --manifest is not yet ported to ambigram_tpu_torch", file=sys.stderr)
        return None
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
