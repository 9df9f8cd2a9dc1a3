"""CLI of the port's static checker: ``python -m repro_torch.analysis``.

Exit code 0 if and only if there are no findings.
"""
from __future__ import annotations

import argparse
import sys

from .report import Report

_EPILOG = """\
examples:
  # both passes; nonzero exit on any finding
  PYTHONPATH=src python -m repro_torch.analysis --all --json analysis.json

  # the lints alone, on given files
  PYTHONPATH=src python -m repro_torch.analysis --lints --paths src/repro_torch/serve

  # the kernel contracts with a recorded -Xptxas -v log (registers, spills)
  PYTHONPATH=src python -m repro_torch.analysis --contracts \\
      --ptxas-log tests/torch_analysis_fixtures/ptxas_h100.log

suppressing a deliberate lint hit (say why):
  cur = tok.cpu().numpy()  # repro: noqa-RPA001 -- the host streams token ids
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static checker: PyTorch/CUDA AST lints (RPA0xx) and the "
                    "Hopper kernel contract checker (KCV0xx).",
        epilog=_EPILOG, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--all", action="store_true",
                    help="run both passes (the default when none is selected)")
    ap.add_argument("--lints", action="store_true", help="the AST lint pass")
    ap.add_argument("--contracts", action="store_true", help="the kernel contract checker")
    ap.add_argument("--ptxas-log", default=None, metavar="FILE",
                    help="-Xptxas -v output of the kernel build, for the contracts' register, "
                         "spill and static shared memory checks")
    ap.add_argument("--root", default=".", help="repo root for the lint pass (default: cwd)")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="lint only these files/dirs instead of the default sweep")
    ap.add_argument("--json", dest="json_out", default=None, metavar="FILE",
                    help="write the merged JSON report")
    ap.add_argument("--quiet", action="store_true",
                    help="no human rendering; exit code only")
    args = ap.parse_args(argv)

    want_all = args.all or not (args.lints or args.contracts)
    rep = Report()
    if want_all or args.lints:
        from . import lints

        rep.extend(lints.run(args.root, paths=args.paths))
    if want_all or args.contracts:
        from . import kernel_contracts

        log = None
        if args.ptxas_log:
            with open(args.ptxas_log, encoding="utf-8") as fh:
                log = fh.read()
        rep.extend(kernel_contracts.run(ptxas_log=log))
    if args.json_out:
        rep.write_json(args.json_out)
    if not args.quiet:
        print(rep.render())
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
