"""``python -m repro_torch.analysis`` — the port's reprolint CLI.

  python -m repro_torch.analysis src/repro_torch chip_smoke.py     lint, human output
  python -m repro_torch.analysis --check src/repro_torch ...       exit 1 on non-baselined
  python -m repro_torch.analysis --json src/repro_torch ...        machine-readable report
  python -m repro_torch.analysis --write-baseline src/repro_torch  accept current findings
  python -m repro_torch.analysis --list-rules                      rule catalogue
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.linter import apply_baseline, lint_paths, load_baseline, write_baseline
from repro_torch.analysis.report import render_json, render_rule_list, render_terminal

DEFAULT_BASELINE = "reprolint_torch_baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint for the PyTorch port: executor and timing discipline")
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on any non-baselined finding or stale entry")
    ap.add_argument("--json", action="store_true", help="JSON report on stdout")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"baseline file of accepted findings (default: {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file entirely")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write all current findings to the baseline and exit 0")
    ap.add_argument("--rules", default=None, help="comma-separated subset of rule ids to run")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        render_rule_list(sys.stdout)
        return 0
    if not args.paths:
        ap.error("no paths given (try: python -m repro_torch.analysis src/repro_torch)")

    only = [r.strip() for r in args.rules.split(",")] if args.rules else None
    findings = lint_paths(args.paths, only=only)

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    new, stale = apply_baseline(findings, baseline)
    (render_json if args.json else render_terminal)(new, stale, sys.stdout)
    if new:
        return 1
    if args.check and stale:
        return 1  # a fixed finding must leave the baseline
    return 0


if __name__ == "__main__":
    sys.exit(main())
