"""``python -m csat_tpu_torch.cli lint`` — run csat-lint over the port.

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage error.  Human
output is ``path:line: [rule] message`` (clickable); ``--format json``
emits the full report for tooling.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from csat_tpu_torch.analysis.core import all_rules, run_lint
from csat_tpu_torch.analysis.manifests import LINT_TARGETS


def default_root() -> str:
    """The repo checkout containing this package."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="csat_tpu_torch lint",
        description="static analysis of the port against its serving invariants")
    p.add_argument("targets", nargs="*",
                   help=f"files/dirs relative to --root "
                        f"(default: {' '.join(LINT_TARGETS)})")
    p.add_argument("--root", default=default_root(),
                   help="repo root the targets resolve against")
    p.add_argument("--rules", default="",
                   help="comma list of rules to run (default: all)")
    p.add_argument("--format", default="human", choices=["human", "json"])
    p.add_argument("--list-rules", action="store_true",
                   help="print the registered rules and exit")
    args = p.parse_args(argv)

    if args.list_rules:
        for name, r in sorted(all_rules().items()):
            print(f"{name:22s} {r.doc}")
        return 0

    rules = [r for r in args.rules.split(",") if r] or None
    try:
        report = run_lint(args.root, targets=args.targets or None,
                          rules=rules)
    except KeyError as e:
        print(f"csat-lint: {e.args[0]}", file=sys.stderr)
        return 2
    print(report.to_json() if args.format == "json" else report.format())
    return 0 if report.clean else 1


if __name__ == "__main__":
    raise SystemExit(main())
