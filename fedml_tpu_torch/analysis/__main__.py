"""fedlint over the port: ``python -m fedml_tpu_torch.analysis [paths]``.

Runs the five rule checkers over the given paths (default: the
``fedml_tpu_torch`` package) and exits 1 when any finding survives pragma
filtering, 2 on a missing path or an unknown rule, 0 otherwise — the
flags and exit codes of ``tools/fedlint.py``:

    $ python -m fedml_tpu_torch.analysis                 # human output
    $ python -m fedml_tpu_torch.analysis --json          # machine output
    $ python -m fedml_tpu_torch.analysis --rules determinism,lock-discipline
    $ python -m fedml_tpu_torch.analysis --list-rules

Stdlib-only: it runs on a bare interpreter, without torch.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from fedml_tpu_torch import analysis

PACKAGE_DIR = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fedml_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: the fedml_tpu_torch package)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable findings on stdout",
    )
    parser.add_argument(
        "--rules", default=None,
        help="comma-separated subset of rules to run",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule names and exit",
    )
    args = parser.parse_args(argv)
    if args.list_rules:
        for rule in analysis.RULES:
            print(rule)
        return 0

    paths = args.paths or [str(PACKAGE_DIR)]
    for p in paths:
        if not Path(p).exists():
            print(f"fedlint: no such path: {p}", file=sys.stderr)
            return 2
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    files = analysis.load_files(paths)
    try:
        findings = analysis.run_all(files, rules=rules)
    except ValueError as e:
        print(f"fedlint: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        by_rule: dict = {}
        for f in findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        print(json.dumps({
            "files_scanned": len(files),
            "rules": list(rules or analysis.RULES),
            "findings": [f.to_dict() for f in findings],
            "counts": by_rule,
            "ok": not findings,
        }, indent=2))
    else:
        for f in findings:
            print(f.format())
        print(
            f"fedlint: {len(findings)} finding(s) in {len(files)} file(s) "
            f"[{', '.join(rules or analysis.RULES)}]",
            file=sys.stderr,
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
