"""``python -m repro_torch.analysis.lint`` — the port's detlint CLI
(the reference's driver, with its flags and exit codes).

    python -m repro_torch.analysis.lint src/repro_torch chip_smoke.py

Exit codes: 0 clean (after pragmas + baseline), 1 new findings or file
errors, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.lint.engine import (
    LintConfig,
    apply_baseline,
    load_baseline,
    render_console,
    render_json,
    run_lint,
    write_baseline,
)
from repro_torch.analysis.lint.rules import rule_catalog


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="detlint",
        description="Determinism static analysis for the repro_torch port: "
                    "Python and CUDA sources (rule catalog: --list-rules)",
    )
    p.add_argument("paths", nargs="*", help="files or directories to lint")
    p.add_argument("--rules", help="comma-separated rule codes to run "
                                   "(default: all)")
    p.add_argument("--baseline", help="baseline JSON; findings in it are "
                                      "suppressed, new ones fail")
    p.add_argument("--relax", action="append", default=[],
                   metavar="PREFIX:RULES",
                   help="drop RULES (comma list, or *) for files under "
                        "PREFIX, e.g. 'tests/:DET001' — a per-directory "
                        "posture, repeatable")
    p.add_argument("--write-baseline", metavar="PATH",
                   help="write current findings as the new baseline and "
                        "exit 0")
    p.add_argument("--json", dest="json_out", metavar="PATH",
                   help="also write the machine-readable report ( '-' for "
                        "stdout)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for code, desc in sorted(rule_catalog().items()):
            print(f"{code}  {desc}")
        return 0
    if not args.paths:
        print("detlint: no paths given (try: src/repro_torch chip_smoke.py)",
              file=sys.stderr)
        return 2

    select = None
    if args.rules:
        select = tuple(c.strip().upper() for c in args.rules.split(",")
                       if c.strip())
        unknown = set(select) - set(rule_catalog())
        if unknown:
            print(f"detlint: unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    relax = []
    for spec in args.relax:
        prefix, sep, codes_s = spec.partition(":")
        codes = tuple(c.strip().upper() for c in codes_s.split(",")
                      if c.strip())
        if not sep or not prefix or not codes:
            print(f"detlint: --relax wants PREFIX:RULES, got '{spec}'",
                  file=sys.stderr)
            return 2
        unknown = set(codes) - set(rule_catalog()) - {"*"}
        if unknown:
            print(f"detlint: unknown rule(s) in --relax: "
                  f"{', '.join(sorted(unknown))}", file=sys.stderr)
            return 2
        relax.append((prefix, codes))

    findings, errors = run_lint(
        args.paths, LintConfig(select=select, relax=tuple(relax)))

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"detlint: wrote baseline with {len(findings)} finding(s) "
              f"to {args.write_baseline}")
        return 0

    baseline = load_baseline(args.baseline)
    new, suppressed = apply_baseline(findings, baseline)

    if args.json_out:
        report = json.dumps(render_json(new, suppressed, errors), indent=2)
        if args.json_out == "-":
            print(report)
        else:
            with open(args.json_out, "w") as f:
                f.write(report + "\n")
    print(render_console(new, suppressed, errors))
    return 1 if (new or errors) else 0


if __name__ == "__main__":
    sys.exit(main())
