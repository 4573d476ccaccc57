"""distpow-lint CLI — run the port's project-native AST rule engine.

    python -m distpow_tpu_torch.cli.lint [PATHS...] [--json] [--list-rules]
        [--rule ID [--rule ID ...]] [--baseline FILE] [--rewrite-baseline]

The counterpart of the reference's ``scripts/lint.py``, over the port's
``analysis/``.  Defaults to scanning ``distpow_tpu_torch/``, and always
builds the project context (action vocabulary, metrics registry, config
fields) from the port's own ``runtime/`` declarations.  Exit codes: 0
clean (suppressed findings allowed), 1 active findings, 2 usage or
internal error.  Baseline hygiene: an entry that no longer matches any
current finding is itself a ``stale-baseline`` finding (exit 1) —
grandfathered debt must shrink monotonically, never rot.
``--rewrite-baseline`` prunes the stale entries in place instead of
failing.  The port keeps no baseline: its tree is clean.  Imports no
``torch``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distpow_tpu_torch.analysis import PACKAGE_ROOT, build_context, run_analysis
from distpow_tpu_torch.analysis.engine import Finding, load_baseline
from distpow_tpu_torch.analysis.rules import ALL_RULES

STALE_BASELINE = "stale-baseline"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="distpow-lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to scan (default: distpow_tpu_torch/)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--rule", action="append", dest="rules", metavar="ID",
                    help="run only the named rule (repeatable)")
    ap.add_argument("--baseline", metavar="FILE",
                    help="JSON baseline of grandfathered findings")
    ap.add_argument("--rewrite-baseline", action="store_true",
                    help="prune baseline entries that no longer match "
                         "any finding (requires --baseline)")
    args = ap.parse_args(argv)

    if args.rewrite_baseline and not args.baseline:
        print("lint: --rewrite-baseline requires --baseline", file=sys.stderr)
        return 2

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.RULE_ID:24s} {rule.DESCRIPTION}")
        return 0

    paths = args.paths or [PACKAGE_ROOT]
    for p in paths:
        if not os.path.exists(p):
            print(f"lint: no such path: {p}", file=sys.stderr)
            return 2
    known = {r.RULE_ID for r in ALL_RULES}
    if args.rules and not set(args.rules) <= known:
        print(f"lint: unknown rule(s): {sorted(set(args.rules) - known)}",
              file=sys.stderr)
        return 2

    report = run_analysis(paths, context=build_context(PACKAGE_ROOT),
                          rule_ids=args.rules, rel_to=os.getcwd())

    findings = report.findings
    if args.baseline:
        try:
            grandfathered = load_baseline(args.baseline)
        except (OSError, ValueError, KeyError, TypeError) as exc:
            print(f"lint: unreadable baseline {args.baseline}: {exc}",
                  file=sys.stderr)
            return 2
        current = {(f.rule, f.path, f.message) for f in findings}
        findings = [f for f in findings
                    if (f.rule, f.path, f.message) not in grandfathered]
        stale = sorted(grandfathered - current)
        if stale and args.rewrite_baseline:
            with open(args.baseline) as fh:
                data = json.load(fh)
            data["findings"] = [f for f in data.get("findings", ())
                                if (f["rule"], f["path"], f["message"]) in current]
            with open(args.baseline, "w") as fh:
                json.dump(data, fh, indent=2)
                fh.write("\n")
            print(f"lint: pruned {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} from "
                  f"{args.baseline}", file=sys.stderr)
        elif stale:
            findings = findings + [
                Finding(STALE_BASELINE, args.baseline, 0,
                        f"baseline entry [{rule}] {path}: {msg!r} no "
                        f"longer matches any finding — delete it or run "
                        f"--rewrite-baseline (grandfathered debt must "
                        f"shrink, never rot)")
                for rule, path, msg in stale
            ]

    if args.as_json:
        payload = report.to_json()
        payload["findings"] = [f.to_json() for f in findings]
        payload["ok"] = not findings
        print(json.dumps(payload, indent=2))
    else:
        for f in findings:
            print(f.format())
        print(
            f"distpow-lint: {report.checked_files} file(s), "
            f"{len(findings)} finding(s), "
            f"{len(report.suppressed)} suppressed (all justified)",
            file=sys.stderr,
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
