"""Trace-log validator entry point (no reference equivalent — the
reference's trace invariants were inspected by hand/ShiViz; SURVEY.md
section 4 makes them this framework's executable acceptance test).

    python -m distpow_tpu_torch.cli.trace_check trace_output.log [shiviz_output.log]

Exits 0 when every ordering invariant holds, 1 otherwise (violations are
printed one per line).

The port's own copy of the reference's ``cli/trace_check.py``
(``distpow_tpu/cli/trace_check.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import sys

from ..runtime.trace_check import check_shiviz_log, check_trace_log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="validate distpow trace logs")
    ap.add_argument("trace_log", help="human trace log (trace_output.log)")
    ap.add_argument("shiviz_log", nargs="?",
                    help="optional ShiViz vector-clock log")
    args = ap.parse_args(argv)

    violations = check_trace_log(args.trace_log)
    if args.shiviz_log:
        violations += check_shiviz_log(args.shiviz_log)
    for v in violations:
        print(f"VIOLATION: {v}")
    print(f"{len(violations)} violation(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
