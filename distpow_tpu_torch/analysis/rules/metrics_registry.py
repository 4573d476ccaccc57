"""metrics-registry — every counter AND histogram name must be declared.

``Metrics.inc``/``Metrics.observe`` create series on first touch, so a
typo'd name (``coord.fanout`` for ``coord.fanouts``; ``worker.solve``
for ``worker.solve_s``) silently splits a series into two and every
dashboard/asserting test reading the real name sees frozen zeros —
exactly the hand-transcribed-counts drift class.
The registry is declared in ``runtime/metrics.py``:

* ``KNOWN_COUNTERS`` / ``KNOWN_COUNTER_PREFIXES`` gate
  ``metrics.inc(...)`` / ``REGISTRY.inc(...)`` call sites;
* ``KNOWN_HISTOGRAMS`` / ``KNOWN_HISTOGRAM_PREFIXES`` gate
  ``metrics.observe(...)`` and ``metrics.time(...)`` call sites (the
  latency telemetry plane);
* ``KNOWN_GAUGES`` / ``KNOWN_GAUGE_PREFIXES`` gate
  ``metrics.gauge(...)`` call sites (the resource sentinels —
  a typo'd gauge name is a leak detector watching nothing).

Resolution, per call site:

* a string literal must be in the exact-name set;
* an f-string's leading literal text must match a declared prefix;
* a bare name is resolved through same-module string constants
  (``REGISTRY.inc(ERRORS_TOTAL)``); anything still dynamic is skipped
  (documented limitation — the registry cannot be checked through
  arbitrary dataflow).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Tuple

from ._util import is_module, receiver_name, resolve_str_constant

RULE_ID = "metrics-registry"
DESCRIPTION = (
    "metrics.inc()/observe()/time()/gauge() series names must be declared "
    "in runtime/metrics.py KNOWN_COUNTERS / KNOWN_HISTOGRAMS / "
    "KNOWN_GAUGES (+ prefixes)"
)

RECEIVERS = frozenset({"metrics", "REGISTRY"})
COUNTER_METHODS = frozenset({"inc"})
HISTOGRAM_METHODS = frozenset({"observe", "time"})
GAUGE_METHODS = frozenset({"gauge"})


def _series_arg(call: ast.Call) -> Optional[Tuple[str, ast.AST]]:
    """(family, name-arg) for a registry call site, else None.
    ``family`` is "counter" or "histogram"."""
    if not (isinstance(call.func, ast.Attribute)
            and receiver_name(call.func) in RECEIVERS and call.args):
        return None
    if call.func.attr in COUNTER_METHODS:
        return "counter", call.args[0]
    if call.func.attr in HISTOGRAM_METHODS:
        return "histogram", call.args[0]
    if call.func.attr in GAUGE_METHODS:
        return "gauge", call.args[0]
    return None


def check(module, context) -> Iterator:
    if not context.counters and not context.histograms:
        return  # registry not parsed (fixture tree without metrics.py)
    if is_module(module.path, "runtime/metrics.py"):
        return
    declared = {
        "counter": (context.counters, context.counter_prefixes,
                    "KNOWN_COUNTERS", "KNOWN_COUNTER_PREFIXES"),
        "histogram": (context.histograms, context.histogram_prefixes,
                      "KNOWN_HISTOGRAMS", "KNOWN_HISTOGRAM_PREFIXES"),
        "gauge": (context.gauges, context.gauge_prefixes,
                  "KNOWN_GAUGES", "KNOWN_GAUGE_PREFIXES"),
    }
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        hit = _series_arg(node)
        if hit is None:
            continue
        family, arg = hit
        names, prefixes, names_decl, prefixes_decl = declared[family]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name: Optional[str] = arg.value
        elif isinstance(arg, ast.Name):
            name = resolve_str_constant(module.tree, arg.id)
            if name is None:
                continue  # dynamic: not checkable
        elif isinstance(arg, ast.JoinedStr):
            head = arg.values[0] if arg.values else None
            if not (isinstance(head, ast.Constant) and
                    isinstance(head.value, str)):
                continue  # leading formatted value: fully dynamic, skip
            prefix = head.value
            if not any(prefix.startswith(p) for p in prefixes):
                yield module.finding(
                    RULE_ID, node,
                    f"f-string {family} prefix {prefix!r} matches no "
                    f"declared prefix in {prefixes_decl} "
                    f"({', '.join(prefixes) or 'none'})",
                )
            continue
        else:
            continue
        if name not in names:
            yield module.finding(
                RULE_ID, node,
                f"{family} {name!r} is not declared in "
                f"runtime/metrics.py {names_decl} — declare it (and "
                f"its docstring entry) or fix the typo",
            )
