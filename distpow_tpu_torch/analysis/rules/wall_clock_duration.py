"""wall-clock-duration — durations must come from the monotonic clock.

``time.time()`` is the WALL clock: NTP slews it, admins step it, leap
smears stretch it.  A duration computed as the difference of two wall
readings silently goes negative or jumps by seconds when that happens —
and every consumer downstream (latency histograms, rate estimators, the
soak plane's lag budget, retry backoff) misjudges.  The stdlib grew
``time.monotonic()`` for exactly this; the rule makes the split
mechanical inside the planes that compute durations for a living
(``runtime/``, ``obs/``, ``load/``, ``nodes/``):

* any ``a - b`` where an operand is a ``time.time()`` call, a local
  name assigned from one in the same scope, or an attribute assigned
  from one anywhere in the module, is flagged;
* wall time IS the point in a few places — cross-process timestamps
  (one node's ``time.time()`` judged against another's, where no shared
  monotonic epoch exists), spool/journal record stamps, staleness ages
  against scraped snapshots.  Those carry ``# distpow: ok
  wall-clock-duration -- <why>`` suppressions; the justification is the
  documentation.

The rule is deliberately syntactic (no cross-module dataflow): a
wall-clock reading that escapes through a return value or a container
is not traced.  That bounds false negatives, not false positives —
everything it DOES flag is a wall-minus-something delta.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ._util import dotted_name, in_dirs

RULE_ID = "wall-clock-duration"
DESCRIPTION = (
    "time.time() deltas used as durations in runtime//obs//load//nodes/ "
    "must be time.monotonic() (wall clock slews; suppress where wall "
    "time is the point)"
)

_SCOPES = ("runtime", "obs", "load", "nodes")


def _is_wall_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and dotted_name(node.func) == "time.time")


def _assigned_names(body_node: ast.AST, *, attrs: bool) -> Set[str]:
    """Names (or attribute terminal names, with ``attrs=True``) assigned
    from a bare ``time.time()`` call anywhere under ``body_node``."""
    out: Set[str] = set()
    for node in ast.walk(body_node):
        if not (isinstance(node, ast.Assign) and _is_wall_call(node.value)):
            continue
        for t in node.targets:
            if not attrs and isinstance(t, ast.Name):
                out.add(t.id)
            elif attrs and isinstance(t, ast.Attribute):
                out.add(t.attr)
    return out


def check(module, context) -> Iterator:
    if not in_dirs(module.path, *_SCOPES):
        return
    # attributes carry wall readings across method boundaries
    # (``self._t0 = time.time()`` ... ``time.time() - self._t0``), so
    # their taint is module-wide; plain names are scoped to their
    # function (a ``now`` in one helper says nothing about another's)
    wall_attrs = _assigned_names(module.tree, attrs=True)

    funcs = [n for n in ast.walk(module.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    scopes = [(module.tree, _assigned_names(module.tree, attrs=False)
               - {n for f in funcs
                  for n in _assigned_names(f, attrs=False)})]
    scopes += [(f, _assigned_names(f, attrs=False)) for f in funcs]

    seen: Set[int] = set()
    for scope, wall_names in scopes:
        for node in ast.walk(scope):
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)):
                continue
            if id(node) in seen:
                continue
            for side in (node.left, node.right):
                tainted = (
                    _is_wall_call(side)
                    or (isinstance(side, ast.Name)
                        and side.id in wall_names)
                    or (isinstance(side, ast.Attribute)
                        and side.attr in wall_attrs)
                )
                if tainted:
                    seen.add(id(node))
                    yield module.finding(
                        RULE_ID, node,
                        "wall-clock delta: time.time() readings are not "
                        "monotonic (NTP slew/step) — compute durations "
                        "from time.monotonic(), or suppress with a "
                        "justification where wall time is the point",
                    )
                    break
