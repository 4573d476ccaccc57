"""no-blocking-under-lock — no blocking I/O while a mutex is held.

The coordinator's per-key miss lock, the worker task table, the RPC
client's write lock and the tracer's clock lock are all contended from
RPC handler threads; a blocking call (RPC, socket send, device search,
sleep, event wait, subprocess) under any of them turns one slow peer
into a process-wide stall — the Python analogue of the interleaving
bugs the reference's Go race detector existed to catch.

A "lock" is any ``with`` context whose expression's terminal name
contains ``lock`` or ``mutex`` (``self._lock``, ``wlock``,
``self._key_lock(key)``); blocking calls are the project's known set:
socket ops (``sendall``/``recv``/``accept``/``connect``/
``create_connection``), blocking RPC (``.call``), device work
(``.search`` — ``re.search`` excluded), ``sleep``, event ``wait``,
``subprocess`` calls, ``RPCClient(...)`` construction (it dials), and
the tracing emit path (``emit``/``_emit``/``record_action``/
``record_actions`` — sinks send over TCP).

Lexical only: indirection (a helper that itself sends) is not tracked;
a deliberate hold (e.g. the tracer's emit-inside-lock ordering
invariant) is suppressed with a justification, which is the point —
the invariant becomes visible at the call site.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ._util import dotted_name, receiver_name, terminal_name, walk_same_scope

RULE_ID = "no-blocking-under-lock"
DESCRIPTION = (
    "no RPC call, socket send, device search, sleep, event wait, or "
    "subprocess while a threading lock is held"
)

BLOCKING_ATTRS = frozenset({
    "sendall", "recv", "accept", "connect", "create_connection",
    "call", "search", "sleep", "wait",
    "emit", "_emit", "record_action", "record_actions",
})
SUBPROCESS_ATTRS = frozenset({
    "run", "call", "check_call", "check_output", "communicate",
})
BLOCKING_CONSTRUCTORS = frozenset({"RPCClient", "create_connection"})
# receivers whose .search/.call etc. are not I/O
BENIGN_RECEIVERS = frozenset({"re", "regex", "pattern"})


def _is_lock_context(expr: ast.AST) -> bool:
    node = expr.func if isinstance(expr, ast.Call) else expr
    name = terminal_name(node)
    if name is None:
        return False
    lowered = name.lower()
    return "lock" in lowered or "mutex" in lowered


def _blocking_reason(call: ast.Call) -> str:
    func = call.func
    if isinstance(func, ast.Name):
        if func.id in BLOCKING_CONSTRUCTORS:
            return f"{func.id}(...) dials/blocks"
        return ""
    if not isinstance(func, ast.Attribute):
        return ""
    recv = receiver_name(func)
    if recv in BENIGN_RECEIVERS:
        return ""
    if recv == "subprocess" and func.attr in SUBPROCESS_ATTRS:
        return f"subprocess.{func.attr}(...) blocks on a child process"
    if func.attr in BLOCKING_ATTRS:
        return f".{func.attr}(...) can block"
    return ""


def check(module, context) -> Iterator:
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.With):
            continue
        lock_items = [i for i in node.items
                      if _is_lock_context(i.context_expr)]
        if not lock_items:
            continue
        held = dotted_name(
            lock_items[0].context_expr.func
            if isinstance(lock_items[0].context_expr, ast.Call)
            else lock_items[0].context_expr
        ) or "lock"
        for child in walk_same_scope(node):
            if not isinstance(child, ast.Call):
                continue
            reason = _blocking_reason(child)
            if reason:
                yield module.finding(
                    RULE_ID, child,
                    f"{reason} while holding {held} (acquired line "
                    f"{node.lineno}); move it outside the critical "
                    f"section or suppress with the invariant that makes "
                    f"the hold safe",
                )
