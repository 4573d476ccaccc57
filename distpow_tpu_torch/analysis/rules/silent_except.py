"""silent-except — broad catches in the protocol planes must account.

``nodes/`` and ``runtime/`` are the protocol: a swallowed ``except
Exception`` there converts an invariant violation into a silent
behavioral drift (the round-5 silently-capped-watcher class).  Narrow
catches (``except OSError``) are the normal idiom and exempt; a broad
handler — bare ``except:`` or one whose matched types include
``Exception``/``BaseException`` — must do at least one of:

* re-raise (``raise``),
* log through a logging receiver (``log.warning(...)``, ``logger.*``,
  ``logging.*``),
* count a metric (``metrics.inc``/``REGISTRY.inc``).

Handlers that genuinely must stay silent (the compile-cache hook that
runs INSIDE the warnings/logging machinery it instruments) carry a
suppression with that justification.  Nested defs inside the handler
don't count — they run later, if ever.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ._util import in_dirs, receiver_name, walk_same_scope

RULE_ID = "silent-except"
DESCRIPTION = (
    "except Exception in nodes//runtime/ must log, count a metric, "
    "or re-raise"
)

LOG_RECEIVERS = frozenset({"log", "logger", "logging"})
LOG_METHODS = frozenset({
    "debug", "info", "warning", "warn", "error", "exception", "critical",
})
METRIC_RECEIVERS = frozenset({"metrics", "REGISTRY"})


def _in_scope(path: str) -> bool:
    return in_dirs(path, "nodes", "runtime")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    names = []
    if isinstance(t, ast.Tuple):
        names = [getattr(e, "id", getattr(e, "attr", None)) for e in t.elts]
    else:
        names = [getattr(t, "id", getattr(t, "attr", None))]
    return any(n in ("Exception", "BaseException") for n in names)


def _accounts(handler: ast.ExceptHandler) -> bool:
    for node in walk_same_scope(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            recv = receiver_name(node.func)
            if recv in LOG_RECEIVERS and node.func.attr in LOG_METHODS:
                return True
            if recv in METRIC_RECEIVERS and node.func.attr == "inc":
                return True
    return False


def check(module, context) -> Iterator:
    if not _in_scope(module.path):
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if _is_broad(node) and not _accounts(node):
            what = "bare except:" if node.type is None else "except Exception"
            yield module.finding(
                RULE_ID, node,
                f"{what} swallows errors in the protocol plane without "
                f"logging, counting a metric, or re-raising — narrow the "
                f"exception, account for it, or suppress with why "
                f"silence is required here",
            )
