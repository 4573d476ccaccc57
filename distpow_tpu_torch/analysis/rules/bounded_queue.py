"""bounded-queue — no unbounded queue construction in the serving planes.

The scheduler subsystem exists because unbounded buffering is how a
serving stack dies under load: memory grows until the OOM killer picks
a victim, and every queued request ages instead of being shed with a
typed RETRY_AFTER (sched/admission.py).  ``nodes/``, ``runtime/`` and
``sched/`` are the planes where a ``queue.Queue()`` sits between RPC
threads, so an unbounded one there must be a *decision*, not a default:

* ``queue.Queue()`` with no capacity, or an explicit ``maxsize`` that
  is a non-positive literal, is flagged;
* ``queue.SimpleQueue()`` is always unbounded and always flagged;
* a positive-literal or variable capacity passes (a variable is assumed
  to be a configured bound — the linter cannot prove otherwise and must
  not cry wolf on ``Queue(maxsize=ch_capacity)``).

Queues that are genuinely protocol-bounded (the coordinator's per-round
result queue: at most two messages per live worker) or must never drop
(the worker's result forwarder) carry a suppression stating exactly
that invariant — which is the point: the bound, or the reason none is
safe, becomes visible at the construction site.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ._util import dotted_name, in_dirs

RULE_ID = "bounded-queue"
DESCRIPTION = (
    "queue.Queue()/SimpleQueue() without a positive capacity in "
    "nodes//runtime//sched/"
)

_QUEUE_CTORS = frozenset({"Queue", "LifoQueue", "PriorityQueue"})


def _in_scope(path: str) -> bool:
    return in_dirs(path, "nodes", "runtime", "sched")


def _queue_ctor(call: ast.Call) -> str:
    """'Queue'/'SimpleQueue' for a queue-module constructor call, else ''.

    Matches both ``queue.Queue(...)`` and a bare imported ``Queue(...)``
    — the import style must not decide whether the bound is checked.
    """
    name = dotted_name(call.func)
    if name is None:
        return ""
    parts = name.split(".")
    last = parts[-1]
    if last == "SimpleQueue":
        return last
    if last in _QUEUE_CTORS and (len(parts) == 1 or parts[-2] == "queue"):
        return last
    return ""


def _capacity_ok(call: ast.Call) -> bool:
    """True when the construction carries a usable bound."""
    args = list(call.args)
    for kw in call.keywords:
        if kw.arg == "maxsize":
            args.append(kw.value)
    if not args:
        return False
    cap = args[0]
    if isinstance(cap, ast.Constant):
        return isinstance(cap.value, (int, float)) and cap.value > 0
    # non-literal capacity: assume a configured bound
    return True


def check(module, context) -> Iterator:
    if not _in_scope(module.path):
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        ctor = _queue_ctor(node)
        if not ctor:
            continue
        if ctor == "SimpleQueue":
            yield module.finding(
                RULE_ID, node,
                "queue.SimpleQueue() is always unbounded — use "
                "queue.Queue(maxsize=N), or suppress with the invariant "
                "that bounds it",
            )
        elif not _capacity_ok(node):
            yield module.finding(
                RULE_ID, node,
                f"unbounded queue.{ctor}() in a serving plane — pass a "
                f"positive maxsize, or suppress with the invariant that "
                f"bounds the depth (protocol ledger, gauged backlog, ...)",
            )
