"""unclosed-span — span begin sites must be context-managed or justified.

The forensics plane (runtime/spans.py, docs/FORENSICS.md) records a
span only when its handle FINISHES: a ``SPANS.begin(...)`` whose
``finish()`` is skipped on some exit path is a span that silently
never happened — the request timeline shows a hole exactly where the
interesting (slow, failed, preempted) work was, which is the
worst-possible failure mode for a forensics layer.  The sanctioned
begin-site form is therefore the context manager::

    with SPANS.span("worker.solve", shard=b) as sp:
        ...

which cannot leak (error exits record too, tagged with an ``outcome``).
``SPANS.begin`` exists only for spans that genuinely cross a thread
boundary — a scheduler slot is submitted on the miner thread and
finished by the device loop — and every such call site must carry a
justified suppression naming its single finish point, so the leak
analysis lives AT the call site instead of in code review memory.
One-shot recorders (``SPANS.record`` / ``SPANS.event``) take explicit
timings and have no open state to leak; they are not begin sites.

Detection is lexical, like the sibling rules: any ``.begin(...)`` call
on a ``SPANS``/``spans`` receiver.  Scope: ``runtime/``, ``nodes/``,
``sched/``, ``parallel/`` and ``fleet/`` — the layers the span
vocabulary instruments (runtime/spans.py itself, which defines the
API, is exempt).
"""

from __future__ import annotations

import ast
from typing import Iterator

from ._util import in_dirs, is_module, receiver_name

RULE_ID = "unclosed-span"
DESCRIPTION = (
    "SPANS.begin call sites in runtime//nodes//sched//parallel//fleet/ "
    "must use the context-manager form (SPANS.span) or carry a "
    "justified suppression naming their single finish point"
)

_RECEIVERS = frozenset({"SPANS", "spans"})


def check(module, context) -> Iterator:
    if not in_dirs(module.path, "runtime", "nodes", "sched", "parallel",
                   "fleet"):
        return
    if is_module(module.path, "runtime/spans.py"):
        return
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "begin" and \
                receiver_name(node.func) in _RECEIVERS:
            yield module.finding(
                RULE_ID, node,
                "SPANS.begin opens a span some other scope must "
                "finish() — a missed exit path is a silent hole in the "
                "request timeline; use the `with SPANS.span(...)` form, "
                "or suppress with the single finish point that makes "
                "this cross-thread handle safe",
            )
