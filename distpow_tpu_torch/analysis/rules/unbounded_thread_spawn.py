"""unbounded-thread-spawn — no ``threading.Thread`` creation in loops.

The membership plane multiplies the places the control plane
reacts to per-member events — heartbeats, lease expiries, drains,
hedges — and the tempting shape for each is "spawn a thread per item in
the loop".  A thread is ~8 MB of stack and a scheduler entity; a loop
that mints one per member (or per request, per retry, per beat) scales
its resource cost with an UNBOUNDED external quantity and has produced
real fork-bomb-shaped incidents elsewhere.  The sanctioned shapes are:

* one persistent loop thread created OUTSIDE the loop (the fleet
  agent's heartbeat loop, the registry's single reaper);
* a pool/executor whose width is fixed up front (``submit`` inside the
  loop is fine — the pool bounds concurrency);
* a deliberately-bounded per-item spawn carrying a justified
  suppression naming the bound (the coordinator's
  ``_resync_abandoned`` workers are capped by the abandoned count AND
  the shared ``RESYNC_CAP_S`` deadline; the RPC server's
  thread-per-connection/request dispatch is the documented Go
  ``net/rpc`` goroutine-parity semantics).

Detection is lexical, like the sibling rules: any ``threading.Thread``
/ ``Thread`` constructor call inside a ``for`` or ``while`` loop body —
nested loops included, nested function/class bodies excluded (a
callback DEFINED in a loop is not SPAWNED by it).  Scope: ``nodes/``,
``runtime/``, ``fleet/`` and ``cluster/`` — the replication plane
spawns one warm-handoff sender per new owner, which is
exactly the per-item-spawn shape this rule exists to make justify its
bound (pool-size cap + shared handoff deadline, carried in the
suppression at the spawn site).
"""

from __future__ import annotations

import ast
from typing import Iterator

from ._util import dotted_name, in_dirs

RULE_ID = "unbounded-thread-spawn"
DESCRIPTION = (
    "no threading.Thread creation inside loops in nodes//runtime//"
    "fleet//cluster/ — use one persistent thread, a bounded pool, or "
    "suppress with the bound that makes the per-item spawn safe"
)

_THREAD_NAMES = frozenset({"threading.Thread", "Thread"})
_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def _loop_body_calls(loop: ast.AST) -> Iterator[ast.Call]:
    """Thread-constructor calls in THIS loop's direct dynamic extent:
    nested function/class bodies are excluded (defined, not spawned,
    by the loop) and nested loops are pruned — their spawns anchor to
    the innermost loop so one call never reports twice."""
    stack = list(ast.iter_child_nodes(loop))
    while stack:
        child = stack.pop()
        if isinstance(child, (_SCOPE_NODES, ast.For, ast.While)):
            continue
        if isinstance(child, ast.Call) and \
                dotted_name(child.func) in _THREAD_NAMES:
            yield child
        stack.extend(ast.iter_child_nodes(child))


def check(module, context) -> Iterator:
    if not in_dirs(module.path, "nodes", "runtime", "fleet", "cluster"):
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        for call in _loop_body_calls(node):
            yield module.finding(
                RULE_ID, call,
                f"threading.Thread created inside the loop at line "
                f"{node.lineno}: thread count now scales with the loop's "
                f"trip count — hoist one persistent thread out of the "
                f"loop, submit to a bounded pool, or suppress with the "
                f"bound that keeps this spawn finite",
            )
