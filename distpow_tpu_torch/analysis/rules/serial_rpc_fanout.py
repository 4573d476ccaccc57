"""serial-rpc-fanout — no blocking per-peer RPC inside a fan-out loop.

The control plane's scaling law (docs/RPC.md "Control-plane
concurrency"): a blocking ``.call(...)`` issued once per worker inside a
loop makes round start, the cancel storm, and every broadcast cost
O(N x RTT) — and one hung peer head-of-line-blocks the rest for its
full timeout.  The sanctioned shape is issue-then-await: fan the
``RPCClient.go()`` futures out first, then collect replies under one
shared deadline (nodes/coordinator.py ``_assign_shards`` /
``_broadcast_found``).  This rule freezes that invariant: a serial
``.call`` loop reintroduced in ``nodes/`` is a lint failure, not a
latency regression someone has to re-measure on hardware.

The fleet scraper (``obs/``) is the same bug
class one layer up: a sweep that Stats-polls N nodes one after another
serializes the cluster view on round trips and lets one SIGSTOP'd node
stall the whole sweep for its timeout — exactly what the shared-
deadline concurrent poll exists to prevent (docs/SLO.md).  The rule
therefore covers ``obs/`` with the same detection and the same
suppression protocol.

The replication plane (``cluster/``) is the
third habitat: write-behind pushes, anti-entropy digest exchanges, and
warm-handoff sends all loop over peer collections with an RPC inside.
Some of those loops are DELIBERATELY serial — the single background
pusher thread is the design, not an accident — but the rule still
covers ``cluster/`` so every such loop carries its bound in a
suppression (queue depth, successor count, sweep cadence, deadline)
instead of being invisibly exempt.

Detection is lexical, like the sibling rules: a ``for`` loop whose
iterated expression mentions a worker/peer-collection name (any
identifier containing ``worker``, ``peer``, ``task``, ``ref``,
``client`` or ``addr``) and whose body — nested loops included, nested
function bodies excluded — contains an attribute call named ``call``.
``subprocess.call`` is a different hazard (no-blocking-under-lock
territory) and is excluded.  Deliberately-serial remaining cases (the
failure detector's bounded 2 s probes in ``_probe_dead``) carry
justified suppressions at the call site, which is the point — the
invariant that makes serial acceptable becomes visible where it holds.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ._util import in_dirs, receiver_name, walk_same_scope

RULE_ID = "serial-rpc-fanout"
DESCRIPTION = (
    "no blocking .call() per peer inside a loop over worker/peer/node "
    "collections in nodes/, obs/ or cluster/ — issue go() futures, "
    "then await"
)

#: identifiers that mark a loop as iterating a peer collection
#: (``target``/``node``/``state`` cover the obs/ scraper's vocabulary)
COLLECTION_HINTS = ("worker", "peer", "task", "ref", "client", "addr",
                    "target", "node", "state")

#: receivers whose .call is not an RPC
EXCLUDED_RECEIVERS = frozenset({"subprocess"})


def _iter_mentions_peers(iter_expr: ast.AST) -> bool:
    names: Set[str] = set()
    for node in ast.walk(iter_expr):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
    lowered = {n.lower() for n in names}
    return any(h in n for n in lowered for h in COLLECTION_HINTS)


def check(module, context) -> Iterator:
    if not in_dirs(module.path, "nodes", "obs", "cluster"):
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.For):
            continue
        if not _iter_mentions_peers(node.iter):
            continue
        for child in walk_same_scope(node):
            if not isinstance(child, ast.Call):
                continue
            func = child.func
            if not isinstance(func, ast.Attribute) or func.attr != "call":
                continue
            if receiver_name(func) in EXCLUDED_RECEIVERS:
                continue
            yield module.finding(
                RULE_ID, child,
                f"blocking .call() per peer inside the loop over "
                f"worker/peer collection (line {node.lineno}) serializes "
                f"the fan-out on round trips — issue RPCClient.go() "
                f"futures for every peer first, then await them under "
                f"one shared deadline, or suppress with the invariant "
                f"that makes serial dispatch safe here",
            )
