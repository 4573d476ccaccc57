"""modulo-routing — no ``hash(key) % len(members)`` shard routing.

The scale-out plane's cache-locality law (docs/CLUSTER.md): routing a
key by reducing its hash modulo the member count remaps ~every key
whenever membership changes — ``N -> N+1`` moves a fraction
``N/(N+1)`` of the keyspace — so every scale event cold-starts every
shard's dominance cache at once.  The sanctioned shape is the
consistent-hash ring (``distpow_tpu_torch/cluster/ring.py``): adding one
member remaps only ~``1/(N+1)`` of the keyspace, and the ring is a
pure function of the member list so every party computes it
identically.  This rule freezes that invariant in ``nodes/``,
``cluster/`` and ``fleet/``: a modulo-over-membership expression
reintroduced there is a lint failure, not a cache-hit-rate regression
someone has to notice on a dashboard three scale events later.

Detection is lexical, like the sibling rules: a ``%`` BinOp whose
RIGHT side is ``len(<members-ish>)`` (any identifier containing
``member``/``worker``/``peer``/``node``/``coordinator``/``shard``/
``ring``/``replica``/``addr``/``server``) and whose LEFT side mentions
a hash — the ``hash()``/``crc32()``/``adler32()`` builtins, a
``.digest()``/``.hexdigest()`` call, or any identifier containing
``hash``/``digest``/``crc``.  Round-robin index arithmetic
(``i % len(candidates)`` — the coordinator's reassignment rotation) is
hash-free on the left and deliberately NOT flagged: rotating
placements is load balancing, not key routing, and has no cache
locality to lose.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ._util import in_dirs

RULE_ID = "modulo-routing"
DESCRIPTION = (
    "no hash(...) % len(members) shard routing in nodes/, cluster/ or "
    "fleet/ — membership changes remap ~every key; use the consistent-"
    "hash ring (cluster/ring.py)"
)

#: identifiers that mark a ``len(...)`` operand as a member collection
MEMBER_HINTS = ("member", "worker", "peer", "node", "coordinator",
                "shard", "ring", "replica", "addr", "server")

#: callables whose result is a hash value
HASH_CALLS = frozenset({"hash", "crc32", "adler32"})
HASH_METHOD_CALLS = frozenset({"digest", "hexdigest", "intdigest"})


def _names_in(expr: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    return out


def _is_member_len(expr: ast.AST) -> bool:
    """True for ``len(X)`` where X mentions a member-collection name."""
    if not (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
            and expr.func.id == "len" and expr.args):
        return False
    lowered = {n.lower() for n in _names_in(expr.args[0])}
    return any(h in n for n in lowered for h in MEMBER_HINTS)


def _mentions_hash(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Name) and func.id in HASH_CALLS:
                return True
            if isinstance(func, ast.Attribute) and \
                    func.attr in HASH_METHOD_CALLS:
                return True
    lowered = {n.lower() for n in _names_in(expr)}
    return any(h in n for n in lowered for h in ("hash", "digest", "crc"))


def check(module, context) -> Iterator:
    if not in_dirs(module.path, "nodes", "cluster", "fleet"):
        return
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.BinOp)
                and isinstance(node.op, ast.Mod)):
            continue
        if not _is_member_len(node.right):
            continue
        if not _mentions_hash(node.left):
            continue
        yield module.finding(
            RULE_ID, node,
            "hash % len(members) routing remaps ~every key on any "
            "membership change, cold-starting every shard's dominance "
            "cache at once — route through the consistent-hash ring "
            "(cluster/ring.py HashRing.owner, ~1/N churn per member "
            "change), or suppress with the invariant that makes modulo "
            "reshuffling safe here",
        )
