"""Consistent-hash ring over the coordinator pool (docs/CLUSTER.md).

The scale-out plane partitions the Mine keyspace across N coordinators
by consistent hashing over the **nonce alone** — NEVER ``(nonce,
ntz)``.  The dominance cache's whole value is that a secret found at
``ntz=k`` serves every request at ``ntz<=k`` *for the same nonce*; a
ring keyed on the pair would scatter one nonce's difficulties across
shards and no shard's cache would ever dominate anything.  Keying on
the nonce pins every difficulty of a nonce to ONE shard by
construction, which the property tests in tests/test_cluster.py treat
as a contract, not an implementation detail.

Why a ring and not ``hash(nonce) % N``: modulo routing remaps ~every
key when membership changes (N -> N+1 moves a fraction ``N/(N+1)`` of
the keyspace), which would cold-start every shard's dominance cache on
every scale event.  Consistent hashing bounds the churn: adding one
member remaps ~``1/(N+1)`` of the keyspace — only the keys the new
member takes over — and the distpow-lint ``modulo-routing`` rule keeps
the modulo shape from creeping back in (docs/LINT.md).

Determinism: the ring is a pure function of ``(members, vnodes)`` —
``blake2b`` point placement, no process state, no randomness — so every
coordinator and every client that agrees on the member list computes
the IDENTICAL ring.  Snapshots travel on the wire (``Cluster.Ring``,
the extended ``rpc.hello`` ack, and the ``NOT_OWNER`` redirect's
``ring`` field — runtime/rpc.py) as plain dicts via
:meth:`HashRing.to_wire`/:meth:`HashRing.from_wire`.

The port's own copy of the reference's ``cluster/ring.py``
(``distpow_tpu/cluster/ring.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

#: virtual nodes per member: enough that a 4-member ring's shares stay
#: within a few percent of equal, small enough that ring construction
#: is microseconds.  Part of the ring contract — every party must use
#: the same count, so it travels in the snapshot.
DEFAULT_VNODES = 64


def _point(data: bytes) -> int:
    """64-bit ring position.  blake2b, not ``hash()``: Python's hash is
    salted per process (PYTHONHASHSEED), and the ring must be identical
    across every process that builds it."""
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big"
    )


class HashRing:
    """Immutable consistent-hash ring over ``(member_id, addr)`` pairs.

    ``version`` orders snapshots: a client holding version ``v`` adopts
    any snapshot with ``version >= v`` (the pool re-advertises the same
    ring under the same version; a future membership change bumps it).
    """

    __slots__ = ("members", "vnodes", "version", "_points", "_owners",
                 "_addrs")

    def __init__(self, members: Sequence[Tuple[str, str]],
                 vnodes: int = DEFAULT_VNODES, version: int = 0) -> None:
        if not members:
            raise ValueError("a hash ring needs at least one member")
        ids = [m for m, _ in members]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate member ids in ring: {ids}")
        self.members: Tuple[Tuple[str, str], ...] = tuple(
            (str(m), str(a)) for m, a in members
        )
        self.vnodes = int(vnodes)
        self.version = int(version)
        self._addrs: Dict[str, str] = dict(self.members)
        points: List[Tuple[int, str]] = []
        for member_id, _addr in self.members:
            for i in range(self.vnodes):
                points.append(
                    (_point(f"{member_id}#{i}".encode()), member_id)
                )
        # ties (vanishingly unlikely at 64-bit) resolve by member id so
        # every caller that builds a ring sorts identically
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [m for _, m in points]

    # -- routing ------------------------------------------------------------
    def key_point(self, nonce: bytes) -> int:
        """Ring position of a Mine key: the NONCE alone (module
        docstring — same-nonce requests at every difficulty must land
        on the same shard or the dominance cache stops dominating)."""
        return _point(bytes(nonce))

    def owner(self, nonce: bytes) -> str:
        """Member id owning ``nonce``: first point clockwise."""
        idx = bisect.bisect_right(self._points, self.key_point(nonce))
        if idx == len(self._points):
            idx = 0
        return self._owners[idx]

    def ordered(self, nonce: bytes) -> List[str]:
        """All member ids in clockwise walk order from the key's point
        — the owner first, then each distinct successor.  The sibling
        order hedged retries and failover use: deterministic per key,
        different keys spread their second choices across the pool."""
        idx = bisect.bisect_right(self._points, self.key_point(nonce))
        seen: List[str] = []
        n = len(self._points)
        for i in range(n):
            m = self._owners[(idx + i) % n]
            if m not in seen:
                seen.append(m)
                if len(seen) == len(self.members):
                    break
        return seen

    def addr_of(self, member_id: str) -> Optional[str]:
        return self._addrs.get(member_id)

    def member_ids(self) -> List[str]:
        return [m for m, _ in self.members]

    # -- wire ---------------------------------------------------------------
    def to_wire(self) -> dict:
        return {
            "version": self.version,
            "vnodes": self.vnodes,
            "members": [[m, a] for m, a in self.members],
        }

    @classmethod
    def from_wire(cls, data: dict) -> "HashRing":
        members = [(str(m), str(a)) for m, a in (data.get("members") or [])]
        return cls(
            members,
            vnodes=int(data.get("vnodes") or DEFAULT_VNODES),
            version=int(data.get("version") or 0),
        )

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, HashRing)
                and self.members == other.members
                and self.vnodes == other.vnodes)

    def __hash__(self):  # pragma: no cover - rings are not dict keys
        return hash((self.members, self.vnodes))

    def __repr__(self) -> str:
        return (f"HashRing(v{self.version}, {len(self.members)} members, "
                f"{self.vnodes} vnodes)")


def ring_from_peers(peers: Sequence[str], version: int = 0,
                    vnodes: int = DEFAULT_VNODES) -> HashRing:
    """The pool's canonical ring: member ids ``c0..cN-1`` in peer-list
    order.  Coordinators build it from ``CoordinatorConfig.ClusterPeers``
    and clients from ``ClientConfig.CoordAddrs`` — same list, same
    math, same ring (module docstring)."""
    return HashRing([(f"c{i}", a) for i, a in enumerate(peers)],
                    vnodes=vnodes, version=version)
