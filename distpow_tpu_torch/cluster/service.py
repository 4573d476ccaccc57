"""Coordinator-side cluster plane: shard identity + the ``Cluster`` RPC.

One :class:`ClusterState` per pooled coordinator binds the pool's
:class:`..cluster.ring.HashRing` to this process's own member id.  The
coordinator consults it at the top of every Mine (nodes/coordinator.py):
a key the ring maps elsewhere earns a typed :class:`NotOwnerError`
redirect carrying a fresh ring snapshot — the client adopts the
snapshot and re-routes without a second discovery round trip.  A Mine
carrying ``no_redirect`` (powlib's hedged sibling retries and
failover sends) is served even when foreign: every coordinator fans
out over the SAME shared worker fleet, so correctness never depends on
ownership — only dominance-cache locality does.

The ``Cluster.Ring`` RPC (registered on both coordinator listeners)
serves the snapshot on demand; the same snapshot rides the extended
``rpc.hello`` ack (runtime/rpc.py ``hello_extra``), so a freshly dialed
client learns the ring in its very first exchange.

The service also carries the replication plane's two peer RPCs
(cluster/replication.py, docs/CLUSTER.md "Replication & HA"):
``Cluster.CacheSync`` (write-behind entry pushes and the anti-entropy
digest exchange) and ``Cluster.Handoff`` (warm shard handoff on
membership change).  Both funnel installs through the dominance order,
so a stale push can never regress an entry.  A single-coordinator
deployment registers the service with ``replicator=None`` — the two
RPCs then refuse politely and nothing about the pre-cluster wire
surface changes.

The port's own copy of the reference's ``cluster/service.py``
(``distpow_tpu/cluster/service.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..runtime.metrics import REGISTRY as metrics
from .ring import HashRing

if TYPE_CHECKING:  # import cycle: replication imports nothing from
    from .replication import CacheReplicator  # here, but keep it lazy


class NotOwnerError(Exception):
    """This coordinator does not own the request's nonce.

    Duck-typed by the RPC layer exactly like the admission plane's
    ``retry_after_s`` (runtime/rpc.py must not import cluster): the
    ``ring_wire`` attribute ships as the response frame's dedicated
    ``ring`` field, and the client surfaces the pair as a typed
    ``RPCNotOwner`` — machine-readable redirect, not a string to parse.
    """

    def __init__(self, owner: str, ring_wire: dict) -> None:
        super().__init__(
            f"NOT_OWNER: key is owned by shard {owner!r} "
            f"(ring v{ring_wire.get('version', 0)})"
        )
        self.owner = owner
        self.ring_wire = ring_wire


class ClusterState:
    """This coordinator's view of the pool: the ring + its own id."""

    __slots__ = ("ring", "self_id")

    def __init__(self, ring: HashRing, self_id: str) -> None:
        if ring.addr_of(self_id) is None:
            raise ValueError(
                f"self id {self_id!r} is not a ring member "
                f"({ring.member_ids()})"
            )
        self.ring = ring
        self.self_id = self_id

    def owns(self, nonce: bytes) -> bool:
        return self.ring.owner(nonce) == self.self_id

    def hello_extra(self) -> dict:
        """Payload merged into the ``rpc.hello`` ack (runtime/rpc.py):
        the ring reaches every dialing client in exchange zero."""
        return {"ring": self.ring.to_wire()}


class ClusterService:
    """The ``Cluster`` RPC service (``Cluster.Ring`` always;
    ``Cluster.CacheSync``/``Cluster.Handoff`` when a replicator is
    wired, i.e. only in pool mode)."""

    def __init__(self, state: ClusterState,
                 replicator: Optional["CacheReplicator"] = None) -> None:
        self._state = state
        self._replicator = replicator

    def Ring(self, params: dict) -> dict:
        metrics.inc("cluster.ring_serves")
        return {"ring": self._state.ring.to_wire(),
                "self": self._state.self_id}

    def CacheSync(self, params: dict) -> dict:
        """Replication peer traffic (cluster/replication.py).

        Two shapes share the method so the wire vocabulary stays small:
        ``{"digest": n_buckets, "self": peer}`` asks for this member's
        per-ring-range summary digests of the entries ``peer`` owns and
        the ring replicates here; ``{"entries": [...], "self": peer}``
        pushes entries, installed through the dominance order — the
        reply's ``stale`` count is the dominance order rejecting
        regressions, not an error.
        """
        repl = self._replicator
        if repl is None:
            raise ValueError("NO_REPLICATION: this coordinator has no "
                             "replication plane (single-member pool?)")
        if "digest" in params:
            return {"digest": repl.digests_for(
                str(params.get("self", "")), int(params["digest"]))}
        installed, stale = repl.install(params.get("entries"))
        return {"installed": installed, "stale": stale}

    def Handoff(self, params: dict) -> dict:
        """Warm shard handoff receiver: a member losing keys on a ring
        change pushes the remapped entries here BEFORE acking the new
        ring.  Same dominance-ordered install as CacheSync — arriving
        entries can never regress what this member already holds."""
        repl = self._replicator
        if repl is None:
            raise ValueError("NO_REPLICATION: this coordinator has no "
                             "replication plane (single-member pool?)")
        installed, stale = repl.install(params.get("entries"))
        return {"installed": installed, "stale": stale}
