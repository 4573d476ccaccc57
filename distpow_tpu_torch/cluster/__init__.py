"""Coordinator scale-out plane (docs/CLUSTER.md).

A pool of N coordinators partitions the Mine keyspace by consistent
hashing over the nonce (ring.py), advertises the ring through the
extended ``rpc.hello`` ack and the ``Cluster.Ring`` RPC (service.py),
and redirects misrouted keys with a typed ``NOT_OWNER`` reply carrying
a fresh ring snapshot.  powlib (nodes/powlib.py) is the cluster-aware
client: owner routing, hedged sibling retry on RETRY_AFTER, and
ring-guided failover when a shard dies.

replication.py makes the partition SURVIVE member death: write-behind
pushes to each key's ring successors, a slow anti-entropy digest loop
that heals missed pushes, and a warm shard handoff that moves remapped
ranges to their new owner before a ring change is acked
(docs/CLUSTER.md "Replication & HA").

The port's own copy of the reference's ``cluster/__init__.py``
(``distpow_tpu/cluster/__init__.py``): it
imports nothing of the JAX package.
"""

from .replication import Replicator, entry_wire, range_digests
from .ring import DEFAULT_VNODES, HashRing, ring_from_peers
from .service import ClusterService, ClusterState, NotOwnerError

__all__ = [
    "DEFAULT_VNODES",
    "HashRing",
    "ring_from_peers",
    "ClusterService",
    "ClusterState",
    "NotOwnerError",
    "Replicator",
    "entry_wire",
    "range_digests",
]
