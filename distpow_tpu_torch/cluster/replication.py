"""Replicated dominance cache: write-behind pushes, anti-entropy, and
warm shard handoff (docs/CLUSTER.md "Replication & HA").

The ring gives every nonce ONE owner; this module makes the owner's
dominance-cache entries survive that owner's death.  Three cooperating
mechanisms, all riding the existing dominance order (runtime/cache.py
``add`` — install iff strictly more trailing zeros, or equal zeros and
a lexicographically greater secret), which makes every replica install
idempotent and convergent regardless of arrival order:

* **Write-behind replication** — on every accepted cache install the
  owner :meth:`Replicator.offer`\\ s the entry into a BOUNDED queue; a
  single persistent pusher thread drains it and pushes batches to the
  key's R ring successors (``CoordinatorConfig.ClusterCacheReplicas``)
  via ``Cluster.CacheSync``.  Off the Mine critical path by
  construction: a full queue drops the entry (``repl.push_failures``)
  rather than backpressure the handler, and anti-entropy heals the
  drop later.

* **Anti-entropy reconciliation** — a slow background loop exchanges
  per-ring-range summary digests (count + max-ntz + xor fingerprint
  over ``digest_buckets`` ranges of the 64-bit ring space) with each
  successor and pushes only the diverged ranges' entries, capped per
  sweep (``antientropy_max_entries``) so bandwidth stays bounded.
  This is what heals a replica that was down when the write-behind
  push happened — including a freshly restarted member that replayed
  its journal but missed traffic while dead.

* **Warm shard handoff** — on membership change the members losing
  keys compute exactly the remapped ranges (old ring's owner = self,
  new ring's owner = someone else) and push those entries to their new
  owner via ``Cluster.Handoff`` BEFORE the new ring is installed, one
  sender thread per target under one shared deadline — a frozen
  recipient costs at most ``ClusterHandoffDeadlineS``, never a wedged
  ring change (tests/test_cluster.py pins the exactly-the-remapped-
  keys property in both the N→N+1 and N+1→N directions).

A stale push (lower ntz than the replica already holds) is REJECTED by
the dominance order and counted as ``repl.stale_drops`` — evidence the
order held, never a regression.  Single-coordinator deployments never
construct a :class:`Replicator`, so every pre-cluster code path and
wire frame stays byte-identical (test-pinned).

The port's own copy of the reference's ``cluster/replication.py``
(``distpow_tpu/cluster/replication.py``):
it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..runtime.metrics import REGISTRY as metrics
from ..runtime.rpc import RPCClient, RPCError
from ..runtime.telemetry import RECORDER

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # typing only: the replicator treats the cache as
    from ..runtime.cache import ResultCache  # an add/snapshot surface
from .ring import HashRing
from .service import ClusterState

log = logging.getLogger("distpow.replication")

#: entries per Cluster.Handoff call — small enough that one chunk's
#: send fits comfortably inside the per-call deadline slice, large
#: enough that a 10k-entry cache hands off in ~80 calls
HANDOFF_CHUNK = 128
#: entries drained per pusher wakeup — bounds one CacheSync frame
PUSH_BATCH = 64


def entry_wire(nonce: bytes, ntz: int, secret: bytes) -> dict:
    """One cache entry in CacheSync/Handoff wire form (all three keys
    are interned in the wire-v2 KEYS table)."""
    return {"nonce": bytes(nonce), "num_trailing_zeros": int(ntz),
            "secret": bytes(secret)}


def _fingerprint(nonce: bytes, ntz: int, secret: bytes) -> int:
    """64-bit per-entry fingerprint; a range's fingerprint is the XOR
    over its entries, so it is order-independent and updates cancel."""
    h = hashlib.blake2b(digest_size=8)
    h.update(bytes(nonce))
    h.update(ntz.to_bytes(4, "big"))
    h.update(bytes(secret))
    return int.from_bytes(h.digest(), "big")


def range_digests(entries: List[Tuple[bytes, int, bytes]],
                  ring: HashRing, n_buckets: int) -> List[List[int]]:
    """Per-ring-range summary digests: ``n_buckets`` triples of
    ``[count, max_ntz, xor_fingerprint]`` over the 64-bit ring space.
    Both reconciliation sides compute this over the SAME key filter, so
    equal sets digest identically and a diverged bucket names exactly
    the ranges worth re-pushing."""
    out = [[0, 0, 0] for _ in range(n_buckets)]
    for nonce, ntz, secret in entries:
        b = (ring.key_point(nonce) * n_buckets) >> 64
        d = out[b]
        d[0] += 1
        d[1] = max(d[1], int(ntz))
        d[2] ^= _fingerprint(nonce, ntz, secret)
    return out


class Replicator:
    """Per-pooled-coordinator replication engine (module docstring).

    Owns the bounded write-behind queue + single pusher thread, the
    anti-entropy loop, the replica-install path both ``Cluster`` RPCs
    funnel into, and the warm-handoff sender.  Constructed only by
    pooled coordinators (``Coordinator.set_cluster_peers``); single
    coordinators never see it.
    """

    def __init__(self, cache: "ResultCache", *, replicas: int = 1,
                 queue_depth: int = 1024,
                 antientropy_s: float = 5.0,
                 handoff_deadline_s: float = 5.0,
                 push_timeout_s: float = 5.0,
                 digest_buckets: int = 32,
                 antientropy_max_entries: int = 512) -> None:
        self._cache = cache
        self.replicas = max(0, int(replicas))
        self.antientropy_s = float(antientropy_s)
        self.handoff_deadline_s = float(handoff_deadline_s)
        self.push_timeout_s = float(push_timeout_s)
        self.digest_buckets = max(1, int(digest_buckets))
        self.antientropy_max_entries = max(1, int(antientropy_max_entries))
        # (nonce, ntz, secret, t_enqueue); BOUNDED — overflow drops,
        # the Mine path never blocks on replication (module docstring)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(queue_depth)))
        self._state: Optional[ClusterState] = None
        self._clients: Dict[str, Tuple[str, RPCClient]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def set_state(self, state: ClusterState) -> None:
        """Adopt the (new) ring + self id and lazily start the
        background threads.  Called from ``set_cluster_peers`` AFTER
        any warm handoff for the ring change has run."""
        with self._lock:
            self._state = state
        self._start_threads()

    def _start_threads(self) -> None:
        with self._lock:
            if self._started or self.replicas <= 0:
                return
            self._started = True
        pusher = threading.Thread(target=self._push_loop, daemon=True,
                                  name="repl-pusher")
        pusher.start()
        self._threads.append(pusher)
        if self.antientropy_s > 0:
            ae = threading.Thread(target=self._antientropy_loop,
                                  daemon=True, name="repl-antientropy")
            ae.start()
            self._threads.append(ae)

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for _addr, c in clients:
            c.close()

    # -- write-behind push path ----------------------------------------------
    def offer(self, nonce: bytes, ntz: int, secret: bytes) -> bool:
        """Enqueue one accepted cache install for replication; never
        blocks (the Mine critical path calls this).  False = dropped
        (queue full / replication off), counted and healed later."""
        with self._lock:
            state = self._state
        if (self.replicas <= 0 or state is None
                or len(state.ring.members) < 2):
            return False
        try:
            self._q.put_nowait((bytes(nonce), int(ntz), bytes(secret),
                                time.monotonic()))
            return True
        except queue.Full:
            metrics.inc("repl.push_failures")
            log.warning("replication queue full; dropping push for %s "
                        "(anti-entropy will heal)", bytes(nonce).hex())
            return False

    def _push_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [item]
            while len(batch) < PUSH_BATCH:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            try:
                self._push_batch(batch)
            except Exception:
                # the pusher must outlive any single bad batch; the
                # entries are dropped (counted) and anti-entropy heals
                metrics.inc("repl.push_failures", len(batch))
                log.exception("replication push batch failed")

    def _push_batch(self, batch: list) -> None:
        with self._lock:
            state = self._state
        if state is None:
            return
        ring, me = state.ring, state.self_id
        by_target: Dict[str, list] = {}
        for nonce, ntz, secret, t0 in batch:
            for succ in ring.ordered(nonce)[1:1 + self.replicas]:
                by_target.setdefault(succ, []).append(
                    (nonce, ntz, secret, t0))
        for target, items in sorted(by_target.items()):
            entries = [entry_wire(n, z, s) for n, z, s, _ in items]
            try:
                client = self._client(target, ring.addr_of(target))
                client.call("Cluster.CacheSync",
                            {"entries": entries, "self": me},
                            timeout=self.push_timeout_s)  # distpow: ok serial-rpc-fanout -- deliberately serial: the pusher is a single background thread OFF the Mine critical path, each call is bounded by push_timeout_s, and the loop spans at most ClusterCacheReplicas (default 1) successors per batch — concurrency here would buy nothing and cost a thread per replica
                metrics.inc("repl.pushes", len(items))
                now = time.monotonic()
                for _n, _z, _s, t0 in items:
                    metrics.observe("repl.push_lag_s", now - t0)
            except (OSError, RPCError, Exception):
                metrics.inc("repl.push_failures", len(items))
                log.warning("CacheSync push of %d entries to %s failed "
                            "(anti-entropy will heal)", len(items), target)
                self._drop_client(target)

    # -- replica install (both Cluster RPCs funnel here) ---------------------
    def install(self, entries: Optional[list]) -> Tuple[int, int]:
        """Install pushed entries through the dominance order; returns
        ``(installed, stale)``.  A stale push can never regress the
        replica — ``add`` rejects it and we count the proof."""
        installed = stale = 0
        for e in entries or []:
            try:
                nonce = bytes(e["nonce"])
                ntz = int(e["num_trailing_zeros"])
                secret = bytes(e["secret"])
            except (KeyError, TypeError, ValueError):
                log.warning("malformed replication entry dropped: %r", e)
                continue
            if self._cache.add(nonce, ntz, secret, trace=None):
                installed += 1
            else:
                stale += 1
        if installed:
            metrics.inc("repl.installs", installed)
        if stale:
            metrics.inc("repl.stale_drops", stale)
        return installed, stale

    # -- anti-entropy --------------------------------------------------------
    def _replicated_to(self, peer: str) -> List[Tuple[bytes, int, bytes]]:
        """Entries THIS member owns whose successor set includes
        ``peer`` — the exact set ``peer`` is supposed to replicate.
        The digest responder applies the mirror-image filter, so both
        reconciliation sides digest the same intended set."""
        with self._lock:
            state = self._state
        if state is None:
            return []
        ring, me = state.ring, state.self_id
        return [
            (n, z, s) for n, z, s in self._cache.entries_snapshot()
            if ring.owner(n) == me
            and peer in ring.ordered(n)[1:1 + self.replicas]
        ]

    def digests_for(self, requester: str, n_buckets: int) -> List[List[int]]:
        """Responder half of the digest exchange: summarize the entries
        this member holds that ``requester`` owns and that the ring
        says should be replicated HERE."""
        with self._lock:
            state = self._state
        if state is None:
            return []
        ring, me = state.ring, state.self_id
        n_buckets = max(1, min(int(n_buckets), 4096))
        held = [
            (n, z, s) for n, z, s in self._cache.entries_snapshot()
            if ring.owner(n) == requester
            and me in ring.ordered(n)[1:1 + self.replicas]
        ]
        return range_digests(held, ring, n_buckets)

    def _antientropy_loop(self) -> None:
        while not self._stop.wait(self.antientropy_s):
            try:
                self.antientropy_sweep()
            except Exception:
                log.exception("anti-entropy sweep failed; next interval "
                              "retries")

    def antientropy_sweep(self) -> int:
        """One reconciliation pass against every successor; returns the
        number of entries pushed to heal divergence.  Public so tests
        and operators can force a sweep without waiting the interval."""
        with self._lock:
            state = self._state
        if (state is None or self.replicas <= 0
                or len(state.ring.members) < 2):
            return 0
        ring, me = state.ring, state.self_id
        healed = 0
        peers = [m for m in ring.member_ids() if m != me]
        for peer in peers:
            mine = self._replicated_to(peer)
            if not mine:
                continue
            local = range_digests(mine, ring, self.digest_buckets)
            try:
                client = self._client(peer, ring.addr_of(peer))
                reply = client.call("Cluster.CacheSync",
                                    {"digest": self.digest_buckets,
                                     "self": me},
                                    timeout=self.push_timeout_s)  # distpow: ok serial-rpc-fanout -- deliberately serial: the anti-entropy loop is a slow BACKGROUND reconciliation (ClusterAntiEntropyS cadence), each digest exchange is bounded by push_timeout_s, and the loop spans the pool's other members (small by construction) — serializing it is the bandwidth bound the design wants
            except (OSError, RPCError, Exception):
                log.warning("anti-entropy digest exchange with %s failed; "
                            "next sweep retries", peer)
                self._drop_client(peer)
                continue
            remote = reply.get("digest") or []
            diverged = {
                i for i in range(self.digest_buckets)
                if list(local[i]) != list(
                    remote[i] if i < len(remote) else [0, 0, 0])
            }
            if not diverged:
                continue
            to_push = [
                (n, z, s) for n, z, s in mine
                if ((ring.key_point(n) * self.digest_buckets) >> 64)
                in diverged
            ][:self.antientropy_max_entries]
            if not to_push:
                continue
            entries = [entry_wire(n, z, s) for n, z, s in to_push]
            try:
                client.call("Cluster.CacheSync",
                            {"entries": entries, "self": me},
                            timeout=self.push_timeout_s)  # distpow: ok serial-rpc-fanout -- same bounded background loop as the digest exchange above: one capped (antientropy_max_entries) heal push per diverged peer per sweep
            except (OSError, RPCError, Exception):
                log.warning("anti-entropy heal push to %s failed; next "
                            "sweep retries", peer)
                self._drop_client(peer)
                continue
            metrics.inc("repl.pushes", len(to_push))
            healed += len(to_push)
            RECORDER.record("repl.antientropy_heal", peer=peer,
                            entries=len(to_push),
                            buckets=len(diverged))
            log.info("anti-entropy healed %d entries (%d ranges) to %s",
                     len(to_push), len(diverged), peer)
        metrics.inc("repl.antientropy_rounds")
        return healed

    # -- warm shard handoff --------------------------------------------------
    def handoff(self, old_ring: HashRing, new_ring: HashRing,
                deadline_s: Optional[float] = None) -> dict:
        """Push the remapped ranges' entries to their new owners BEFORE
        the ring change is acked (docs/CLUSTER.md "Replication & HA").

        Exactly the entries whose old-ring owner is this member and
        whose new-ring owner is someone else move — nothing else
        (tests/test_cluster.py property tests).  One sender thread per
        target under ONE shared deadline: a frozen recipient burns its
        own thread's slice of the deadline, never the ring change.
        Whatever the deadline cuts off, anti-entropy backfills.
        """
        with self._lock:
            state = self._state
        me = state.self_id if state is not None else None
        if me is None:
            return {"keys": 0, "expected": 0, "targets": 0,
                    "complete": True}
        deadline_s = (self.handoff_deadline_s if deadline_s is None
                      else float(deadline_s))
        moved: Dict[str, list] = {}
        for n, z, s in self._cache.entries_snapshot():
            if old_ring.owner(n) != me:
                continue
            new_owner = new_ring.owner(n)
            if new_owner != me:
                moved.setdefault(new_owner, []).append((n, z, s))
        expected = sum(len(v) for v in moved.values())
        if not moved:
            return {"keys": 0, "expected": 0, "targets": 0,
                    "complete": True}
        t0 = time.monotonic()
        deadline = t0 + deadline_s
        results: Dict[str, Tuple[int, bool]] = {}
        senders = []
        for target, entries in sorted(moved.items()):
            t = threading.Thread(
                target=self._handoff_to,
                args=(target, new_ring.addr_of(target), entries,
                      deadline, results),
                daemon=True, name=f"repl-handoff-{target}",
            )  # distpow: ok unbounded-thread-spawn -- bounded: one spawn per NEW owner of a remapped range (<= pool size, a handful), and every sender self-terminates at the shared handoff deadline — per-target threads are exactly how a frozen recipient is kept from serializing the other targets' handoffs
            t.start()
            senders.append(t)
        for t in senders:
            t.join(timeout=max(0.0, deadline - time.monotonic()) + 1.0)
        pushed = sum(k for k, _ok in results.values())
        complete = (len(results) == len(moved)
                    and all(ok for _k, ok in results.values()))
        dur = time.monotonic() - t0
        metrics.observe("repl.handoff_s", dur)
        RECORDER.record("repl.handoff", keys=pushed, expected=expected,
                        targets=len(moved), complete=complete,
                        dur_s=round(dur, 6))
        log.info("warm handoff: %d/%d keys to %d new owner(s) in %.3fs "
                 "(complete=%s)", pushed, expected, len(moved), dur,
                 complete)
        return {"keys": pushed, "expected": expected,
                "targets": len(moved), "complete": complete}

    def _handoff_to(self, target: str, addr: Optional[str], entries: list,
                    deadline: float, results: dict) -> None:
        with self._lock:
            state = self._state
        me = state.self_id if state is not None else "?"
        pushed, ok = 0, True
        client: Optional[RPCClient] = None
        try:
            if addr is None:
                results[target] = (0, False)
                return
            for i in range(0, len(entries), HANDOFF_CHUNK):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    ok = False
                    log.warning("handoff to %s hit the deadline with "
                                "%d/%d keys sent (anti-entropy heals "
                                "the rest)", target, pushed, len(entries))
                    break
                chunk = entries[i:i + HANDOFF_CHUNK]
                try:
                    if client is None:
                        client = RPCClient(addr,
                                           timeout=min(remaining, 5.0))
                    client.call(
                        "Cluster.Handoff",
                        {"entries": [entry_wire(n, z, s)
                                     for n, z, s in chunk],
                         "self": me},
                        timeout=remaining,
                    )
                except (OSError, RPCError, Exception):
                    ok = False
                    log.warning("handoff chunk to %s failed at %d/%d "
                                "keys (anti-entropy heals the rest)",
                                target, pushed, len(entries))
                    break
                pushed += len(chunk)
                metrics.inc("repl.handoff_keys", len(chunk))
            results[target] = (pushed, ok and pushed == len(entries))
        finally:
            if client is not None:
                client.close()

    # -- peer clients --------------------------------------------------------
    def _client(self, member: str, addr: Optional[str]) -> RPCClient:
        if addr is None:
            raise OSError(f"member {member!r} has no ring address")
        with self._lock:
            cached = self._clients.get(member)
            if cached is not None and cached[0] == addr:
                return cached[1]
        fresh = RPCClient(addr, timeout=self.push_timeout_s)
        stale: Optional[RPCClient] = None
        with self._lock:
            cached = self._clients.get(member)
            if cached is not None:
                stale = cached[1]
            self._clients[member] = (addr, fresh)
        if stale is not None:
            stale.close()
        return fresh

    def _drop_client(self, member: str) -> None:
        with self._lock:
            cached = self._clients.pop(member, None)
        if cached is not None:
            cached[1].close()

    # -- introspection -------------------------------------------------------
    def stats_view(self) -> dict:
        """Small JSON-able state block for the Stats snapshot."""
        return {
            "replicas": self.replicas,
            "queue_depth": self._q.qsize(),
            "antientropy_s": self.antientropy_s,
            "handoff_deadline_s": self.handoff_deadline_s,
        }
