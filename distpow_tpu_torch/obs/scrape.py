"""Fleet scraper — every node's ``Stats`` RPC, one shared deadline.

A sweep that dials and calls N nodes one after another costs
O(N x RTT) and lets ONE frozen node (SIGSTOP'd, half-crashed,
black-holed — TCP accepted, nothing answers) stall the whole cluster
view for its full timeout.  Here every node is polled concurrently —
per-node poll threads issue their dial plus a ``RPCClient.go()`` Stats
future, all bounded by one shared sweep deadline — and a node that
misses the deadline is marked ``stale`` with its last-seen age while
its LAST-KNOWN snapshot keeps contributing to the merged view (flagged,
never silently fresh).  The sweep itself always completes within
~``deadline_s``.

Connections are dialed lazily and kept across sweeps, so the wire-v2
negotiation runs once per node, not once per poll, and repeat sweeps
ride the binary codec.  A failed poll tears its connection down; the
next sweep re-dials.

The port's own copy of the reference's ``obs/scrape.py``.  The targets
may be either package's nodes: ``Node.Stats``, ``CoordRPCHandler.Stats``
and ``WorkerRPCHandler.Stats`` answer alike on the wire.

Consumers: ``cli/stats.py --cluster``, ``cli/slo.py``, the load
harness (``load/harness.py``) and the soak (``load/soak.py``).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..runtime.metrics import REGISTRY as metrics
from ..runtime.rpc import RPCClient, RPCError
from ..runtime.telemetry import RECORDER

#: Stats service names per role; "auto" resolves on first contact and
#: the resolved service is cached on the target state.  Auto tries the
#: role-agnostic ``Node.Stats`` alias FIRST — every current node
#: answers it, so discovery is error-free; the role-specific fallbacks
#: cover pre-alias nodes at the cost of one unknown-method error
#: (``rpc.handler_errors`` on the probed node) on first contact.
_SERVICES = {
    "coordinator": ("CoordRPCHandler.Stats",),
    "worker": ("WorkerRPCHandler.Stats",),
    "auto": ("Node.Stats", "CoordRPCHandler.Stats",
             "WorkerRPCHandler.Stats"),
}


@dataclass
class NodeTarget:
    """One scrape target.  ``name`` labels the node in merged output
    (defaults to the address); ``role`` picks the Stats service."""

    addr: str
    name: str = ""
    role: str = "auto"

    def __post_init__(self) -> None:
        if not self.name:
            self.name = self.addr
        if self.role not in _SERVICES:
            raise ValueError(f"unknown scrape role {self.role!r}")


@dataclass
class _NodeState:
    """Mutable per-target scrape state (guarded by the scraper lock)."""

    target: NodeTarget
    client: Optional[RPCClient] = None
    service: Optional[str] = None  # resolved Stats method
    snapshot: Optional[dict] = None
    last_seen: Optional[float] = None  # monotonic, successful poll
    error: str = ""
    generation: int = 0  # sweep id of the freshest successful poll
    lock: threading.Lock = field(default_factory=threading.Lock)


class FleetScraper:
    """Concurrent Stats sweeps over a fixed node set (module docstring).

    ``sweep()`` returns the merged cluster snapshot
    (:func:`..obs.merge.merge_snapshots` shape) with per-node
    ``status``/``age_s`` riding in ``per_node``.
    """

    def __init__(self, targets: List[NodeTarget], deadline_s: float = 5.0,
                 dial_timeout_s: float = 2.0):
        if not targets:
            raise ValueError("FleetScraper needs at least one target")
        names = [t.name for t in targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate target names: {sorted(names)}")
        self.deadline_s = float(deadline_s)
        self.dial_timeout_s = float(dial_timeout_s)
        self._states = {t.name: _NodeState(t) for t in targets}
        self._sweep_n = 0

    # -- one node -----------------------------------------------------------
    def _poll_one(self, st: _NodeState, deadline: float, gen: int) -> None:
        """Dial (if needed) and call Stats, bounded by the shared sweep
        deadline.  Runs on its own thread; a poll that outlives the
        deadline is abandoned by the sweep — if it succeeds later, its
        snapshot is kept for the NEXT sweep (a late write updates
        last-seen, never this sweep's already-rendered verdict)."""
        # one in-flight poll per node: a previous sweep's abandoned poll
        # may still own the client slot (e.g. wedged mid-dial against a
        # SIGSTOP'd peer) — bounded acquire, so this poll gives up at
        # the deadline instead of queueing behind it forever
        if not st.lock.acquire(timeout=max(0.0, deadline - time.monotonic())):
            st.error = "previous poll still in flight"
            metrics.inc("obs.scrape_failures")
            return
        try:
            # (acquire/release rather than `with`: the acquire above is
            # BOUNDED by the sweep deadline, and every blocking step in
            # here is too, so holding the per-node lock across the poll
            # is safe by construction)
            try:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("sweep deadline exhausted")
                client = st.client
                if client is None or client.dead:
                    client = RPCClient(
                        st.target.addr,
                        timeout=min(self.dial_timeout_s, remaining),
                    )
                    st.client = client
                snap: Optional[dict] = None
                last: Exception = RPCError("no Stats service answered")
                for method in ((st.service,) if st.service
                               else _SERVICES[st.target.role]):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("sweep deadline exhausted")
                    try:
                        snap = client.go(method, {}).result(timeout=remaining)
                        st.service = method
                        break
                    except (RPCError, FutureTimeout) as exc:
                        # FutureTimeout only aliases an OSError-derived
                        # builtin on 3.11+; catch it explicitly
                        last = exc
                        if client.dead:
                            raise
                if snap is None:
                    raise last
                st.snapshot = snap
                st.last_seen = time.monotonic()
                st.error = ""
                st.generation = max(st.generation, gen)
            except (OSError, RPCError, RuntimeError, TimeoutError,
                    FutureTimeout) as exc:
                st.error = f"{type(exc).__name__}: {exc}"
                metrics.inc("obs.scrape_failures")
                if st.client is not None:
                    try:
                        st.client.close()
                    except OSError:
                        pass
                    st.client = None
        finally:
            st.lock.release()

    # -- the sweep ----------------------------------------------------------
    def sweep(self, deadline_s: Optional[float] = None) -> dict:
        """Poll every target concurrently; merge what answered.

        Always returns within ~``deadline_s`` plus scheduling slack:
        nodes still pending at the deadline are reported ``stale`` with
        ``age_s`` since their last successful poll (``never_seen`` nodes
        carry ``age_s: null``) while their last-seen snapshot, if any,
        stays in the merge — flagged via ``per_node`` and
        ``stale_nodes``."""
        from .merge import merge_snapshots

        budget = self.deadline_s if deadline_s is None else float(deadline_s)
        deadline = time.monotonic() + budget
        self._sweep_n += 1
        gen = self._sweep_n
        metrics.inc("obs.scrapes")
        threads = []
        for st in self._states.values():
            t = threading.Thread(
                target=self._poll_one, args=(st, deadline, gen),
                name=f"obs-scrape-{st.target.name}", daemon=True,
            )
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()) + 0.25)
        with metrics.time("obs.sweep_s"):
            # assembling the merged view is pure local compute, but the
            # histogram work is O(nodes x series) — worth a distribution
            now = time.monotonic()
            snaps: Dict[str, dict] = {}
            meta: Dict[str, dict] = {}
            for name, st in self._states.items():
                fresh = st.generation >= gen
                age = None if st.last_seen is None else \
                    round(now - st.last_seen, 3)
                m = {
                    "status": "ok" if fresh else "stale",
                    "age_s": 0.0 if fresh else age,
                    "addr": st.target.addr,
                }
                if not fresh:
                    m["error"] = st.error or "deadline"
                    RECORDER.record("obs.node_stale", node=name,
                                    addr=st.target.addr, age_s=age,
                                    error=m["error"])
                meta[name] = m
                if st.snapshot is not None:
                    snaps[name] = st.snapshot
            stale = {n: m for n, m in meta.items()}
            merged = merge_snapshots(snaps, stale)
            # targets that have NEVER answered contribute no snapshot but
            # must still be visible in the node table
            for name, m in meta.items():
                if name not in merged["per_node"]:
                    merged["per_node"][name] = dict(m, role="unknown")
                    if name not in merged["stale_nodes"]:
                        merged["stale_nodes"].append(name)
            merged["stale_nodes"] = sorted(merged["stale_nodes"])
            merged["deadline_s"] = budget
        return merged

    def last_snapshots(self) -> Dict[str, dict]:
        """Raw last-seen per-node snapshots (post-sweep; the single-node
        oracle side of merge cross-checks)."""
        return {name: dict(st.snapshot)
                for name, st in self._states.items()
                if st.snapshot is not None}

    def close(self) -> None:
        for st in self._states.values():
            c = st.client
            st.client = None
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass


def scrape_cluster(addrs: List[str], deadline_s: float = 5.0,
                   role: str = "auto") -> dict:
    """One-shot sweep over ``addrs`` (the ``stats --cluster`` path)."""
    scraper = FleetScraper(
        [NodeTarget(addr=a, role=role) for a in addrs],
        deadline_s=deadline_s,
    )
    try:
        return scraper.sweep()
    finally:
        scraper.close()
