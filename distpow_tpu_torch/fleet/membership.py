"""Coordinator-side lease registry + the ``Fleet`` RPC service.

Membership model (docs/FLEET.md "Lease protocol"):

* **Static workers** (the config-file ``Workers`` list) boot as
  pre-registered PERMANENT leases — no heartbeats, never expired, never
  hedge-stale.  A static-only fleet behaves byte-identically to every
  earlier version of this repo.
* **Elastic workers** call ``Fleet.Register`` with their reachable RPC
  address and a :class:`..fleet.capability.Capability`; the reply
  carries a lease id, the lease TTL and a heartbeat-interval hint.
  They renew via ``Fleet.Heartbeat`` — whose ARRIVAL CADENCE is the
  progress signal straggler hedging keys off (no payload beyond the
  lease id) — leave via ``Fleet.Drain`` (the
  lease is released only once their in-flight rounds complete), and a
  lease that misses its TTL expires: the registry's reaper closes the
  worker's connection and removes it from membership, which drops it
  into the coordinator's existing ``_mark_dead``/``_reap_dead``
  orphan-reassignment path — a vanished worker is indistinguishable
  from a crashed one.
* A worker that lost its lease (SIGSTOP'd past the TTL, network
  partition) re-registers under the SAME worker id: the stale entry is
  retired first, so recovery cannot double-assign shards to a zombie
  twin of itself.

Every transition emits a flight-recorder event and ticks the declared
``fleet.*`` metrics (runtime/metrics.py; docs/METRICS.md).

Shard planning: :meth:`FleetRegistry.round_plan` snapshots the
in-service refs and — when every member advertises a measured rate and
the rates differ — attaches the capability-weighted prefix split
(parallel/partition.py ``weighted_ranges``) as per-shard explicit
``(tb_lo, tb_count)`` ranges; otherwise the plan is the reference
``worker_byte``/``worker_bits`` algebra, wire-identical to before.

The port's own copy of the reference's ``fleet/membership.py``
(``distpow_tpu/fleet/membership.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import secrets
import statistics
import threading
import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

from ..parallel import partition
from ..runtime.metrics import REGISTRY as metrics
from ..runtime.spans import SPANS
from ..runtime.telemetry import RECORDER
from .capability import Capability

if TYPE_CHECKING:  # runtime import would be circular (nodes -> fleet)
    from ..nodes.coordinator import WorkerRef


class WorkerLease:
    """One member's lease state (guarded by the registry lock — the
    mutable fields below carry ``# guarded-by`` declarations, so
    distpow-lint enforces what this docstring used to merely say:
    docs/CONCURRENCY.md)."""

    __slots__ = ("lease_id", "worker_id", "ttl_s", "permanent", "state",
                 "last_beat", "registered_at", "beat_ema_s", "capability")

    def __init__(self, worker_id: str, ttl_s: float, permanent: bool,
                 capability: Optional[Capability] = None) -> None:
        self.lease_id = secrets.token_hex(8)
        self.worker_id = worker_id
        self.ttl_s = float(ttl_s)
        self.permanent = bool(permanent)
        self.state = "live"  # live | draining; guarded-by: registry._lock
        self.last_beat = time.monotonic()  # guarded-by: registry._lock
        self.registered_at = self.last_beat
        #: observed heartbeat cadence (EMA); None until two beats landed
        self.beat_ema_s: Optional[float] = None  # guarded-by: registry._lock
        self.capability = capability

    def beat(self) -> None:
        now = time.monotonic()
        interval = now - self.last_beat
        if interval > 0:
            self.beat_ema_s = (interval if self.beat_ema_s is None
                               else 0.7 * self.beat_ema_s + 0.3 * interval)
        self.last_beat = now

    def expired(self, now: float) -> bool:
        # a DRAINING lease never expires: the agent stops heartbeating
        # before it issues Fleet.Drain, so a drain outlasting the TTL
        # would otherwise be expired mid-drain — crashing out the exact
        # worker the graceful path is finishing (and double-counting
        # the departure).  Safe from leaks: "draining" is only ever set
        # by drain(), whose bounded server-side wait ALWAYS releases
        # the lease within its timeout, worker fate notwithstanding.
        return (not self.permanent and self.state != "draining"
                and (now - self.last_beat) > self.ttl_s)

    def beat_age(self, now: float) -> Optional[float]:
        return None if self.permanent else now - self.last_beat

    def to_wire(self, now: float) -> dict:
        out = {
            "worker_id": self.worker_id,
            "state": self.state,
            "permanent": self.permanent,
            "ttl_s": self.ttl_s,
            "age_s": round(now - self.registered_at, 3),
        }
        if not self.permanent:
            out["beat_age_s"] = round(now - self.last_beat, 3)
        if self.capability is not None:
            out["capability"] = self.capability.to_wire()
        return out


class RoundPlan:
    """One fan-out round's shard layout: a snapshot of the in-service
    workers plus (optionally) explicit weighted byte ranges per shard.
    Round-local and mutable — hedging appends duplicate placements."""

    __slots__ = ("entries", "worker_bits", "ranges")

    def __init__(self, entries: List[tuple], worker_bits: int,
                 ranges: Optional[Dict[int, Tuple[int, int]]]) -> None:
        #: ``[(WorkerRef, shard_id), ...]`` — shard_id doubles as the
        #: wire ``worker_byte`` (the partition travels in the RPC, so a
        #: foreign shard on a reassigned/hedged worker is routine)
        self.entries = entries
        self.worker_bits = worker_bits
        #: shard_id -> (tb_lo, tb_count); None = reference algebra
        self.ranges = ranges

    def mine_extra(self, shard: int) -> dict:
        """Per-shard Mine params beyond the reference set: the explicit
        weighted byte range, when this plan carries one."""
        if self.ranges is None:
            return {}
        rng = self.ranges.get(shard)
        if rng is None:
            return {}
        return {"tb_lo": rng[0], "tb_count": rng[1]}


class FleetRegistry:
    """Lease table + round planner.  Owns the coordinator's mutable
    ``WorkerRef`` list (the handler's ``self.workers`` IS this list);
    every mutation happens under the registry lock, and round-scoped
    consumers always work from snapshots."""

    #: reaper cadence = max(ttl/4, floor); one bounded daemon thread
    REAP_FLOOR_S = 0.25

    def __init__(self, refs: List[object], lease_ttl_s: float = 10.0,
                 hedge: bool = True, hedge_multiple: float = 3.0,
                 on_expire: Optional[Callable[[object], None]] = None,
                 make_ref: Optional[Callable[[str, int], object]] = None) -> None:
        self._lock = threading.Lock()
        #: shared with CoordRPCHandler.workers
        self.refs: List["WorkerRef"] = refs
        self.lease_ttl_s = float(lease_ttl_s)
        self.hedge_enabled = bool(hedge)
        self.hedge_multiple = float(hedge_multiple)
        self._on_expire = on_expire
        self._make_ref = make_ref
        self._by_lease: Dict[str, "WorkerRef"] = {}
        self._next_byte = len(refs)
        self._reaper: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # static config workers: pre-registered permanent leases
        # (indexed like any other lease, so a misdirected Drain against
        # one earns the typed static-workers-cannot-drain rejection,
        # not an unknown-lease error)
        with self._lock:
            for ref in refs:
                ref.lease = WorkerLease(
                    worker_id=f"static{ref.worker_byte}",
                    ttl_s=self.lease_ttl_s, permanent=True,
                )
                ref.inflight_rounds = 0
                self._by_lease[ref.lease.lease_id] = ref
            self._publish_gauge_locked()

    # -- gauges / helpers ---------------------------------------------------
    def _publish_gauge_locked(self) -> None:
        live = sum(1 for r in self.refs
                   if r.lease is not None and r.lease.state == "live")
        metrics.gauge("fleet.live_workers", live)

    def _in_service(self, ref: "WorkerRef") -> bool:
        lease = getattr(ref, "lease", None)
        return lease is not None and lease.state == "live"

    def in_service(self, ref: "WorkerRef") -> bool:
        with self._lock:
            return self._in_service(ref)

    # -- registration / heartbeat / drain -----------------------------------
    def register(self, worker_id: str, addr: str,
                 capability: Capability) -> dict:
        """Admit (or re-admit) one elastic worker; returns the lease
        grant.  A stale entry under the same worker id is retired first
        — SIGSTOP recovery must not leave a zombie twin that still owns
        (and double-assigns) first-byte space."""
        if not worker_id or not addr:
            raise ValueError("Register needs worker_id and addr")
        retired = None
        with self._lock:
            for ref in list(self.refs):
                lease = getattr(ref, "lease", None)
                if lease is not None and not lease.permanent and \
                        lease.worker_id == worker_id:
                    retired = ref
                    self.refs.remove(ref)
                    self._by_lease.pop(lease.lease_id, None)
            ref = self._make_ref(addr, self._next_byte)
            self._next_byte += 1
            lease = WorkerLease(worker_id=worker_id, ttl_s=self.lease_ttl_s,
                                permanent=False, capability=capability)
            ref.lease = lease
            ref.inflight_rounds = 0
            self.refs.append(ref)
            self._by_lease[lease.lease_id] = ref
            self._publish_gauge_locked()
        if retired is not None and self._on_expire is not None:
            # the replaced entry's connection must not linger half-dead
            self._on_expire(retired)
        metrics.inc("fleet.joins")
        RECORDER.record("fleet.join", worker_id=worker_id, addr=addr,
                        rejoin=retired is not None,
                        mhs=capability.mhs, backend=capability.backend,
                        lease_ttl_s=self.lease_ttl_s)
        self._ensure_reaper()
        return {
            "lease_id": lease.lease_id,
            "ttl_s": self.lease_ttl_s,
            # the hint elastic workers without an explicit config beat
            # at: 3 beats per TTL keeps one lost heartbeat survivable
            "heartbeat_s": round(self.lease_ttl_s / 3.0, 3),
        }

    def heartbeat(self, lease_id: str) -> dict:
        with self._lock:
            ref = self._by_lease.get(lease_id)
            if ref is None or ref.lease is None or \
                    ref.lease.lease_id != lease_id:
                # the agent treats this as "lease lost: re-register" —
                # the SIGSTOP-recovery path (module docstring)
                raise KeyError(f"unknown lease {lease_id!r}")
            ref.lease.beat()
            state = ref.lease.state
        return {"ok": True, "state": state, "ttl_s": self.lease_ttl_s}

    def drain(self, lease_id: str, timeout_s: float = 20.0) -> dict:
        """Graceful leave: mark the member draining (no new shards, no
        hedge duplicates land on it), wait — bounded — for its in-flight
        rounds to finish, then release the lease.  The worker keeps
        serving its current shards throughout, so a drain mid-round
        completes the shard instead of orphaning it."""
        with self._lock:
            ref = self._by_lease.get(lease_id)
            if ref is None or ref.lease is None:
                raise KeyError(f"unknown lease {lease_id!r}")
            if ref.lease.permanent:
                raise ValueError("static workers cannot drain "
                                 "(remove them from the config instead)")
            ref.lease.state = "draining"
            self._publish_gauge_locked()
        RECORDER.record("fleet.drain_begin",
                        worker_id=ref.lease.worker_id,
                        inflight_rounds=ref.inflight_rounds)
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while time.monotonic() < deadline:
            with self._lock:
                pending = ref.inflight_rounds
            if pending <= 0:
                break
            time.sleep(0.05)
        with self._lock:
            pending = ref.inflight_rounds
            if ref in self.refs:
                self.refs.remove(ref)
            self._by_lease.pop(lease_id, None)
            self._publish_gauge_locked()
        if self._on_expire is not None:
            self._on_expire(ref)
        metrics.inc("fleet.drains")
        RECORDER.record("fleet.drain", worker_id=ref.lease.worker_id,
                        drained=pending <= 0, pending_rounds=pending)
        return {"drained": pending <= 0, "pending_rounds": pending}

    # -- expiry -------------------------------------------------------------
    def _ensure_reaper(self) -> None:
        with self._lock:
            if self._reaper is not None and self._reaper.is_alive():
                return
            interval = max(self.REAP_FLOOR_S, self.lease_ttl_s / 4.0)
            self._reaper = threading.Thread(
                target=self._reap_loop, args=(interval,), daemon=True,
                name="fleet-reaper",
            )
            self._reaper.start()

    def _reap_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.expire_stale()

    def expire_stale(self, now: Optional[float] = None) -> List[object]:
        """Retire every lease past its TTL; feeds each retired ref to
        ``on_expire`` (the coordinator's ``_mark_dead``) so a vanished
        worker joins the same orphan-reassignment path a crashed one
        does.  Returns the retired refs (tests and the bench poll it)."""
        now = time.monotonic() if now is None else now
        # beat ages snapshot INSIDE the lock with the expiry decision:
        # last_beat is written by heartbeat() on RPC handler threads,
        # and the old bare reads below the critical section raced it
        expired: List[Tuple[object, float]] = []
        with self._lock:
            for ref in list(self.refs):
                lease = getattr(ref, "lease", None)
                if lease is not None and lease.expired(now):
                    expired.append((ref, round(now - lease.last_beat, 3)))
                    self.refs.remove(ref)
                    self._by_lease.pop(lease.lease_id, None)
            if expired:
                self._publish_gauge_locked()
        for ref, beat_age_s in expired:
            metrics.inc("fleet.lease_expiries")
            RECORDER.record("fleet.lease_expiry",
                            worker_id=ref.lease.worker_id,
                            beat_age_s=beat_age_s,
                            ttl_s=ref.lease.ttl_s)
            # fleet-scoped forensics marker (docs/FORENSICS.md): no
            # request in scope on the reaper thread, so this records
            # under trace 0 — visible in the ring and in dumps, and the
            # orphaned shards' reassignment shows up per-trace via the
            # coord.reassign spans the next probe cycle mints
            SPANS.event("fleet.lease_expiry", trace_id=0,
                        worker_id=ref.lease.worker_id,
                        worker_byte=getattr(ref, "worker_byte", None),
                        beat_age_s=beat_age_s)
            if self._on_expire is not None:
                self._on_expire(ref)
        return [ref for ref, _ in expired]

    # -- round planning -----------------------------------------------------
    def round_plan(self) -> RoundPlan:
        """Snapshot the in-service members into one round's shard plan.

        Weighted ranges attach only when EVERY member advertises a
        measured rate and the rates differ — any unknown (static
        workers advertise none) keeps the whole round on the reference
        equal split, because mixing measured MH/s with guesses would
        skew shares by an uncalibrated constant.
        """
        with self._lock:
            refs = [r for r in self.refs if self._in_service(r)]
        n = len(refs)
        if n == 0:
            return RoundPlan([], 0, None)
        bits = partition.worker_bits(n)
        weights = []
        for r in refs:
            cap = r.lease.capability if r.lease is not None else None
            weights.append(cap.mhs if cap is not None and cap.mhs > 0
                           else None)
        ranges = None
        if n <= 256 and all(w is not None for w in weights) and \
                len(set(weights)) > 1:
            ranges = {i: rng
                      for i, rng in enumerate(partition.weighted_ranges(
                          [float(w) for w in weights]))}
        return RoundPlan([(r, i) for i, r in enumerate(refs)], bits, ranges)

    def track_round(self, refs: List[object], delta: int) -> None:
        """Round-level in-flight accounting (drain waits on it): +1 per
        distinct ref at fan-out, -1 when the round ends."""
        with self._lock:
            for ref in {id(r): r for r in refs}.values():
                ref.inflight_rounds = max(
                    0, getattr(ref, "inflight_rounds", 0) + delta)

    # -- straggler signals --------------------------------------------------
    def median_beat_interval(self) -> float:
        """Median observed heartbeat cadence across heartbeat leases —
        the fleet's "progress interval" straggler hedging multiplies.
        Falls back to the TTL-derived hint while cadences are still
        unobserved."""
        with self._lock:
            obs = [r.lease.beat_ema_s for r in self.refs
                   if r.lease is not None and not r.lease.permanent
                   and r.lease.beat_ema_s is not None]
        if not obs:
            return self.lease_ttl_s / 3.0
        return statistics.median(obs)

    def hedge_after_s(self) -> float:
        return self.hedge_multiple * self.median_beat_interval()

    def is_stale(self, ref: "WorkerRef",
                 threshold_s: Optional[float] = None) -> bool:
        """True when a HEARTBEAT member has not reported for longer
        than ``threshold_s`` (default: the hedge threshold).  Permanent
        leases never heartbeat, so they are never stale — static fleets
        keep their probe-based failure detection unchanged.

        The beat clock is read under the registry lock: ``last_beat``
        is written by ``heartbeat()`` on RPC handler threads, and the
        bare read here raced it (``test_is_stale_reads_beat_clock_under_
        registry_lock`` pins the discipline).
        ``hedge_after_s()`` re-takes the lock, so it must stay outside
        the critical section."""
        with self._lock:
            lease = getattr(ref, "lease", None)
            if lease is None or lease.permanent:
                return False
            age = lease.beat_age(time.monotonic())
        t = self.hedge_after_s() if threshold_s is None else threshold_s
        return age is not None and age > t

    # -- views --------------------------------------------------------------
    def members(self) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            out = []
            for ref in self.refs:
                lease = getattr(ref, "lease", None)
                row = {"addr": ref.addr, "worker_byte": ref.worker_byte,
                       "connected": ref.client is not None,
                       "inflight_rounds": getattr(ref, "inflight_rounds", 0)}
                if lease is not None:
                    row.update(lease.to_wire(now))
                out.append(row)
        return out

    def close(self) -> None:
        self._stop.set()


class FleetService:
    """The ``Fleet`` RPC service the coordinator registers on both its
    listeners (runtime/rpc.py dispatch): thin translation between wire
    params and the registry."""

    def __init__(self, registry: FleetRegistry,
                 drain_timeout_s: float = 20.0) -> None:
        self._registry = registry
        self._drain_timeout_s = float(drain_timeout_s)

    def Register(self, params: dict) -> dict:
        cap = Capability.from_wire(params.get("capability"))
        return self._registry.register(
            str(params.get("worker_id") or ""),
            str(params.get("addr") or ""),
            cap,
        )

    def Heartbeat(self, params: dict) -> dict:
        return self._registry.heartbeat(str(params.get("lease_id") or ""))

    def Drain(self, params: dict) -> dict:
        # the wait bound is CLAMPED by the coordinator's own configured
        # ceiling: the TTL exemption for draining leases (expired())
        # holds only because this wait provably releases — a
        # client-supplied timeout must not be able to pin a lease and a
        # dispatch thread for a mistyped day
        timeout = params.get("timeout_s")
        if timeout is None:
            timeout = self._drain_timeout_s
        else:
            timeout = min(float(timeout), self._drain_timeout_s)
        return self._registry.drain(
            str(params.get("lease_id") or ""), timeout_s=timeout,
        )

    def Members(self, params: dict) -> dict:
        return {"workers": self._registry.members(),
                "lease_ttl_s": self._registry.lease_ttl_s,
                "hedge": self._registry.hedge_enabled}
