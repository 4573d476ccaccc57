"""Coordinator node — the control plane (SURVEY.md section 2 component 3).

Implements the reference's orchestration spine (coordinator.go:139-298):

blocking ``Mine`` RPC:
  1. receive token, record ``CoordinatorMine``;
  2. dominance-cache lookup — on hit record ``CoordinatorSuccess`` and
     reply immediately (coordinator.go:150-166);
  3. on miss, ensure worker connections (dial-retry,
     coordinator.go:169-172,356-368), register a per-task result queue
     (capacity semantics of the 2N-buffered channel,
     coordinator.go:176-177);
  4. fan out ``WorkerRPCHandler.Mine`` to every worker with its partition
     byte (``CoordinatorWorkerMine`` per worker);
  5. block for the first result — first-result-wins;
  6. broadcast ``WorkerRPCHandler.Found`` with the winning secret to every
     worker (``CoordinatorWorkerCancel`` per worker) — cancellation and
     cache-install in one message;
  7. drain the 2N-ack ledger: every worker owes exactly two messages per
     round (finder: result + ACK; cancelled: ACK + ACK); late non-nil
     results are collected (coordinator.go:237-248);
  8. for each late result, re-broadcast ``Found`` (cache convergence) and
     drain N more ACKs (coordinator.go:250-280);
  9. delete the task, record ``CoordinatorSuccess``, reply with a fresh
     token.

``Result`` RPC (coordinator.go:302-320): non-nil secrets are recorded
(``CoordinatorWorkerResult``) and installed into the coordinator cache,
then the payload is routed to the owning task queue.

Documented fixes over the reference (SURVEY.md section 7 "hard parts"):

* late ``Result`` after task deletion: the reference sends on a nil
  channel and leaks the RPC goroutine forever (coordinator.go:318,
  370-374); here the message is logged and dropped.
* duplicate concurrent ``Mine`` for the same (nonce, zeros): the
  reference overwrites the task queue and strands the first request
  (coordinator.go:376-381); here a per-key mutex serializes the miss
  path — the duplicate blocks, then (re-)checks the cache and typically
  returns the first request's result as a hit.
* every fan-out round carries a fresh ``round`` id in its Mine/Found
  RPCs; workers echo it in their Results and the ``Result`` handler
  drops messages whose round doesn't match the live task entry.  The
  reference has no such tag, so a zombie miner from a superseded round
  (coordinator retry, worker falsely declared dead) can contaminate the
  new round's 2N-ack ledger — its queues are keyed by (nonce, zeros)
  only.  Dropped-not-counted closes that race end-to-end, including
  messages already in flight on the wire.

Fan-out concurrency (docs/RPC.md "Control-plane concurrency"):
the reference launches one goroutine per worker, and the rebuild used
to execute the same shape as N *sequential* blocking calls — round
start, the cancel storm, and abandoned-worker re-sync all cost
O(N x RTT), and one hung worker head-of-line-blocked the rest for a
full ``_call_timeout``.  ``_assign_shards`` and ``_broadcast_found``
now issue every worker RPC as a concurrent ``RPCClient.go()`` future
before awaiting any reply; under "reassign" the Mine acks are harvested
OFF the round's critical path (``_harvest_inflight``) so dead/hung
workers time out in parallel while live workers already mine, with the
orphan-reassignment and 2N-ack-ledger semantics unchanged — a shard
whose ack fails (or expires) is dropped from the ledgers and re-issued
exactly as a failed blocking call was.

The port's own copy of the reference's ``nodes/coordinator.py``
(``distpow_tpu/nodes/coordinator.py``):
it imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time
import zlib
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, List, Optional, Tuple

from ..cluster import ClusterService, ClusterState, NotOwnerError, \
    Replicator, ring_from_peers
from ..fleet.membership import (FleetRegistry, FleetService, RoundPlan,
                                WorkerLease)
from ..parallel.partition import worker_bits as partition_worker_bits
from ..runtime import actions as act
from ..runtime.cache import ResultCache
from ..runtime.metrics import REGISTRY as metrics
from ..runtime.config import CoordinatorConfig
from ..runtime.health import SENTINELS
from ..runtime.rpc import (
    RPCClient,
    RPCError,
    RPCServer,
    RPCTransportError,
    StatsOnly,
)
from ..runtime.spans import SPANS, SlowRequestTrigger
from ..runtime.telemetry import RECORDER
from ..runtime.tracing import Tracer, decode_token, make_tracer, wire_token
from ..sched.admission import AdmissionReject
from ..sched.coalesce import Coalescer

log = logging.getLogger("distpow.coordinator")

TaskKey = Tuple[bytes, int]

_last_round_ns = [0]
_round_id_lock = threading.Lock()


def _read_epoch_file(path: str) -> Optional[int]:
    """One epoch replica -> int, or None if missing/unreadable/corrupt.

    Format: ``<epoch> <crc32hex>`` — the checksum catches silent
    corruption (e.g. a truncated "17" parsing as a valid-but-tiny
    epoch).  Legacy bare-int files are accepted so an upgrade doesn't
    discard the persisted counter.
    """
    try:
        with open(path) as fh:
            raw = fh.read().strip()
    except OSError:
        return None
    try:
        parts = raw.split()
        if len(parts) == 2:
            if zlib.crc32(parts[0].encode()) != int(parts[1], 16):
                raise ValueError("checksum mismatch")
            return int(parts[0])
        # legacy bare-int acceptance is BOUNDED: every pre-checksum epoch
        # was floored by int(time.time()) at write, so a bare value below
        # that scale can only be a checksummed file truncated past its
        # separator (e.g. "1784... crc" torn to "17") — corrupt, not
        # legacy (an unbounded int(raw) would silently re-admit the
        # truncation class the checksum exists to catch)
        val = int(raw or "0")
        if val < 1_000_000_000:  # 2001-09-09; far below any real epoch
            raise ValueError(f"bare epoch {val} below the wall-clock "
                             f"floor every legacy write had")
        return val
    except ValueError as exc:
        log.warning("restart-epoch replica %s corrupt (%s): ignoring it",
                    path, exc)
        return None


def _write_epoch_file(path: str, epoch: int) -> None:
    body = f"{epoch} {zlib.crc32(str(epoch).encode()):08x}"
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        fh.write(body)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_restart_epoch(path: Optional[str]) -> int:
    """Read-increment-persist the coordinator's boot counter.

    Stored next to the cache journal (``<CacheFile>.epoch`` plus a
    ``.epoch.bak`` replica) so round-id ordering survives coordinator
    restarts REGARDLESS of wall-clock behavior (ordering by wall clock
    alone inverts if NTP steps the clock back further than the restart
    downtime, and a zombie round then out-orders the live one at the
    worker).  No path (no CacheFile
    configured) -> epoch 0, the pure wall-clock ordering.

    Durability: each replica is checksummed
    (``_read_epoch_file``), writes are atomic, and recovery takes the
    max over both replicas — so one lost/corrupt file costs nothing,
    and corruption is *detected*, never silently parsed.  The next
    epoch is ``max(persisted + 1, unix seconds)``: the wall-clock floor
    means losing BOTH replicas still cannot regress the epoch below
    previously-issued ids (those were themselves floored by an earlier
    ``time()``); only the triple fault of both replicas lost AND a
    backward clock step reintroduces the pre-epoch behavior, and that
    is logged loudly.
    """
    if not path:
        return 0
    replicas = (path, f"{path}.bak")
    vals = [v for v in (_read_epoch_file(p) for p in replicas)
            if v is not None]
    prev = max(vals, default=None)
    if prev is None and any(os.path.exists(p) for p in replicas):
        log.warning(
            "restart-epoch file %s unreadable in every replica: falling "
            "back to the wall-clock floor; round ordering vs pre-crash "
            "rounds now rides the clock", path,
        )
    epoch = max((prev or 0) + 1, int(time.time()))
    # primary first; the replica only after the primary landed, so a
    # crash between the two leaves at least one good copy of SOME epoch
    _write_epoch_file(path, epoch)
    _write_epoch_file(f"{path}.bak", epoch)
    return epoch


def new_round_id(epoch: int = 0, namespace: str = "") -> str:
    """Fan-out-round id: fixed-width hex, LEXICOGRAPHICALLY ordered by
    issue order.  Workers rely on the order to resolve a round mismatch:
    a Found tagged newer than the task-table entry proves the entry is a
    zombie, while an older Found is itself stale — random ids (uuid)
    cannot make that call and either choice then kills a live round or
    leaks a zombie.

    Ordering guarantee: the leading ``epoch`` (a persisted boot counter,
    ``load_restart_epoch``) strictly orders ids across coordinator
    restarts; within a process ``max(time_ns, last+1)`` is strictly
    monotonic even if the wall clock steps backward (NTP).  Coordinators
    without a CacheFile run at epoch 0 — there ordering across restarts
    degrades to wall clock (restarts are seconds apart, so only a
    backward step larger than the downtime could invert it).

    ``namespace`` (the coordinator pool — docs/CLUSTER.md): a pooled
    coordinator prefixes its ring member id (``"c1."``), because
    issue-order comparison is only meaningful WITHIN one coordinator's
    id stream — two pool members' clocks and epochs are unrelated, so
    a worker receiving rounds from both must never let one member's id
    fence the other's (nodes/worker.py ``_rid_split``).  Empty (single
    coordinator) keeps the id byte-identical to every earlier version.
    """
    with _round_id_lock:
        ns = max(time.time_ns(), _last_round_ns[0] + 1)
        _last_round_ns[0] = ns
    rid = f"{epoch:08x}{ns:016x}"
    return f"{namespace}.{rid}" if namespace else rid


class WorkerRef:
    def __init__(self, addr: str, worker_byte: int):
        self.addr = addr
        self.worker_byte = worker_byte
        self.client: Optional[RPCClient] = None
        # membership state (fleet/): static config workers
        # get a permanent lease at registry construction; elastic
        # workers a heartbeat lease at Fleet.Register
        self.lease: Optional[WorkerLease] = None
        self.inflight_rounds: int = 0


class CoordRPCHandler:
    """RPC service ``CoordRPCHandler`` (Mine / Result)."""

    def __init__(self, tracer: Tracer, worker_addrs: List[str],
                 dial_retry_interval: float = 0.2,
                 cache_file: Optional[str] = None,
                 failure_policy: str = "error",
                 failure_probe_secs: float = 1.0,
                 sched_max_inflight: int = 0,
                 sched_retry_after_s: float = 0.5,
                 sched_coalesce: bool = True,
                 lease_ttl_s: float = 10.0,
                 hedge: bool = True,
                 hedge_multiple: float = 3.0,
                 forensics_slow_s: float = 0.0,
                 forensics_p99x: float = 0.0):
        self.tracer = tracer
        self.workers = [WorkerRef(a, i) for i, a in enumerate(worker_addrs)]
        # floor(log2(N)) with the reference's uint truncation
        # (coordinator.go:326); see parallel/partition.py for the
        # non-power-of-two coverage discussion.  A coordinator may now
        # boot with ZERO static workers (pure-elastic fleet): the
        # per-round plan recomputes this from the live member count.
        self.worker_bits = (partition_worker_bits(len(worker_addrs))
                            if worker_addrs else 0)
        # lease-based membership plane (fleet/,
        # docs/FLEET.md): owns self.workers (static refs become
        # permanent leases; Fleet.Register appends heartbeat leases),
        # retires expired leases through _mark_dead so a vanished
        # worker rides the same orphan-reassignment path a crashed one
        # does, and plans each round's (possibly capability-weighted)
        # shard layout
        self.fleet = FleetRegistry(
            self.workers, lease_ttl_s=lease_ttl_s, hedge=hedge,
            hedge_multiple=hedge_multiple, on_expire=self._mark_dead,
            make_ref=WorkerRef,
        )
        self.result_cache = ResultCache(persist_path=cache_file or None)
        # persisted boot counter prefixing round ids: zombie-vs-live round
        # resolution at workers survives backward clock steps across
        # restarts (load_restart_epoch)
        self.restart_epoch = load_restart_epoch(
            f"{cache_file}.epoch" if cache_file else None
        )
        if failure_policy not in ("error", "reassign"):
            raise ValueError(f"unknown FailurePolicy {failure_policy!r}")
        self.failure_policy = failure_policy
        self.failure_probe_secs = failure_probe_secs
        # reassign mode bounds every worker RPC, so a hung-but-connected
        # worker is detected like a crashed one; error mode keeps the
        # reference's unbounded blocking calls
        self._call_timeout = 10.0 if failure_policy == "reassign" else None
        # key -> (round_id, queue); the round id tags one fan-out round's
        # RPCs so Result can drop stale messages (module docstring)
        self._tasks: Dict[TaskKey, Tuple[str, "queue.Queue"]] = {}
        self._tasks_lock = threading.Lock()
        self._key_locks: Dict[TaskKey, list] = {}
        self._dial_retry_interval = dial_retry_interval
        # scheduler plane (docs/SCHEDULER.md): in-flight coalescing of
        # identical keys + bounded-run-queue admission control.  The
        # admitted count is a reservation counter under _tasks_lock —
        # counting len(_tasks) instead would let concurrent leaders all
        # pass the check before any of them registers its task
        self._coalescer = Coalescer() if sched_coalesce else None
        self._sched_max_inflight = int(sched_max_inflight or 0)
        self._sched_retry_after_s = float(sched_retry_after_s)
        self._sched_inflight = 0
        # slow-request auto-capture (runtime/spans.py, docs/FORENSICS.md):
        # a completed miss past the fixed budget — or past the rolling
        # p99 exceedance — snapshots its span tree into the flight
        # recorder, so the forensic evidence exists by construction
        self._slow_trigger = SlowRequestTrigger(
            threshold_s=forensics_slow_s, p99_factor=forensics_p99x,
        )
        # coordinator pool membership (cluster/,
        # docs/CLUSTER.md): None = single coordinator, every code path
        # byte-identical to before.  Installed by set_cluster(); the
        # Mine handler then redirects misrouted keys (NOT_OWNER), round
        # ids gain this member's namespace, and Mine/Found frames carry
        # the reply-to address shared workers route Results back on.
        self.cluster: Optional[ClusterState] = None
        #: pool-mode replication engine (cluster/replication.py): every
        #: accepted cache install is offered for write-behind push to
        #: the key's ring successors.  None in single-coordinator mode
        #: — the Result path then runs byte-identical to before.
        self.replicator = None
        #: this coordinator's WORKER-facing address, stamped into
        #: cluster-mode Mine/Found params as ``coord_addr`` (set by
        #: Coordinator.initialize_rpcs once the listener is bound)
        self.reply_addr: str = ""

    def set_cluster(self, state: ClusterState) -> None:
        self.cluster = state

    # -- task table (coordinator.go:370-388) -------------------------------
    def _task_set(self, key: TaskKey, rid: str, q: "queue.Queue") -> None:
        with self._tasks_lock:
            self._tasks[key] = (rid, q)

    def _task_get(self, key: TaskKey) -> Optional[Tuple[str, "queue.Queue"]]:
        with self._tasks_lock:
            return self._tasks.get(key)

    def _task_delete(self, key: TaskKey) -> None:
        with self._tasks_lock:
            self._tasks.pop(key, None)

    @contextlib.contextmanager
    def _key_lock(self, key: TaskKey):
        """Hold the per-(nonce, zeros) mutex; entries are refcounted and
        pruned when the last waiter releases, so arbitrary client nonces
        can't grow the map without bound."""
        with self._tasks_lock:
            entry = self._key_locks.get(key)
            if entry is None:
                entry = self._key_locks[key] = [threading.Lock(), 0]
            entry[1] += 1
        try:
            with entry[0]:
                yield
        finally:
            with self._tasks_lock:
                entry[1] -= 1
                if entry[1] == 0 and self._key_locks.get(key) is entry:
                    del self._key_locks[key]

    # -- worker connections (coordinator.go:356-368) ------------------------
    def _initialize_workers(self) -> None:
        """Dial-retry until all workers reachable (reference parity).

        Under FailurePolicy="reassign" a permanently dead worker must not
        wedge every future request, so each missing worker gets one dial
        attempt and the protocol proceeds with the live subset.
        """
        reassign = self.failure_policy == "reassign"
        while True:
            # snapshot: Fleet.Register may append members concurrently;
            # draining/retired members are not (re-)dialed — they keep
            # whatever connection their in-flight rounds already hold
            pending = [w for w in list(self.workers)
                       if w.client is None and self.fleet.in_service(w)]
            if not pending:
                return
            for w in pending:
                try:
                    # reassign mode: a short connect timeout so one
                    # blackholed address can't stall every request for
                    # the 10s default
                    w.client = RPCClient(
                        w.addr, timeout=2.0 if reassign else 10.0
                    )
                except OSError as exc:
                    if reassign:
                        log.warning("worker %d unreachable: %s",
                                    w.worker_byte, exc)
                        continue
                    log.info("waiting for worker %d: %s", w.worker_byte, exc)
                    time.sleep(self._dial_retry_interval)
                    break
            else:
                return

    def _mark_dead(self, w: WorkerRef) -> None:
        """Drop a failed connection; the next request re-dials
        (recovered workers rejoin automatically)."""
        if w.client is not None:
            try:
                w.client.close()
            except OSError:
                pass
            w.client = None

    def _probe_dead(self, refs) -> List[WorkerRef]:
        """Liveness-check distinct workers; returns the dead ones."""
        dead = []
        for ref in {id(w): w for w in refs}.values():
            try:
                if ref.client is None:
                    raise OSError("not connected")
                # a hung worker counts as dead: bounded probe.
                # concurrent.futures.TimeoutError is caught explicitly —
                # it only aliases the OSError-derived builtin on 3.11+.
                # distpow: ok serial-rpc-fanout -- deliberately serial:
                # probes run only while the round is already parked in
                # results.get, each is bounded to 2 s, and serializing
                # them keeps the failure detector from stampeding a
                # cluster that is slow precisely because it is loaded
                ref.client.call("WorkerRPCHandler.Ping", {}, timeout=2.0)
            except (OSError, RPCError, RuntimeError, FutureTimeout) as exc:
                log.warning("worker %d failed probe: %s", ref.worker_byte, exc)
                self._mark_dead(ref)
                dead.append(ref)
        return dead

    def _reap_dead(self, tasks, ledgers):
        """Probe and prune dead workers' tasks; drops their entries from
        the given ledgers.  Returns (surviving_tasks, orphaned_shards)."""
        dead = self._probe_dead([w for w, _ in tasks])
        if not dead:
            return tasks, []
        dead_ids = {id(w) for w in dead}
        orphans = [s for w, s in tasks if id(w) in dead_ids]
        for ledger in ledgers:
            for s in orphans:
                ledger.pop(s, None)
        return [(w, s) for w, s in tasks if id(w) not in dead_ids], orphans

    def _issue_shards(self, trace, nonce: bytes, ntz: int, tasks, shards,
                      rid: str, model: Optional[str] = None,
                      plan: Optional[RoundPlan] = None):
        """Place each shard on some live worker; shards that cannot be
        placed right now stay pending for the next probe round (coverage
        is never silently dropped).  The plan supplies each shard's
        weighted byte range, so a reassigned shard covers the SAME
        space on its new owner."""
        pending: List[int] = []
        for i, shard in enumerate(shards):
            placed = False
            w = None
            while not placed:
                live = list({id(x): x for x, _ in tasks}.values())
                candidates = [x for x in live if x.client is not None]
                if not candidates:
                    break
                w = candidates[i % len(candidates)]
                placed = self._send_mine(trace, nonce, ntz, w, shard, rid,
                                         model, plan)
                # a failed send marked w dead; retry the rest
            if placed:
                tasks.append((w, shard))
                if w.worker_byte != shard:
                    metrics.inc("coord.reassigned_shards")
                    # reassignment marker on the request timeline: which
                    # shard moved where (docs/FORENSICS.md)
                    SPANS.event("coord.reassign", trace_id=trace.trace_id,
                                node=self.tracer.identity, round=rid,
                                shard=shard, to_byte=w.worker_byte)
            else:
                pending.append(shard)
        return tasks, pending

    # -- RPCs ---------------------------------------------------------------
    def Mine(self, params) -> dict:
        """Span-wrapped Mine (docs/FORENSICS.md): the whole RPC is one
        ``coord.mine`` span — path (hit/miss/coalesced-hit) and error
        outcomes included — keyed by the trace id the client's token
        already carries, so the forensics plane stitches this node's
        view into the request timeline with no new protocol state."""
        t0 = time.monotonic()
        ts0 = time.time()
        info: dict = {"path": "miss"}
        try:
            return self._mine_rpc(params, t0, info)
        except BaseException as exc:
            info.setdefault("outcome", f"error:{type(exc).__name__}")
            raise
        finally:
            tid = info.pop("trace_id", 0)
            if tid:
                SPANS.record("coord.mine", ts0, time.monotonic() - t0,
                             trace_id=tid, node=self.tracer.identity,
                             **info)

    def _mine_rpc(self, params, t0: float, info: dict) -> dict:
        metrics.inc("coord.mine_rpcs")
        nonce = bytes(params["nonce"])
        ntz = int(params["num_trailing_zeros"])
        # off-default hash model (docs/SERVING.md): forwarded to the
        # workers (whose Mine validates it against their serving set)
        # and excluded from the SINGLE-MODEL dominance cache on both
        # lookup and install — a cached default-model secret replayed
        # against another hash would fail verification.  None/"" keeps
        # every frame and every code path identical to plain traffic.
        model = params.get("hash_model") or None
        cl = self.cluster
        if cl is not None and not cl.owns(nonce):
            if params.get("no_redirect"):
                # a hedged sibling retry or a failover send (powlib,
                # docs/CLUSTER.md): serve the foreign key — the shared
                # worker fleet makes it correct; only the dominance
                # cache's locality pays
                metrics.inc("cluster.foreign_mines")
            else:
                # misrouted (stale client ring): the typed redirect
                # carries a fresh snapshot so the client re-routes in
                # one round trip.  Deliberately BEFORE the token is
                # received: the redirecting coordinator is not serving
                # this request, so it must not inject CoordinatorMine
                # into the trace the real owner will complete.
                owner = cl.ring.owner(nonce)
                metrics.inc("cluster.not_owner_redirects")
                RECORDER.record("cluster.not_owner", nonce=nonce.hex(),
                                ntz=ntz, owner=owner,
                                self_id=cl.self_id)
                info["outcome"] = "not_owner"
                raise NotOwnerError(owner, cl.ring.to_wire())
        trace = self.tracer.receive_token(decode_token(params["token"]))
        trace.record_action(
            act.CoordinatorMine(nonce=nonce, num_trailing_zeros=ntz)
        )
        tid = trace.trace_id
        info["trace_id"] = tid
        info["ntz"] = ntz

        cached = None if model else self.result_cache.get(nonce, ntz, trace)
        if cached is not None:
            info["path"] = "hit"
            metrics.observe("coord.mine_s.hit", time.monotonic() - t0,
                            trace_id=tid)
            return self._success_reply(trace, nonce, ntz, cached)

        key = (nonce, ntz)
        # attempts bound the waiter->leader promotion loop below; under
        # normal operation one pass suffices (the loop only re-enters
        # when a leader vanished without either a result or an error)
        for _ in range(4):
            handle = self._coalescer.join(key) if self._coalescer else None
            if handle is not None and not handle.leader:
                # in-flight coalescing (sched/coalesce.py): attach to
                # the live round as a waiter — one fan-out, N replies
                metrics.inc("sched.coalesced_requests")
                handle.wait()
                # an off-model waiter cannot be served from the leader's
                # (default-model) cache entry: skip the lookup and lead
                # its own round on the next pass.  The coalescer stays
                # keyed by (nonce, ntz) alone, so different-model
                # duplicates SERIALIZE rather than share a result.
                cached = None if model else self.result_cache.get(
                    nonce, ntz, trace)
                if cached is not None:
                    # same split rule as the key-lock era: a duplicate
                    # that waited out the leader's round is a hit
                    info["path"] = "hit"
                    info["coalesced"] = True
                    metrics.observe("coord.mine_s.hit",
                                    time.monotonic() - t0, trace_id=tid)
                    return self._success_reply(trace, nonce, ntz, cached)
                err = handle.error()
                if err is not None:
                    # the leader's typed failure applies to the whole
                    # round — fresh instances, so concurrent waiters
                    # never share one exception's traceback
                    if isinstance(err, AdmissionReject):
                        raise AdmissionReject(
                            err.retry_after_s, "coalesced round rejected"
                        )
                    raise RuntimeError(f"coalesced mine failed: {err}")
                continue  # leader vanished resultless: try leading
            err2: Optional[BaseException] = None
            try:
                # serialize concurrent identical requests (documented
                # fix; with coalescing on, only round leaders ever
                # contend here)
                with self._key_lock(key):
                    # distpow: ok transitive-blocking-under-lock -- the
                    # per-key lock exists precisely to serialize the
                    # whole miss path for one (nonce, ntz): concurrent
                    # identical requests MUST wait for the leader's
                    # result; other keys use other locks, so fanout
                    # stays concurrent across keys
                    cached = None if model else self.result_cache.get(
                        nonce, ntz, trace)
                    if cached is not None:
                        info["path"] = "hit"
                        metrics.observe("coord.mine_s.hit",
                                        time.monotonic() - t0,
                                        trace_id=tid)
                        # distpow: ok transitive-blocking-under-lock -- same
                        # per-key serialization invariant as the cache
                        # probe above; the reply's span bookkeeping is
                        # bounded work on the key's own critical path
                        return self._success_reply(trace, nonce, ntz, cached)
                    reserved = self._admit(nonce, ntz)
                    try:
                        # distpow: ok transitive-blocking-under-lock -- the
                        # miss itself runs under the per-key lock BY
                        # DESIGN (docs/COALESCING.md): followers for the
                        # same key block here until the leader finishes,
                        # then hit the cache; reconnect-dials inside are
                        # bounded by the RPC attempt timeout
                        return self._mine_miss(trace, nonce, ntz, model)
                    finally:
                        if reserved:
                            with self._tasks_lock:
                                self._sched_inflight -= 1
                        # errors included (the rpc.py dispatch-timing
                        # discipline): an all-workers-died RuntimeError
                        # after minutes of reassign probing is exactly
                        # the outage latency this split exists to show
                        miss_s = time.monotonic() - t0
                        metrics.observe("coord.mine_s.miss", miss_s,
                                        trace_id=tid)
                        self._maybe_capture_slow(tid, nonce, ntz, miss_s)
            except BaseException as exc:
                err2 = exc
                raise
            finally:
                if handle is not None:
                    # every leader exit path releases the waiters —
                    # success or failure — or they would park forever
                    handle.finish(error=err2)
        raise RuntimeError(
            f"mine for {nonce.hex()}/{ntz} made no progress after "
            f"repeated coalesced rounds"
        )

    def _maybe_capture_slow(self, tid: int, nonce: bytes, ntz: int,
                            dur_s: float) -> None:
        """Slow-request auto-capture (docs/FORENSICS.md): when the
        trigger fires, the request's span tree — everything this node's
        ring retains for the trace — is snapshotted into the flight
        recorder, so the evidence for the tail outlier is captured by
        construction (the dump-on-fault discipline), not by
        whoever notices the p99 move."""
        if not self._slow_trigger.armed:
            return
        reason = self._slow_trigger.observe(dur_s)
        if reason is None:
            return
        metrics.inc("forensics.slow_captures")
        RECORDER.record(
            "forensics.slow_request", trace_id=tid, nonce=nonce.hex(),
            ntz=ntz, dur_s=round(dur_s, 6), reason=reason,
            threshold_s=self._slow_trigger.threshold_s,
            spans=SPANS.spans_for(tid),
        )

    def _admit(self, nonce: bytes, ntz: int) -> bool:
        """Bounded run queue (docs/SCHEDULER.md): shed the request with
        a typed RETRY_AFTER once the admitted-round count hits the
        configured bound, instead of queueing without limit.  Check and
        reservation are ONE critical section, so concurrent leaders
        cannot all pass at limit-1; returns True when the caller holds
        a reservation it must release when its round ends."""
        limit = self._sched_max_inflight
        if not limit:
            return False
        with self._tasks_lock:
            inflight = self._sched_inflight
            if inflight < limit:
                self._sched_inflight = inflight + 1
                return True
        metrics.inc("sched.admission_rejected")
        RECORDER.record("sched.admission_reject", nonce=nonce.hex(),
                        ntz=ntz, inflight=inflight, limit=limit,
                        retry_after_s=self._sched_retry_after_s)
        raise AdmissionReject(
            self._sched_retry_after_s,
            f"coordinator run queue full ({inflight}/{limit})",
        )

    # -- fan-out plumbing (module docstring "Fan-out concurrency") ----------
    def _go_worker(self, w: WorkerRef, method: str, params: dict) -> Future:
        """Issue one async worker RPC; a worker with no live client
        yields an already-failed future so callers treat 'never dialed'
        exactly like 'send failed'."""
        if w.client is None:
            fut: Future = Future()
            fut.set_exception(
                RPCTransportError(f"worker {w.worker_byte} not connected")
            )
            return fut
        return w.client.go(method, params)

    def _mine_params(self, trace, nonce: bytes, ntz: int, worker_byte: int,
                     rid: str, model: Optional[str] = None,
                     plan: Optional[RoundPlan] = None) -> dict:
        out = {
            "nonce": bytes(nonce),
            "num_trailing_zeros": ntz,
            "worker_byte": worker_byte,
            "worker_bits": plan.worker_bits if plan is not None
            else self.worker_bits,
            "round": rid,
            "token": wire_token(trace.generate_token()),
        }
        if model:
            # off-default model rides only when requested: default
            # rounds stay wire-identical to every earlier version
            out["hash_model"] = model
        if self.cluster is not None and self.reply_addr:
            # pooled rounds carry their owner's worker-facing address:
            # a SHARED worker routes this round's Results back to the
            # coordinator that fanned it out, not its config default
            # (docs/CLUSTER.md).  Absent outside cluster mode — single-
            # coordinator frames stay wire-identical.
            out["coord_addr"] = self.reply_addr
        if plan is not None:
            # capability-weighted rounds carry the shard's explicit
            # (tb_lo, tb_count) byte range; equal-weight rounds attach
            # nothing and the worker expands the reference algebra —
            # frames stay wire-identical to every earlier version
            out.update(plan.mine_extra(worker_byte))
        return out

    def _found_params(self, trace, nonce: bytes, ntz: int, worker_byte: int,
                      secret: bytes, rid: str,
                      model: Optional[str] = None) -> dict:
        out = {
            "nonce": bytes(nonce),
            "num_trailing_zeros": ntz,
            "worker_byte": worker_byte,
            "secret": bytes(secret),
            "round": rid,
            "token": wire_token(trace.generate_token()),
        }
        if model:
            out["hash_model"] = model
        if self.cluster is not None and self.reply_addr:
            # the Found's cache-update-only ACK must route home too
            out["coord_addr"] = self.reply_addr
        return out

    def _mine_send_failure(self, w: WorkerRef, shard: int, rid: str,
                           exc: BaseException) -> None:
        log.warning("worker %d failed Mine for shard %d: %s",
                    w.worker_byte, shard, exc)
        metrics.inc("coord.worker_failures")
        RECORDER.record("coord.worker_failure",
                        worker_byte=w.worker_byte, shard=shard,
                        round=rid, error=str(exc))
        self._mark_dead(w)

    def _send_mine(self, trace, nonce: bytes, ntz: int, w: WorkerRef,
                   worker_byte: int, rid: str,
                   model: Optional[str] = None,
                   plan: Optional[RoundPlan] = None) -> bool:
        """Issue one worker Mine and BLOCK for its ack (the reissue,
        hedge and serial-baseline paths); under "reassign" a failure
        marks the worker dead and returns False instead of raising."""
        trace.record_action(
            act.CoordinatorWorkerMine(
                nonce=nonce, num_trailing_zeros=ntz, worker_byte=worker_byte,
            )
        )
        fut = self._go_worker(
            w, "WorkerRPCHandler.Mine",
            self._mine_params(trace, nonce, ntz, worker_byte, rid, model,
                              plan),
        )
        try:
            fut.result(timeout=self._call_timeout)
            return True
        except (OSError, RPCError, RuntimeError, FutureTimeout) as exc:
            if self.failure_policy != "reassign":
                raise
            self._mine_send_failure(w, worker_byte, rid, exc)
            return False

    def _harvest_inflight(self, inflight: List[tuple], tasks, ledgers,
                          rid: str):
        """Resolve the parallel fan-out's outstanding Mine futures off
        the round's critical path.  A confirmed ack just leaves the
        in-flight list; a failed future — or one still pending past its
        deadline (the hung-worker case the serial path paid
        ``_call_timeout`` for, per worker, before the round even
        started) — marks the worker dead, drops the shard from the
        given ack ledgers, and returns it for re-issue.  Returns
        (surviving_tasks, orphaned_shards)."""
        if not inflight:
            return tasks, []
        orphans: List[int] = []
        now = time.monotonic()
        for entry in list(inflight):
            w, shard, fut, deadline = entry
            exc: Optional[BaseException] = None
            if fut.done():
                try:
                    fut.result()
                    inflight.remove(entry)
                    continue  # ack confirmed
                except (OSError, RPCError, RuntimeError, FutureTimeout) as e:
                    exc = e
            elif now < deadline:
                continue  # still within its (parallel) timeout window
            else:
                exc = FutureTimeout(
                    f"Mine ack from worker {w.worker_byte} still pending "
                    f"after {self._call_timeout}s"
                )
            inflight.remove(entry)
            if (w, shard) not in tasks:
                # _reap_dead already killed this worker in an earlier
                # probe cycle (its ping timed out, closing the client —
                # which is exactly what failed this future) and the
                # shard was reassigned then.  Re-orphaning it here would
                # duplicate the (worker, shard) task entry and owe the
                # 2N-ack ledger acks the worker can never send — a
                # forever-spinning drain loop (reproduced with a
                # fully-hung worker and a >2s round).  The shard
                # number may still key a LIVE reassigned entry, so the
                # ledgers must not be touched either.
                continue
            self._mine_send_failure(w, shard, rid, exc)
            tasks = [t for t in tasks if t != (w, shard)]
            for ledger in ledgers:
                ledger.pop(shard, None)
            orphans.append(shard)
        return tasks, orphans

    def _assign_shards(self, trace, nonce: bytes, ntz: int, rid: str,
                       model: Optional[str] = None,
                       plan: Optional[RoundPlan] = None):
        """Fan the shard per worker (coordinator.go:179-199) — every
        Mine issued as a concurrent ``go()`` future before any reply is
        awaited; under "reassign", shards of dead workers go to live
        ones (a worker can mine a foreign worker_byte — the partition
        travels in the RPC).  The worker set is the round plan's
        membership snapshot (fleet.round_plan): static configs yield
        the reference layout, an elastic fleet whatever is live and not
        draining right now.  Returns (tasks, pending_unplaced_shards,
        inflight_mine_acks)."""
        if plan is None:
            plan = self.fleet.round_plan()
        if not plan.entries:
            raise RuntimeError("no live workers to mine on")
        reassign = self.failure_policy == "reassign"
        futs = []
        for w, shard in plan.entries:
            trace.record_action(
                act.CoordinatorWorkerMine(
                    nonce=nonce, num_trailing_zeros=ntz,
                    worker_byte=shard,
                )
            )
            futs.append((w, shard, self._go_worker(
                w, "WorkerRPCHandler.Mine",
                self._mine_params(trace, nonce, ntz, shard, rid,
                                  model, plan),
            )))
        if not reassign:
            # reference parity ("error"): every worker must take
            # delivery before the round proceeds — but the N sends
            # already overlapped, so N round trips cost ~one RTT
            tasks = []
            for w, shard, fut in futs:
                fut.result()  # any failure fails the Mine RPC, as before
                tasks.append((w, shard))
            return tasks, [], []
        tasks, orphans, inflight = [], [], []
        deadline = time.monotonic() + (self._call_timeout or 10.0)
        for w, shard, fut in futs:
            if fut.done():
                # resolved at issue time: either a send-path transport
                # failure (dead TCP fails inside go()) or an already-
                # arrived ack
                try:
                    fut.result()
                    tasks.append((w, shard))
                except (OSError, RPCError, RuntimeError, FutureTimeout) as exc:
                    self._mine_send_failure(w, shard, rid, exc)
                    orphans.append(shard)
            else:
                # optimistic placement: the frame is written, only the
                # ack is outstanding.  The round starts NOW; the ack is
                # confirmed (or timed out, in parallel with its peers)
                # by _harvest_inflight during the result waits — a hung
                # worker no longer adds _call_timeout to
                # fanout->first-result for the live ones
                tasks.append((w, shard))
                inflight.append((w, shard, fut, deadline))
        tasks, pending = self._issue_shards(
            trace, nonce, ntz, tasks, orphans, rid, model, plan
        )
        if not tasks:
            raise RuntimeError("no live workers to mine on")
        return tasks, pending, inflight

    def _mine_miss(self, trace, nonce: bytes, ntz: int,
                   model: Optional[str] = None) -> dict:
        self._initialize_workers()
        key = (nonce, ntz)
        # distpow: ok bounded-queue -- protocol-bounded: one round's
        # queue holds at most 2 messages per live worker (the 2N-ack
        # ledger) plus one ack per re-broadcast, and the Result handler
        # drops stale-round messages before they are enqueued; a hard
        # maxsize that ever blocked the Result dispatch thread would
        # wedge the whole round instead
        results: "queue.Queue" = queue.Queue()
        rid = new_round_id(
            self.restart_epoch,
            self.cluster.self_id if self.cluster is not None else "",
        )
        self._task_set(key, rid, results)
        reassign = self.failure_policy == "reassign"
        probe_t = self.failure_probe_secs if reassign else None
        # the round's membership snapshot (docs/FLEET.md): who gets a
        # shard, at which worker_bits, over which (weighted) byte
        # ranges.  Hedging appends duplicate placements to it, so the
        # closing track_round(-1) releases every ref the round touched
        # — the drain RPC waits on exactly this accounting.
        plan = self.fleet.round_plan()
        self.fleet.track_round([w for w, _ in plan.entries], +1)
        try:
            return self._mine_miss_locked(
                trace, nonce, ntz, results, reassign, probe_t, rid, model,
                plan,
            )
        finally:
            # every exit path (success, protocol violation, all-workers-
            # dead, error-policy RPC failure) must release the task entry,
            # or retries leak queues and late Results route to a zombie
            self._task_delete(key)
            self.fleet.track_round([w for w, _ in plan.entries], -1)

    def _mine_miss_locked(self, trace, nonce: bytes, ntz: int, results,
                          reassign: bool, probe_t, rid: str,
                          model: Optional[str] = None,
                          plan: Optional[RoundPlan] = None) -> dict:
        metrics.inc("coord.fanouts")
        # the fan-out instant anchors this round's two latency
        # distributions: fanout->first-result (the race the paper's
        # contract is about) and fanout->last-ack (cancel propagation)
        fanout_t0 = time.monotonic()
        fanout_ts = time.time()
        RECORDER.record("coord.fanout", round=rid, nonce=nonce.hex(),
                        ntz=ntz)
        if plan is None:
            plan = self.fleet.round_plan()
        tasks, pending, inflight = self._assign_shards(trace, nonce, ntz, rid,
                                                       model, plan)
        # forensics span (docs/FORENSICS.md): the shard-issue phase,
        # carved out of timestamps the round takes anyway — spans are
        # derived observers, never new trace actions
        SPANS.record("coord.fanout", fanout_ts,
                     time.monotonic() - fanout_t0,
                     trace_id=trace.trace_id, node=self.tracer.identity,
                     round=rid, nonce=nonce.hex(), ntz=ntz,
                     shards=len(tasks))

        # first-result-wins (coordinator.go:202-206); under "reassign",
        # waiting is interleaved with liveness probes, the harvest of
        # the parallel fan-out's outstanding Mine acks AND the straggler
        # hedge (docs/FLEET.md: a shard whose heartbeat-lease owner has
        # gone silent past the fleet's hedge threshold gets a duplicate
        # on the least-loaded live worker — first result still wins);
        # orphaned and not-yet-placed shards are re-issued every round
        # so coverage is never silently lost
        hedged: set = set()
        while True:
            try:
                first = results.get(timeout=probe_t)
                break
            except queue.Empty:
                tasks, hung = self._harvest_inflight(inflight, tasks, (), rid)
                tasks, orphans = self._reap_dead(tasks, ())
                if not tasks:
                    raise RuntimeError("all workers died while mining")
                tasks, pending = self._issue_shards(
                    trace, nonce, ntz, tasks, pending + hung + orphans, rid,
                    model, plan
                )
                tasks = self._maybe_hedge(trace, nonce, ntz, tasks, rid,
                                          model, plan, hedged)
        first_result_s = time.monotonic() - fanout_t0
        metrics.observe("coord.first_result_s", first_result_s,
                        trace_id=trace.trace_id)
        RECORDER.record("coord.first_result", round=rid,
                        nonce=nonce.hex(), ntz=ntz,
                        worker_byte=int(first["worker_byte"]),
                        latency_s=round(first_result_s, 6))
        SPANS.record("coord.first_result", fanout_ts, first_result_s,
                     trace_id=trace.trace_id, node=self.tracer.identity,
                     round=rid, nonce=nonce.hex(), ntz=ntz,
                     winner_byte=int(first["worker_byte"]))
        if first["secret"] is None:
            raise RuntimeError(
                "protocol violation: first worker message was a cancellation "
                f"ACK from worker_byte={first['worker_byte']}"
            )
        winner = bytes(first["secret"])

        tasks = self._broadcast_found(trace, nonce, ntz, winner, tasks, rid,
                                      model)

        # the 2-messages-per-task ack ledger (coordinator.go:237-248): the
        # finder already delivered 1 message; every surviving task owes 2
        remaining: Dict[int, int] = {}
        for _, shard in tasks:
            remaining[shard] = remaining.get(shard, 0) + 2
        fb = int(first["worker_byte"])
        if fb in remaining:
            remaining[fb] -= 1
        late: List[dict] = []
        while any(v > 0 for v in remaining.values()):
            try:
                msg = results.get(timeout=probe_t)
            except queue.Empty:
                tasks, _ = self._harvest_inflight(
                    inflight, tasks, (remaining,), rid
                )
                tasks, _ = self._reap_dead(tasks, (remaining,))
                continue
            if msg["secret"] is not None:
                late.append(msg)
                metrics.inc("coord.late_results")
                log.info("late worker result: %s", msg["worker_byte"])
            b = int(msg["worker_byte"])
            if b in remaining:
                remaining[b] -= 1
        # the 2N-ack ledger just drained: every surviving worker has
        # acknowledged the cancellation — fanout->last-ack is the
        # cancel-propagation latency the metrics plane measures
        cancel_s = time.monotonic() - fanout_t0
        metrics.observe("coord.cancel_propagation_s", cancel_s,
                        trace_id=trace.trace_id)
        RECORDER.record("coord.cancel_complete", round=rid,
                        nonce=nonce.hex(), ntz=ntz,
                        late_results=len(late),
                        latency_s=round(cancel_s, 6))
        # the cancel-storm span starts where first_result ended, so the
        # two tile the round on the stitched timeline instead of
        # double-counting the race
        SPANS.record("coord.cancel_storm", fanout_ts + first_result_s,
                     cancel_s - first_result_s,
                     trace_id=trace.trace_id, node=self.tracer.identity,
                     round=rid, nonce=nonce.hex(), ntz=ntz,
                     late_results=len(late))

        # late-result cache propagation (coordinator.go:250-280): each
        # rebroadcast is acked once per task (cache-update-only round)
        for msg in late:
            tasks = self._broadcast_found(
                trace, nonce, ntz, bytes(msg["secret"]), tasks, rid, model
            )
            owed = {shard: 1 for _, shard in tasks}
            while any(v > 0 for v in owed.values()):
                try:
                    m = results.get(timeout=probe_t)
                except queue.Empty:
                    tasks, _ = self._harvest_inflight(
                        inflight, tasks, (owed,), rid
                    )
                    tasks, _ = self._reap_dead(tasks, (owed,))
                    continue
                b = int(m["worker_byte"])
                if b in owed:
                    owed[b] -= 1

        if reassign:
            alive = {id(w) for w, _ in tasks}
            # only workers THIS round touched (the plan, hedges
            # included) need the re-sync: a member that joined after
            # fan-out has no orphaned miners to unblock, and Found-ing
            # it would just mint unknown-task noise at its forwarder
            abandoned = [w for w in
                         {id(x): x for x, _ in plan.entries}.values()
                         if id(w) not in alive]
            if abandoned:
                # OFF the success-reply critical path (an inline re-dial
                # would sit between the drained ledger and the client's
                # reply): bounded background
                # best-effort re-sync, one flight-recorder event per
                # outcome
                threading.Thread(
                    target=self._resync_abandoned,
                    args=(trace, nonce, ntz, winner, abandoned, rid, model),
                    daemon=True, name=f"resync-{rid[-8:]}",
                ).start()
        return self._success_reply(trace, nonce, ntz, winner)

    def _maybe_hedge(self, trace, nonce: bytes, ntz: int, tasks, rid: str,
                     model: Optional[str], plan: RoundPlan,
                     hedged: set):
        """Straggler hedging (docs/FLEET.md "Hedging policy"): while the
        round waits for its first result, any shard whose owner's
        heartbeat lease has gone silent for longer than
        ``hedge_multiple x`` the fleet's median heartbeat interval gets
        ONE duplicate Mine on the least-loaded live worker.  First
        result still wins; the straggler is neither killed nor
        abandoned — if it wakes and answers first, its result counts.
        Static (permanent-lease) workers never trip this: they have no
        heartbeats, and their failure detection stays the probe path.
        The SIGSTOP fault machinery is exactly the scenario this makes
        first-class: a frozen worker's beats stop long before its TCP
        shows anything wrong."""
        if not self.fleet.hedge_enabled or self.failure_policy != "reassign":
            return tasks
        threshold = self.fleet.hedge_after_s()
        loads: Dict[int, int] = {}
        for x, _s in tasks:
            loads[id(x)] = loads.get(id(x), 0) + 1
        for w, shard in list(tasks):
            if shard in hedged or not self.fleet.is_stale(w, threshold):
                continue
            candidates = [
                x for x in {id(x): x for x, _ in tasks}.values()
                if x is not w and x.client is not None
                and not self.fleet.is_stale(x, threshold)
                and self.fleet.in_service(x)
            ]
            if not candidates:
                continue
            target = min(candidates, key=lambda x: loads.get(id(x), 0))
            if not self._send_mine(trace, nonce, ntz, target, shard, rid,
                                   model, plan):
                continue
            hedged.add(shard)
            tasks.append((target, shard))
            # the duplicate placement joins the plan so the round's
            # closing track_round(-1) and the re-sync sweep see it
            plan.entries.append((target, shard))
            loads[id(target)] = loads.get(id(target), 0) + 1
            metrics.inc("fleet.hedged_shards")
            RECORDER.record(
                "fleet.hedge", round=rid, shard=shard,
                owner_byte=w.worker_byte, target_byte=target.worker_byte,
                threshold_s=round(threshold, 3),
            )
            SPANS.event("fleet.hedge", trace_id=trace.trace_id,
                        node=self.tracer.identity, round=rid, shard=shard,
                        owner_byte=w.worker_byte,
                        target_byte=target.worker_byte)
            log.info("hedged shard %d of silent worker %d onto worker %d",
                     shard, w.worker_byte, target.worker_byte)
        return tasks

    #: total wall-clock budget for one round's abandoned-worker re-sync
    #: (dials + Found calls share it); generous vs the 2 s dial timeout
    #: yet small enough that a stack teardown never waits on stragglers
    RESYNC_CAP_S = 8.0
    RESYNC_DIAL_TIMEOUT_S = 2.0

    #: Found-ack patience for a member whose heartbeat lease is already
    #: hedge-stale: it is almost certainly frozen, and the full shared
    #: ``_call_timeout`` would gate the round's reply on a worker the
    #: fleet has stopped believing in.  Never applied to permanent
    #: (static) leases — they cannot be stale.
    STALE_ACK_TIMEOUT_S = 1.0

    def _resync_abandoned(self, trace, nonce: bytes, ntz: int,
                          secret: bytes, workers: List[WorkerRef],
                          rid: str, model: Optional[str] = None) -> None:
        """Best-effort Found to every worker not among the surviving
        tasks.  A worker falsely marked dead on a transient failure still
        has miner threads running (and a finder may be blocked waiting for
        its Found); once the blip heals, this installs the winning secret
        — which also self-cancels its orphaned miners via the worker's
        cache-aware cancel check — and unblocks any waiting finder.
        Failures are ignored: a truly dead worker has nothing running.

        Runs on a background thread, one sub-thread per worker, all
        capped by RESYNC_CAP_S: the re-dial of a black-holed address can
        no longer add its connect timeout to the Mine reply, and total
        re-sync time is bounded no matter how many workers are down.
        Dials are THROWAWAY clients — installing one on the WorkerRef
        here would race the next round's ``_initialize_workers``."""
        deadline = time.monotonic() + self.RESYNC_CAP_S

        def resync_one(w: WorkerRef) -> None:
            t0 = time.monotonic()
            outcome = "resynced"
            client = temp = None
            try:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    outcome = "deadline"
                    return
                client, temp = w.client, None
                if client is None:
                    temp = client = RPCClient(
                        w.addr,
                        timeout=min(self.RESYNC_DIAL_TIMEOUT_S, remaining),
                    )
                try:
                    client.call(
                        "WorkerRPCHandler.Found",
                        self._found_params(trace, nonce, ntz, w.worker_byte,
                                           secret, rid, model),
                        timeout=max(0.1, deadline - time.monotonic()),
                    )
                finally:
                    if temp is not None:
                        temp.close()
                log.info("abandoned worker %d cancelled and re-synced",
                         w.worker_byte)
            except (OSError, RPCError, RuntimeError, FutureTimeout) as exc:
                outcome = "unreachable"
                log.info("abandoned worker %d still unreachable: %s",
                         w.worker_byte, exc)
                # only tear down the client THIS thread observed failing:
                # the next round's _initialize_workers may have installed
                # a fresh healthy connection while this (post-reply,
                # seconds-long) background attempt was in flight, and
                # _mark_dead-ing that one would spuriously fail a live
                # worker's round
                if temp is None and client is not None and \
                        w.client is client:
                    self._mark_dead(w)
            finally:
                metrics.inc("coord.abandoned_resyncs")
                RECORDER.record(
                    "coord.abandoned_resync", worker_byte=w.worker_byte,
                    round=rid, outcome=outcome,
                    latency_s=round(time.monotonic() - t0, 6),
                )

        for w in workers:
            # distpow: ok unbounded-thread-spawn -- bounded: one spawn
            # per abandoned worker of ONE round (<= fleet size), and
            # every thread self-terminates within RESYNC_CAP_S via the
            # shared deadline — the per-item spawn is the point (the
            # serial alternative re-serializes dial timeouts)
            threading.Thread(target=resync_one, args=(w,), daemon=True,
                             name=f"resync-{rid[-8:]}-w{w.worker_byte}"
                             ).start()

    def _await_found(self, w: WorkerRef, shard: int, fut: Future,
                     timeout: Optional[float]) -> bool:
        """Confirm one Found delivery; under "reassign" a failure (or a
        deadline expiry) marks the worker dead and returns False."""
        try:
            fut.result(timeout=timeout)
            return True
        except (OSError, RPCError, RuntimeError, FutureTimeout) as exc:
            if self.failure_policy != "reassign":
                raise
            log.warning("worker %d failed Found for shard %d: %s",
                        w.worker_byte, shard, exc)
            self._mark_dead(w)
            return False

    def _broadcast_found(
        self,
        trace,
        nonce: bytes,
        ntz: int,
        secret: bytes,
        tasks: List[Tuple[WorkerRef, int]],
        rid: str,
        model: Optional[str] = None,
    ) -> List[Tuple[WorkerRef, int]]:
        """Found-as-cancel+cache-install per task (coordinator.go:210-230);
        returns the tasks whose worker took delivery.  All Founds are
        issued before any reply is awaited, so the cancel storm costs
        ~one RTT instead of N, and every straggler shares ONE deadline
        instead of timing out head-of-line, one after another."""
        issued: List[Tuple[WorkerRef, int, Future]] = []
        delivered: List[Tuple[WorkerRef, int]] = []
        for w, shard in tasks:
            trace.record_action(
                act.CoordinatorWorkerCancel(
                    nonce=nonce, num_trailing_zeros=ntz, worker_byte=shard,
                )
            )
            issued.append((w, shard, self._go_worker(
                w, "WorkerRPCHandler.Found",
                self._found_params(trace, nonce, ntz, shard, secret, rid,
                                   model),
            )))
        deadline = (None if self._call_timeout is None
                    else time.monotonic() + self._call_timeout)
        for w, shard, fut in issued:
            timeout = (None if deadline is None
                       else max(0.0, deadline - time.monotonic()))
            if timeout is not None and self.fleet.is_stale(w):
                # hedge-stale member: clamp its ack patience so a
                # frozen straggler cannot gate the winner's reply on
                # the full shared deadline (STALE_ACK_TIMEOUT_S)
                timeout = min(timeout, self.STALE_ACK_TIMEOUT_S)
            if self._await_found(w, shard, fut, timeout):
                delivered.append((w, shard))
        return delivered

    def _success_reply(self, trace, nonce: bytes, ntz: int, secret: bytes) -> dict:
        trace.record_action(
            act.CoordinatorSuccess(
                nonce=nonce, num_trailing_zeros=ntz, secret=secret
            )
        )
        return {
            "nonce": bytes(nonce),
            "num_trailing_zeros": ntz,
            "secret": bytes(secret),
            "token": wire_token(trace.generate_token()),
        }

    def Result(self, params) -> dict:
        nonce = bytes(params["nonce"])
        ntz = int(params["num_trailing_zeros"])
        trace = self.tracer.receive_token(decode_token(params["token"]))
        if params.get("secret") is not None:
            trace.record_action(
                act.CoordinatorWorkerResult(
                    nonce=nonce,
                    num_trailing_zeros=ntz,
                    worker_byte=int(params["worker_byte"]),
                    secret=bytes(params["secret"]),
                )
            )
            if not params.get("hash_model"):
                # the dominance cache is single-model: an off-default
                # result (tagged by the worker, docs/SERVING.md) must
                # never be installed where a default-model lookup could
                # replay it — same invariant the worker's Found handler
                # enforces one hop down
                installed = self.result_cache.add(
                    nonce, ntz, bytes(params["secret"]), trace)
                if installed and self.replicator is not None:
                    # write-behind replication (cluster/replication.py):
                    # non-blocking enqueue — a full queue drops and
                    # counts, never stalls the Result handler
                    self.replicator.offer(nonce, ntz,
                                          bytes(params["secret"]))
        entry = self._task_get((nonce, ntz))
        if entry is None:
            # documented fix: the reference blocks forever on a nil channel
            # here (coordinator.go:318); we log and drop instead.
            log.warning("result for unknown task %s/%d dropped", nonce.hex(), ntz)
            return {}
        rid, q = entry
        msg_rid = params.get("round")
        if msg_rid is not None and msg_rid != rid:
            # a zombie miner from a superseded round: its message must
            # not count against the live round's 2N-ack ledger (module
            # docstring).  The cache add above already happened for
            # non-nil secrets — a valid secret is valid whatever round
            # found it (late-result semantics, coordinator.go:250-280).
            metrics.inc("coord.stale_results_dropped")
            log.info("stale-round result for %s/%d dropped", nonce.hex(), ntz)
            return {}
        q.put(params)
        return {}

    def Stats(self, params) -> dict:
        """Metrics snapshot (runtime/metrics.py; no reference
        equivalent).  ``python -m distpow_tpu.cli.stats`` prints it."""
        # resource sentinels ride every Stats snapshot (runtime/health.py,
        # docs/SOAK.md): proc.* self-telemetry plus the depth of every
        # bounded ring, refreshed before the registry is read
        repl_view = (self.replicator.stats_view()
                     if self.replicator is not None else None)
        if repl_view is not None:
            metrics.gauge("ring.repl_queue_depth",
                          float(repl_view.get("queue_depth", 0)))
        SENTINELS.sample()
        snap = metrics.snapshot()
        snap["role"] = "coordinator"
        snap["workers"] = [
            {"worker_byte": w.worker_byte, "addr": w.addr,
             "connected": w.client is not None}
            for w in list(self.workers)
        ]
        # live membership table (docs/FLEET.md): what `stats --discover`
        # and Fleet.Members render — leases, capabilities, drain state
        snap["fleet"] = {
            "members": self.fleet.members(),
            "lease_ttl_s": self.fleet.lease_ttl_s,
            "hedge": self.fleet.hedge_enabled,
        }
        snap["active_tasks"] = len(self._tasks)
        snap["cache_entries"] = len(self.result_cache)
        snap["failure_policy"] = self.failure_policy
        if self.cluster is not None:
            # pool membership view (docs/CLUSTER.md): which shard this
            # is and the ring it routes by — what `stats --discover`
            # walks to cover the whole pool
            snap["cluster"] = {"self": self.cluster.self_id,
                               "ring": self.cluster.ring.to_wire()}
        if repl_view is not None:
            snap["replication"] = repl_view
        snap["sched"] = {
            "max_inflight": self._sched_max_inflight,
            "coalesce": self._coalescer is not None,
        }
        return snap


class Coordinator:
    """Coordinator process object (NewCoordinator/InitializeRPCs,
    coordinator.go:115-136, 322-354)."""

    def __init__(self, config: CoordinatorConfig, sink=None):
        self.config = config
        tdir = getattr(config, "TelemetryDir", "") or ""
        if tdir:
            # flight-recorder journal + dump-on-fault directory
            # (runtime/telemetry.py; off by default — memory-only ring)
            RECORDER.configure(
                journal_path=os.path.join(
                    tdir, "coordinator.telemetry.jsonl"
                ),
                dump_dir=tdir,
            )
        # pooled coordinators trace under DISTINCT identities: two
        # processes sharing one vector-clock stream would interleave
        # its components and trip every monotonicity invariant
        # trace_check holds (docs/CLUSTER.md).  Shard 0 — and every
        # single-coordinator config — keeps the historical
        # "coordinator", so golden traces stay byte-identical.
        shard = int(getattr(config, "ClusterSelf", -1))
        identity = (f"coordinator{shard}"
                    if getattr(config, "ClusterPeers", None) and shard > 0
                    else "coordinator")
        self.tracer = make_tracer(
            identity, config.TracerServerAddr, config.TracerSecret,
            sink=sink,
        )
        self.handler = CoordRPCHandler(
            self.tracer, list(config.Workers),
            cache_file=getattr(config, "CacheFile", "") or None,
            failure_policy=getattr(config, "FailurePolicy", "error") or "error",
            failure_probe_secs=getattr(config, "FailureProbeSecs", 1.0),
            sched_max_inflight=getattr(config, "SchedMaxInflight", 0),
            sched_retry_after_s=getattr(config, "SchedRetryAfterS", 0.5),
            sched_coalesce=getattr(config, "SchedCoalesce", True),
            lease_ttl_s=getattr(config, "FleetLeaseTTLS", 10.0) or 10.0,
            hedge=bool(getattr(config, "FleetHedge", True)),
            hedge_multiple=getattr(config, "FleetHedgeMultiple", 3.0) or 3.0,
            forensics_slow_s=getattr(config, "ForensicsSlowS", 0.0) or 0.0,
            forensics_p99x=getattr(config, "ForensicsSlowP99X", 0.0) or 0.0,
        )
        self.server = RPCServer()
        self.server.register("CoordRPCHandler", self.handler)
        # lease-based membership RPCs (fleet/, docs/FLEET.md):
        # elastic workers Register/Heartbeat/Drain against either
        # listener; Members feeds `stats --discover`
        self.server.register(
            "Fleet",
            FleetService(self.handler.fleet,
                         drain_timeout_s=getattr(
                             config, "FleetDrainTimeoutS", 20.0) or 20.0),
        )
        # role-agnostic Stats alias (the reference's obs/, docs/SLO.md):
        # lets the fleet scraper's auto-role discovery resolve ANY
        # current node without the unknown-service error a wrong-role
        # probe earns — which would otherwise tick rpc.handler_errors
        # on the very node being observed (the watcher-perturbation
        # class the stats CLI's JSON pin already guards against).
        # Stats-only view: the protocol surface stays single-named.
        self.server.register("Node", StatsOnly(self.handler))
        self.client_addr: Optional[str] = None
        self.worker_addr: Optional[str] = None
        # cache replication knobs (cluster/replication.py) — only read
        # when set_cluster_peers actually runs, so single-coordinator
        # configs never construct a Replicator and stay byte-identical
        self._repl_replicas = int(getattr(config, "ClusterCacheReplicas", 1))
        self._repl_queue_depth = int(
            getattr(config, "ClusterReplQueueDepth", 1024))
        self._repl_antientropy_s = float(
            getattr(config, "ClusterAntiEntropyS", 5.0))
        self._repl_handoff_deadline_s = float(
            getattr(config, "ClusterHandoffDeadlineS", 5.0))
        self._replicator: Optional[Replicator] = None
        # coordinator pool (cluster/, docs/CLUSTER.md):
        # config-driven membership installs here; ':0'-bound harnesses
        # call set_cluster_peers() once the real addresses exist
        peers = list(getattr(config, "ClusterPeers", []) or [])
        if peers:
            self.set_cluster_peers(
                peers, int(getattr(config, "ClusterSelf", -1)))

    def set_cluster_peers(self, peers: List[str], self_index: int) -> None:
        """Join (or rewire) the coordinator pool: build the canonical
        ring from the peer list, adopt member id ``c<self_index>``,
        register the ``Cluster`` RPC service, and advertise the ring in
        every ``rpc.hello`` ack.  Call before the first Mine; harnesses
        binding on ':0' call it after ``initialize_rpcs`` when the real
        peer addresses exist (the set_worker_addrs discipline).

        Rewiring an already-pooled coordinator is a MEMBERSHIP CHANGE:
        the ring version bumps (clients adopt strictly newer rings) and
        the warm shard handoff (cluster/replication.py, docs/CLUSTER.md
        "Replication & HA") pushes the remapped ranges' entries to
        their new owners BEFORE the new ring is installed or served —
        the handoff-before-ack ordering that keeps a grown pool warm.
        The handoff is deadline-bounded (ClusterHandoffDeadlineS), so a
        frozen recipient delays the ring change by at most the
        deadline; anti-entropy heals whatever was cut off."""
        if not (0 <= self_index < len(peers)):
            raise ValueError(
                f"ClusterSelf={self_index} is not an index into the "
                f"{len(peers)}-entry ClusterPeers list"
            )
        old = self.handler.cluster
        version = old.ring.version + 1 if old is not None else 0
        ring = ring_from_peers(peers, version=version)
        if self._replicator is None:
            # lazily constructed on first pool join — single-coordinator
            # processes never reach here, so they carry no replication
            # threads, queues, or RPCs (byte-identity pin,
            # tests/test_cluster.py)
            self._replicator = Replicator(
                self.handler.result_cache,
                replicas=self._repl_replicas,
                queue_depth=self._repl_queue_depth,
                antientropy_s=self._repl_antientropy_s,
                handoff_deadline_s=self._repl_handoff_deadline_s,
            )
            self.handler.replicator = self._replicator
        if old is not None and ring != old.ring:
            # handoff BEFORE install: until this returns (or hits its
            # deadline) we keep serving and replicating on the old ring
            self._replicator.handoff(old.ring, ring)
        state = ClusterState(ring, f"c{self_index}")
        self._replicator.set_state(state)
        self.handler.set_cluster(state)
        self.server.register(
            "Cluster", ClusterService(state, replicator=self._replicator))
        self.server.hello_extra = state.hello_extra

    def set_worker_addrs(self, addrs: List[str]) -> None:
        """Rebind worker addresses after construction.

        The reference fixes the worker list in static config
        (config/coordinator_config.json:4-9) and dials lazily with retry
        (coordinator.go:169-172, 356-368).  We keep the lazy dial but also
        support ':0'-bound workers whose real ports are only known after
        they listen; call this before the first Mine.
        """
        if len(addrs) != len(self.handler.workers):
            raise ValueError(
                f"expected {len(self.handler.workers)} worker addrs, "
                f"got {len(addrs)}"
            )
        for ref, addr in zip(self.handler.workers, addrs):
            if ref.client is not None and ref.addr != addr:
                raise RuntimeError(f"worker {ref.worker_byte} already dialed")
            ref.addr = addr

    def initialize_rpcs(self) -> Tuple[str, str]:
        """Bind the segregated worker-facing and client-facing listeners."""
        self.worker_addr = self.server.listen(self.config.WorkerAPIListenAddr)
        self.client_addr = self.server.listen(self.config.ClientAPIListenAddr)
        # cluster-mode rounds stamp this as their reply-to so shared
        # workers deliver Results to the round's owner (docs/CLUSTER.md)
        self.handler.reply_addr = self.worker_addr
        self.server.serve_in_background()
        log.info(
            "coordinator serving clients on %s, workers on %s",
            self.client_addr, self.worker_addr,
        )
        return self.client_addr, self.worker_addr

    def run_forever(self) -> None:
        self.initialize_rpcs()
        threading.Event().wait()

    def shutdown(self) -> None:
        self.handler.fleet.close()  # stop the lease reaper
        if self._replicator is not None:
            self._replicator.close()
        self.server.shutdown()
        for w in list(self.handler.workers):
            if w.client is not None:
                w.client.close()
        self.handler.result_cache.close()
        self.tracer.close()
