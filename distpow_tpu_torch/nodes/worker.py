"""Worker node — the compute plane (SURVEY.md section 2 component 4).

Protocol parity with the reference worker (worker.go):

* ``Mine`` RPC (worker.go:169-185): registers a cancellable task *before*
  receiving the token, records ``WorkerMine``, then kicks off the miner
  asynchronously so the RPC returns immediately.
* ``Found`` RPC (worker.go:202-232) doubles as cancellation and cache
  install.  If the task is still active: install the winning secret into
  the worker cache, fire the cancel event, delete the task — the miner
  thread then emits its ``WorkerCancel`` + nil-secret ACK.  If no task is
  active (late re-broadcast, or a repeat ``Found``): record
  ``WorkerCancel`` here, install the cache entry, and ACK directly.
* ``Cancel`` RPC (worker.go:189-198): legacy plain cancellation, kept for
  API parity (the reference coordinator never calls it).
* The miner (worker.go:258-401): consult the dominance cache first; on a
  hit, replay the found-path (result -> wait for cancel -> ``WorkerCancel``
  -> nil ACK).  Otherwise expand the worker's thread-byte partition and
  run the configured compute backend.  The found-path *blocks on the
  cancel event after sending the result* so ``WorkerCancel`` is always the
  trace's final worker action — same ordering discipline the reference
  enforces by blocking on killChan (worker.go:375-379).  A cancelled miner
  sends TWO nil ACKs (worker.go:327-341): one for the in-flight round, one
  consumed by the coordinator's 2N-ack ledger.

Divergence from the reference (documented, SURVEY.md section 7): the
reference polls its cancel channel once per candidate; accelerator
backends poll between batches, so cancellation latency is one batch.

Results leave through a queue drained by a forwarder thread issuing async
``CoordRPCHandler.Result`` calls — the cmd/worker/main.go:27-36 loop.

The port's worker (the reference is ``distpow_tpu/nodes/worker.py``): the
same RPCs, actions, wire frames, spans and metrics, served through the
port's backends and scheduler on ``device`` (the card unless the caller
asks for the CPU; without a GPU the worker raises instead of falling
back).  Where it differs from the reference:

* ``Worker(config, sink, device)`` passes ``device`` to ``get_backend``
  and to the batching scheduler; ``Backend`` ``auto``, ``pallas`` and
  ``jax`` (the reference's default) on the card are the CUDA kernel.
* ``JaxCoordinator`` set joins a ``torch.distributed`` group
  (``maybe_init_distributed``: NCCL on cards, gloo on the CPU) instead of a
  ``jax.distributed`` cluster, and in a group of more than one rank the
  CUDA backend names serve the mesh across the ranks' shards.
* ``CompilationCacheDir`` is the directory the CUDA kernels are built in
  (``ops/_build.set_build_dir``).
* A failed boot warm-up is logged and counted (``worker.warmup_failures``);
  the first Mine then builds again and raises the build's own error.
* ``Stats`` also carries ``device`` and ``kernel_launches`` (each CUDA
  kernel form's launches in this process).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import queue
import threading
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..backends import get_backend
from ..backends.cuda_backend import _require_device
from ..ops import _build
from ..ops.hash_cuda import LAUNCHES
from ..parallel import partition
from ..parallel.mesh_search import explicit_device, gather_counts
from ..parallel.search import resolve_past_hit
from ..runtime import actions as act
from ..runtime.cache import ResultCache
from ..runtime.metrics import REGISTRY as metrics
from ..runtime.config import WorkerConfig
from ..runtime.health import SENTINELS
from ..runtime.rpc import RPCClient, RPCServer, StatsOnly
from ..runtime.spans import SPANS
from ..runtime.telemetry import RECORDER
from ..runtime.tracing import Tracer, decode_token, make_tracer, wire_token
from ..runtime.watchdog import WATCHDOG

log = logging.getLogger("distpow.worker")

TaskKey = Tuple[bytes, int, int]  # (nonce, num_trailing_zeros, worker_byte)


# How long a rank waits for the others at the group's rendezvous and at a
# collective before it raises: a rank that dies does not leave the others
# blocked for ever.  It must outlast the slowest first launch of a rank,
# which may build the kernels' libraries (nvcc) while the others wait.
DIST_TIMEOUT_S = 600.0


def maybe_init_distributed(coordinator: str, num_processes: int, process_id: int,
                           backend: Optional[str] = None, device="cuda",
                           timeout_s: float = DIST_TIMEOUT_S) -> None:
    """Join a multi-host cluster (no-op when ``coordinator`` is empty).

    The reference joins a ``jax.distributed`` cluster here, so that one
    mesh worker spans the chips of several processes and its ``lax.pmin``
    crosses them.  The port joins a ``torch.distributed`` process group:
    ``init_method="tcp://<coordinator>"``, ``world_size=num_processes``,
    ``rank=process_id``; rank 0 hosts the store, as process 0 hosts the
    reference's coordinator service.  A mesh made afterwards spans every
    rank's shards (``parallel/mesh_search.py``).  Must run before any
    backend is built.

    ``backend`` is the group's: by default NCCL where ``device`` is a card
    (each rank on a card of its own: give each rank its cards through
    ``CUDA_VISIBLE_DEVICES``, as JAX processes divide a host's chips) and
    gloo on the CPU.  Ranks that share one card cannot use NCCL (it refuses
    a card twice in one communicator); they pass ``backend="gloo"``, whose
    all-reduce takes CUDA tensors through the host.  A group that cannot
    form raises; nothing falls back to a mesh of this process alone.
    ``timeout_s`` bounds the rendezvous and every collective."""
    if not coordinator:
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    dev = explicit_device(device)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    log.info("joined torch.distributed group (%s) via %s: rank %d/%d, %d global devices",
             backend, coordinator, dist.get_rank(), dist.get_world_size(),
             sum(gather_counts(local, dist.group.WORLD, dev)))


def _key(params) -> TaskKey:
    return (bytes(params["nonce"]), int(params["num_trailing_zeros"]),
            int(params["worker_byte"]))


def _backend_model_name(backend) -> str:
    """The hash model a backend was built to serve (every backend
    carries either a ``HashModel`` or its name)."""
    m = getattr(backend, "model", None)
    if m is not None:
        return m.name
    return getattr(backend, "hash_model", "md5")


def _rid_split(rid: str) -> Tuple[str, str]:
    """``(namespace, ordering_body)`` of a round id.

    Pooled coordinators prefix their ring member id
    (``"c1.<epoch><ns>"`` — nodes/coordinator.py new_round_id): the
    issue-order comparison zombie fencing relies on is only meaningful
    WITHIN one coordinator's id stream, so the namespace must be
    split off before any ordering.  Single-coordinator ids have no
    separator and land in the ``""`` namespace — every pre-cluster id
    keeps exactly its old ordering behavior.
    """
    ns, sep, body = rid.rpartition(".")
    return (ns, body) if sep else ("", rid)


def _rid_order(rid: str) -> str:
    """Round-id ordering key, robust to the id-format width change.

    Epoch-prefixed ids (nodes/coordinator.py new_round_id) are 24 hex
    chars; ids minted by the pre-epoch format (or by a coordinator
    running without a CacheFile before the epoch field existed) are the
    bare 16-char time_ns — exactly an epoch-0 id without its prefix.
    Left-padding with zeros makes the two formats compare correctly
    during a mixed-format window (worker outlives a coordinator
    upgrade); plain string comparison would order EVERY new-format id
    before every old-format one.  Callers comparing ids must first
    establish they share a namespace (``_rid_split``).
    """
    return _rid_split(rid)[1].rjust(24, "0")


class TaskRound:
    """One Mine round's cancellation state.

    ``superseded`` distinguishes a protocol cancel (Found/Cancel RPC —
    the miner must emit WorkerCancel + nil ACKs, worker.go:320-345) from
    replacement by a NEWER Mine for the same key: a superseded miner must
    exit silently, because anything it sent would be routed into the new
    round's coordinator queue (keyed by (nonce, ntz) only) and either
    trip the first-message-must-be-a-result protocol check or drain the
    new round's 2N-ack ledger early.

    ``round_id`` is the coordinator's fan-out-round tag (nodes/
    coordinator.py module docstring); it is echoed in every result this
    round sends so the coordinator can drop whatever a zombie does leak
    through the unavoidable check-then-send window.

    ``reply_to`` (coordinator pool, docs/CLUSTER.md): the worker-facing
    address of the coordinator that fanned this round out — shared
    workers route the round's Results back on it instead of the config
    default.  None outside cluster mode.

    ``cancelled_at``: the receipt, ``(time.time(), time.monotonic())``, of
    the Found or Cancel whose ``cancel`` set ``ev`` (None before), where
    ``worker.cancel_s`` starts.
    """

    __slots__ = ("ev", "superseded", "round_id", "reply_to", "cancelled_at")

    def __init__(self, round_id=None, reply_to=None):
        self.ev = threading.Event()
        self.superseded = False
        self.round_id = round_id
        self.reply_to = reply_to
        self.cancelled_at = None

    def cancel(self, received) -> None:
        """A protocol cancel received at ``received``: stamp it, wake the miner."""
        self.cancelled_at = received
        self.ev.set()


class WorkerRPCHandler:
    """RPC service ``WorkerRPCHandler`` (Mine / Found / Cancel)."""

    def __init__(self, tracer: Tracer, result_queue: "queue.Queue", backend,
                 cache_file: Optional[str] = None, scheduler=None,
                 device: str = "cuda"):
        self.tracer = tracer
        self.result_queue = result_queue
        self.backend = backend
        self.device = device
        # continuous-batching scheduler (sched/engine.py): when set,
        # miner threads submit slots to its shared device loop instead
        # of each owning backend.search — worker.active_searches then
        # stays at the loop's own concurrency (bounded), and the
        # pile-up signal moves to sched.active_slots/run_queue_depth
        self.scheduler = scheduler
        self.result_cache = ResultCache(persist_path=cache_file or None)
        self._tasks: Dict[TaskKey, TaskRound] = {}
        self._tasks_lock = threading.Lock()
        # miner threads currently inside backend.search — the
        # admission-control contention signal (the multi-request
        # pile-up on one device)
        self._active_searches = 0

    def _searches_delta(self, d: int) -> None:
        with self._tasks_lock:
            self._active_searches += d
            # gauge published under the same lock that computed it: two
            # threads publishing outside would let a stale count
            # overwrite a fresher one and stick
            metrics.gauge("worker.active_searches", self._active_searches)

    # -- task table (worker.go:403-421) -----------------------------------
    # every mutation re-gauges worker.mine_queue_depth, so the reading
    # tracks the LIVE depth, not the high-water mark
    def _task_set(self, key: TaskKey, round_: TaskRound) -> None:
        with self._tasks_lock:
            stale = self._tasks.get(key)
            if stale is not None:
                # a repeat Mine for a key whose previous round is still
                # running (coordinator retry after reassignment/timeouts):
                # mark the zombie superseded and wake it so it stops
                # burning the device — silently (see TaskRound)
                stale.superseded = True
                stale.ev.set()
            self._tasks[key] = round_
            metrics.gauge("worker.mine_queue_depth", len(self._tasks))

    def _task_pop(self, key: TaskKey) -> Optional[TaskRound]:
        with self._tasks_lock:
            out = self._tasks.pop(key, None)
            metrics.gauge("worker.mine_queue_depth", len(self._tasks))
            return out

    def _task_take(self, key: TaskKey, rid) -> Optional[TaskRound]:
        """Pop the active round for ``key`` given a Found tagged ``rid``.

        Matching round (or a None wildcard on either side): returned to
        the caller for the normal cancel path.  On a mismatch, round ids
        are ordered by issue time (nodes/coordinator.py new_round_id), so
        the worker can tell which side is stale:

        * Found NEWER than the entry: the entry is a zombie from a round
          whose cancel never reached us — pop it and wake it superseded
          (silent unwind) so its miner neither burns the device nor parks
          in ev.wait(), and Ping's liveness count stays honest.
        * Found OLDER than the entry (a delayed cancel from a previous
          round surfacing after a new Mine): the live round must NOT be
          touched — the caller treats the Found as cache-update-only, and
          the live miner stops on its own via the cache-aware cancel
          check, delivering the installed secret as its (current-round)
          result.
        * Found from a DIFFERENT round-id namespace (two pool members
          fanning to this shared worker — docs/CLUSTER.md): the two
          coordinators' clocks and epochs are unrelated, so neither
          "newer" verdict is sound.  Treated like "older": the live
          round is untouched (its own coordinator owes it a matching
          Found), the foreign Found is cache-update-only, and the live
          miner stops via the cache-aware cancel check if the installed
          secret satisfies it.
        """
        with self._tasks_lock:
            cur = self._tasks.get(key)
            if cur is None:
                return None
            if rid is None or cur.round_id is None or cur.round_id == rid:
                del self._tasks[key]
                metrics.gauge("worker.mine_queue_depth", len(self._tasks))
                return cur
            if _rid_split(rid)[0] != _rid_split(cur.round_id)[0]:
                return None
            if _rid_order(rid) > _rid_order(cur.round_id):
                del self._tasks[key]
                metrics.gauge("worker.mine_queue_depth", len(self._tasks))
                cur.superseded = True
                cur.ev.set()
            return None

    def _task_get(self, key: TaskKey) -> Optional[TaskRound]:
        with self._tasks_lock:
            return self._tasks.get(key)

    # -- RPCs ---------------------------------------------------------------
    def _default_model(self) -> str:
        return (self.scheduler.model.name if self.scheduler is not None
                else _backend_model_name(self.backend))

    def Mine(self, params) -> dict:
        metrics.inc("worker.mine_rpcs")
        key = _key(params)
        # optional per-request hash model (docs/SERVING.md mixed-hash
        # serving): requests off the worker's default model need the
        # batching scheduler's registry dispatch — without it the
        # single-model backend cannot honor the request, and failing
        # the RPC here (before the task registers) is the honest reply
        hash_model = params.get("hash_model") or None
        if hash_model is not None and hash_model != self._default_model():
            if self.scheduler is None:
                raise RuntimeError(
                    f"worker serves {self._default_model()!r} and has no "
                    f"batching scheduler for mixed-hash requests "
                    f"(got hash_model={hash_model!r})"
                )
            # validate the model HERE, not in the miner thread: an
            # unknown name (or a never-admitted model, engine._solo)
            # raising inside the daemon thread would produce no result,
            # no acks and no error reply — the caller would wait out
            # its full timeout instead of getting this honest refusal.
            # The port's scheduler refuses the same models the
            # reference's does (ops/search_step.py).
            from ..models.registry import get_hash_model
            from ..ops.search_step import XLA_SERVING_COMPILE_IMPRACTICAL
            try:
                model = get_hash_model(hash_model)
            except (KeyError, ValueError) as exc:
                raise RuntimeError(
                    f"unknown hash_model {hash_model!r}"
                ) from exc
            if model.name in XLA_SERVING_COMPILE_IMPRACTICAL:
                raise RuntimeError(
                    f"hash_model {model.name!r} is never admitted to the "
                    f"XLA serving path (XLA_SERVING_COMPILE_IMPRACTICAL): "
                    f"serve it from a worker whose configured backend is "
                    f"its Pallas kernel"
                )
        # capability-weighted rounds (docs/FLEET.md) ship the shard's
        # byte range EXPLICITLY instead of the worker_byte/worker_bits
        # algebra; validate at the RPC so a malformed range is an
        # honest error reply, not a silent miner-thread death
        tb_range = None
        if params.get("tb_count") is not None:
            tb_lo = int(params.get("tb_lo") or 0)
            tb_count = int(params["tb_count"])
            if not (0 <= tb_lo <= 255 and 1 <= tb_count <= 256 - tb_lo):
                raise RuntimeError(
                    f"invalid weighted shard range tb_lo={tb_lo} "
                    f"tb_count={tb_count}"
                )
            tb_range = (tb_lo, tb_count)
        round_ = TaskRound(params.get("round"),
                           reply_to=params.get("coord_addr") or None)
        self._task_set(key, round_)

        trace = self.tracer.receive_token(decode_token(params["token"]))
        trace.record_action(
            act.WorkerMine(
                nonce=key[0], num_trailing_zeros=key[1], worker_byte=key[2]
            )
        )
        # the device timeline (runtime/spans.py): the Mine's receipt to
        # its search's first launch, finished on the miner thread
        # distpow: ok unclosed-span -- _mine's SPANS.launched() is the
        # single finish point: at the search's first launch, else in its
        # finally
        started = SPANS.begin("worker.mine_start", trace_id=trace.trace_id,
                              node=self.tracer.identity) \
            if SPANS.device_timing else None
        threading.Thread(
            target=self._mine,
            args=(key, int(params["worker_bits"]), round_, trace,
                  hash_model, tb_range, started),
            daemon=True,
        ).start()
        return {}

    def Found(self, params) -> dict:
        received = (time.time(), time.monotonic())
        metrics.inc("worker.found_rpcs")
        key = _key(params)
        secret = bytes(params["secret"])
        trace = self.tracer.receive_token(decode_token(params["token"]))
        # the dominance cache is single-model (entries satisfy lookups
        # purely by (nonce, ntz)): a secret solving under an off-default
        # hash must never be installed where a default-model lookup
        # could replay it (docs/SERVING.md)
        cacheable = (params.get("hash_model") or None) in (
            None, self._default_model())
        round_ = self._task_take(key, params.get("round"))
        if round_ is not None:
            if cacheable:
                self.result_cache.add(key[0], key[1], secret, trace)
            round_.cancel(received)
        else:
            # no active task for this round: cache-update-only round
            # (late-result re-broadcast or repeat Found), worker.go:212-230
            trace.record_action(
                act.WorkerCancel(
                    nonce=key[0], num_trailing_zeros=key[1], worker_byte=key[2]
                )
            )
            if cacheable:
                self.result_cache.add(key[0], key[1], secret, trace)
            self._send_result(key, None, trace, params.get("round"),
                              reply_to=params.get("coord_addr") or None)
        return {}

    def Cancel(self, params) -> dict:
        received = (time.time(), time.monotonic())
        metrics.inc("worker.cancel_rpcs")
        key = _key(params)
        round_ = self._task_pop(key)
        if round_ is None:
            raise RuntimeError(f"no active task for cancel: {key}")
        round_.cancel(received)
        return {}

    def Ping(self, params) -> dict:
        """Liveness probe for the coordinator's failure detector
        (FailurePolicy="reassign"; no reference equivalent — the
        reference has no liveness checking, SURVEY.md section 5)."""
        return {"worker_tasks": len(self._tasks)}

    def Stats(self, params) -> dict:
        """Metrics snapshot (runtime/metrics.py; no reference
        equivalent).  ``python -m distpow_tpu.cli.stats`` prints it."""
        # resource sentinels ride every Stats snapshot (runtime/health.py)
        SENTINELS.sample()
        # launches that searches left in flight and that have since ended
        resolve_past_hit()
        snap = metrics.snapshot()
        snap["role"] = "worker"
        snap["backend"] = type(self.backend).__name__
        snap["device"] = str(self.device)
        # the port's own: launches of each CUDA kernel form in this
        # process (ops/hash_cuda.py LAUNCHES; the wrappers count where
        # they launch), the forms launched at least once
        snap["kernel_launches"] = {name: c.value for name, c in LAUNCHES.items() if c.value}
        snap["scheduler"] = "batching" if self.scheduler is not None else "off"
        snap["active_tasks"] = len(self._tasks)
        snap["cache_entries"] = len(self.result_cache)
        snap["watchdog_armed"] = WATCHDOG.running
        return snap

    # -- miner (worker.go:258-401) -----------------------------------------
    def _send_result(self, key: TaskKey, secret: Optional[bytes], trace,
                     round_id=None, hash_model: Optional[str] = None,
                     reply_to: Optional[str] = None) -> None:
        metrics.inc("worker.results_sent")
        msg = {
            # bytes fields travel raw: wire v2 ships them verbatim,
            # the JSON codec renders them as the int arrays every
            # earlier version sent (runtime/rpc.py _json_default)
            "nonce": bytes(key[0]),
            "num_trailing_zeros": key[1],
            "worker_byte": key[2],
            "secret": bytes(secret) if secret is not None else None,
            "round": round_id,
            "token": wire_token(trace.generate_token()),
        }
        if hash_model is not None:
            # off-default-model result (docs/SERVING.md): tagged so the
            # coordinator's single-model dominance cache skips it — a
            # replayed off-model secret would fail default-model checks.
            # Absent for default-model results, keeping those frames
            # wire-identical to every earlier version on both codecs.
            msg["hash_model"] = hash_model
        if reply_to is not None:
            # pooled round (docs/CLUSTER.md): the forwarder pops this
            # and delivers to the round's OWN coordinator — the key
            # never reaches the wire, so Result frames stay identical
            msg["coord_addr"] = reply_to
        self.result_queue.put(msg)
        # forwarder backlog: grows when the coordinator is slow/away
        # (qsize is advisory under concurrency — a gauge, not a ledger)
        metrics.gauge("worker.forward_queue_depth", self.result_queue.qsize())

    def _finish_found(self, key: TaskKey, secret: bytes, round_: TaskRound,
                      trace, hash_model: Optional[str] = None) -> None:
        """Result -> block for Found -> WorkerCancel -> nil ACK ordering."""
        trace.record_action(
            act.WorkerResult(
                nonce=key[0], num_trailing_zeros=key[1],
                worker_byte=key[2], secret=secret,
            )
        )
        self._send_result(key, secret, trace, round_.round_id,
                          hash_model=hash_model, reply_to=round_.reply_to)
        round_.ev.wait()  # coordinator always sends Found (worker.go:375-379)
        if round_.superseded:
            # replaced by a newer Mine for this key while waiting: the
            # nil ACK belongs to the new round's miner, not us
            return
        trace.record_action(
            act.WorkerCancel(
                nonce=key[0], num_trailing_zeros=key[1], worker_byte=key[2]
            )
        )
        self._send_result(key, None, trace, round_.round_id,
                          reply_to=round_.reply_to)

    def _mine(self, key: TaskKey, worker_bits: int, round_: TaskRound,
              trace, hash_model=None, tb_range=None, started=None) -> None:
        # forensics binding (runtime/spans.py, docs/FORENSICS.md): the
        # miner thread carries its request's trace id so the layers
        # below the RPC surface — the search drivers' launch/poll spans
        # and the scheduler's slot spans — attribute to this Mine
        # without threading ids through every call
        with SPANS.bind(trace.trace_id, self.tracer.identity):
            SPANS.await_launch(started)
            try:
                self._mine_bound(key, worker_bits, round_, trace, hash_model,
                                 tb_range)
            finally:
                SPANS.launched()  # a Mine that launched nothing ends it here

    @staticmethod
    def _observe_cancel(round_: TaskRound, returned: float) -> None:
        """``worker.cancel_s`` and a ``worker.cancel`` span: the receipt of
        the Found or Cancel that stopped the search to its return."""
        ts, t0 = round_.cancelled_at
        # at least 0: a sibling's Found may have stopped the search first
        cancel_s = max(0.0, returned - t0)
        metrics.observe("worker.cancel_s", cancel_s)
        SPANS.record("worker.cancel", ts, cancel_s)

    def _mine_bound(self, key: TaskKey, worker_bits: int, round_: TaskRound,
                    trace, hash_model=None, tb_range=None) -> None:
        nonce, ntz, worker_byte = key
        t0 = time.monotonic()
        # mixed-hash requests bypass the (single-model) dominance cache
        # entirely: its entries solve under the DEFAULT model, and a
        # replayed default-model secret would fail the requested hash
        off_model = (hash_model is not None
                     and hash_model != self._default_model())
        cached = None if off_model else self.result_cache.get(
            nonce, ntz, trace)
        if cached is not None:
            self._finish_found(key, cached, round_, trace)
            return

        def cancel_check() -> bool:
            # also stop when a satisfying secret lands in the cache
            # mid-search (a Found for a sibling task, or one this
            # coordinator could no longer deliver to us) — a worker the
            # coordinator abandoned must not burn the device forever.
            # satisfies() is the unmetered lookup: this polls every batch
            # and must not pollute the cache.hit/miss protocol counters
            if round_.ev.is_set():
                return True
            return (not off_model
                    and self.result_cache.satisfies(nonce, ntz) is not None)

        if tb_range is not None:
            # weighted shard (docs/FLEET.md): the coordinator already
            # sized this worker's slice by its advertised rate; the
            # contiguous run feeds every backend exactly like an
            # algebra-expanded one
            tbs = list(range(tb_range[0], tb_range[0] + tb_range[1]))
        else:
            tbs = partition.thread_bytes(worker_byte, worker_bits)
        # one "worker.solve" span per REAL device search (cache replays
        # returned above): the per-shard segment forensics attributes a
        # slow round to (docs/FORENSICS.md) — the context-manager form
        # records error outcomes too, so a dead miner thread still
        # leaves its span
        with SPANS.span("worker.solve", shard=worker_byte,
                        model=hash_model or self._default_model()) as sp:
            if self.scheduler is not None:
                # scheduler path: this thread only parks on the slot's
                # completion — the engine's single loop owns the device,
                # so the active_searches pile-up the contention stress
                # test recorded cannot form (docs/SCHEDULER.md).
                # Mixed-hash requests ride the same slot table: the
                # engine packs per-model sub-batches into one launch
                # (docs/SERVING.md)
                secret = self.scheduler.search(
                    nonce, ntz, tbs, cancel_check=cancel_check,
                    hash_model=hash_model,
                )
            else:
                self._searches_delta(+1)
                try:
                    secret = self.backend.search(
                        nonce, ntz, tbs, cancel_check=cancel_check
                    )
                finally:
                    self._searches_delta(-1)
            sp.annotate(outcome="found" if secret is not None
                        else "no-result")
        returned = time.monotonic()
        if round_.superseded:
            # a newer Mine owns this key now; anything we emit would be
            # mis-attributed to its round (see TaskRound) — exit silently
            return
        if secret is not None:
            # a REAL device solve (cache replays return above): this is
            # the worker-side latency distribution of the paper's race.
            # The per-model family feeds the cluster aggregation's
            # per-model breakdown and the per-model SLO objectives
            # (distpow_tpu/obs/, docs/SLO.md) — per-hash performance
            # spread is why serving targets cannot be global.
            solve_s = time.monotonic() - t0
            metrics.observe("worker.solve_s", solve_s,
                            trace_id=trace.trace_id)
            metrics.observe(
                f"worker.solve_s.{hash_model or self._default_model()}",
                solve_s, trace_id=trace.trace_id,
            )
            self._finish_found(key, secret, round_, trace,
                               hash_model=hash_model if off_model else None)
            return
        if round_.ev.is_set():
            # cancelled by a Found/Cancel RPC: its receipt -> the search
            # returned, the per-worker half of cancel propagation
            self._observe_cancel(round_, returned)
        else:
            cached = None if off_model else self.result_cache.get(
                nonce, ntz, None)
            if cached is not None:
                # cache-triggered stop.  Our own round's Found is
                # usually microseconds behind the install that stopped
                # us — Found writes the cache BEFORE it fires the
                # cancel event, so a cancel_check can land exactly in
                # that window.  Give the in-flight Found a beat: if it
                # arrives, this is an ordinary cancellation (below),
                # not an abandonment — minting a late result here would
                # cost the coordinator a full Found-rebroadcast round
                # of traffic for a secret it already has.
                if not round_.ev.wait(0.05):
                    # genuinely abandoned (our Found never came):
                    # deliver the cached secret as this task's result
                    # so the owning request's protocol still sees a
                    # result, never a spurious first-message ACK
                    self._finish_found(key, cached, round_, trace)
                    return
                if round_.superseded:
                    # a newer Mine took the key while we waited
                    return
                self._observe_cancel(round_, returned)

        # cancelled mid-search: two nil ACKs (worker.go:320-345)
        trace.record_action(
            act.WorkerCancel(
                nonce=nonce, num_trailing_zeros=ntz, worker_byte=worker_byte
            )
        )
        self._send_result(key, None, trace, round_.round_id,
                          reply_to=round_.reply_to)
        self._send_result(key, None, trace, round_.round_id,
                          reply_to=round_.reply_to)


class Worker:
    """Worker process object: RPC server + result forwarder
    (NewWorker/InitializeWorkerRPCs, worker.go:116-165 +
    cmd/worker/main.go:27-36).

    ``device`` is where the backend and the scheduler run: the card
    (``"cuda"``, the default, or ``"cuda:<i>"``) or, when the caller asks
    for it, ``"cpu"``, where the kernels' wrappers run their plain
    PyTorch versions.  Without a GPU a card device raises."""

    def __init__(self, config: WorkerConfig, sink=None, device="cuda"):
        self.config = config
        self._armed_watchdog = False
        self.device = _require_device(device)
        maybe_init_distributed(
            getattr(config, "JaxCoordinator", ""),
            getattr(config, "JaxNumProcesses", 1),
            getattr(config, "JaxProcessId", 0),
            device=self.device,
        )
        if getattr(config, "CompilationCacheDir", ""):
            # the kernels' libraries are built there, and a later boot on
            # the same machine loads them instead of running nvcc again
            _build.set_build_dir(config.CompilationCacheDir)
        tdir = getattr(config, "TelemetryDir", "") or ""
        if tdir:
            # flight-recorder journal + dump-on-fault directory
            # (runtime/telemetry.py; off by default — memory-only ring)
            RECORDER.configure(
                journal_path=os.path.join(
                    tdir, f"{config.WorkerID}.telemetry.jsonl"
                ),
                dump_dir=tdir,
            )
        self.tracer = make_tracer(
            config.WorkerID, config.TracerServerAddr, config.TracerSecret,
            sink=sink,
        )
        self.coordinator = RPCClient(config.CoordAddr)
        # distpow: ok bounded-queue -- the forwarder queue must never
        # drop or block the miner: every message is owed to the
        # coordinator's ack ledger (losing one wedges the round), depth
        # is bounded by in-flight rounds x2 in practice, and the
        # backlog is observable (worker.forward_queue_depth gauge)
        self.result_queue: "queue.Queue" = queue.Queue()
        backend = get_backend(
            config.Backend,
            hash_model=config.HashModel,
            batch_size=config.BatchSize,
            mesh_devices=config.MeshDevices,
            max_launch=config.MaxLaunchCandidates or None,
            interpret=getattr(config, "PallasInterpret", False),
            loop=getattr(config, "SearchLoop", "persistent") or "persistent",
            device=self.device,
        )
        self.scheduler = None
        if (getattr(config, "Scheduler", "off") or "off") == "batching":
            # continuous-batching serving plane (docs/SCHEDULER.md):
            # the engine owns the device; the configured backend stays
            # as the fallback for shapes the packed step can't express
            from ..sched.engine import BatchingScheduler

            self.scheduler = BatchingScheduler(
                hash_model=config.HashModel,
                batch_size=config.BatchSize,
                max_slots=getattr(config, "SchedMaxSlots", 8) or 8,
                fallback=backend,
                extra_models=tuple(
                    getattr(config, "SchedHashModels", ()) or ()),
                lane=getattr(config, "SchedLane", "auto") or "auto",
                device=self.device,
            )
        self.handler = WorkerRPCHandler(
            self.tracer, self.result_queue, backend,
            cache_file=getattr(config, "CacheFile", "") or None,
            scheduler=self.scheduler,
            device=str(self.device),
        )
        self.server = RPCServer()
        self.server.register("WorkerRPCHandler", self.handler)
        # role-agnostic Stats alias for error-free auto-role discovery
        # by the fleet scraper (runtime/rpc.py StatsOnly, docs/SLO.md)
        self.server.register("Node", StatsOnly(self.handler))
        self.bound_addr: Optional[str] = None
        self._forwarder: Optional[threading.Thread] = None
        # per-destination delivery queues for pooled rounds
        # (docs/CLUSTER.md): keyed by the round's stamped reply-to
        # address ("" = the config default); the forwarder demux
        # creates entries, delivery loops drain them
        self._forward_subqueues: Dict[str, "queue.Queue"] = {}
        self._stopping = threading.Event()
        # elastic membership (distpow_tpu/fleet/, docs/FLEET.md):
        # opt-in — a FleetRegister=false worker is a static config
        # entry and behaves byte-identically to every earlier version.
        # The agent is built lazily in start_fleet_agent() because the
        # registration must advertise the REAL bound address.
        self.fleet_agent = None
        self._backend = backend
        # boot warm-up state: set when it ends (also when there was none),
        # with its seconds and, where it failed, the error
        self.warmed = threading.Event()
        self.warmup_s: Optional[float] = None
        self.warmup_error: Optional[BaseException] = None
        self._start_warmup(backend)
        hang_timeout = float(getattr(config, "DeviceHangTimeoutS", 0.0) or 0.0)
        if hang_timeout > 0:
            # a hung accelerator dispatch makes this worker a zombie the
            # coordinator's liveness probes cannot see through; the
            # watchdog converts it into a visible death (and shard
            # reassignment under FailurePolicy="reassign") —
            # runtime/watchdog.py.  Refcounted: in-process multi-worker
            # harnesses share one clock (first timeout wins), and it
            # stops when the last armed worker shuts down.  Armed LAST,
            # after every fallible constructor step INCLUDING
            # _start_warmup (a malformed WarmupNonceLens raising after
            # the acquire would leak the ref forever): an
            # init failure must not leak a ref the matching shutdown()
            # will never release.  The warmup thread racing ahead of the
            # acquire is covered because active() counts even while the
            # watchdog is stopped (watchdog.py active()).
            WATCHDOG.acquire(hang_timeout)
            self._armed_watchdog = True

    def _start_warmup(self, backend) -> None:
        """Build and load the kernels of the serving layouts at boot, and
        launch each once, so the first Mine RPC is pure dispatch (the
        reference compiles its XLA programs here — see
        WorkerConfig.WarmupNonceLens).

        A failure does not stop the worker: it is logged with its error and
        counted (``worker.warmup_failures``), and the first Mine at a failed
        layout builds again and raises the build's own error.  A warm-up
        build racing the first Mine is serialized by ``_build``'s lock."""
        lens = list(self.config.WarmupNonceLens or [])
        widths = list(self.config.WarmupWidths or [])
        if not lens or not widths or not hasattr(backend, "warmup"):
            self.warmed.set()
            return

        def warm():
            t0 = time.monotonic()
            try:
                backend.warmup(lens, widths)
                log.info("%s: warmup done (%d layouts)",
                         self.config.WorkerID, len(lens) * len(widths))
            except Exception as exc:
                metrics.inc("worker.warmup_failures")
                self.warmup_error = exc
                log.error("%s: warmup failed; the first Mine will build "
                          "again and raise: %r", self.config.WorkerID, exc)
            finally:
                self.warmup_s = time.monotonic() - t0
                self.warmed.set()

        threading.Thread(target=warm, daemon=True).start()

    def initialize_rpcs(self) -> str:
        self.bound_addr = self.server.listen(self.config.ListenAddr)
        self.server.serve_in_background()
        log.info("serving %s RPCs on %s", self.config.WorkerID, self.bound_addr)
        return self.bound_addr

    def start_fleet_agent(self) -> None:
        """Join the coordinator's fleet (docs/FLEET.md): self-calibrate,
        register with the capability advertisement, keep the lease via
        heartbeats.  No-op unless ``FleetRegister`` is set — static
        config-file workers are pre-registered permanent leases on the
        coordinator side and must not double-register.  Requires
        ``initialize_rpcs`` (the advertisement carries the bound
        address)."""
        if self.fleet_agent is not None or \
                not getattr(self.config, "FleetRegister", False):
            return
        if self.bound_addr is None:
            raise RuntimeError("initialize_rpcs() before start_fleet_agent()")
        from ..fleet import Capability, FleetAgent, calibrate_mhs

        mhs = float(getattr(self.config, "FleetMHS", 0.0) or 0.0)
        if mhs <= 0:
            # calibrate through the SERVING path: with the batching
            # scheduler on, requests run through its lane planner
            # (sched/lanes.py — mesh/pallas launch lanes), so the
            # advertised rate must be measured through the same facade
            # or a multi-device worker under-advertises by n_dev x
            mhs = calibrate_mhs(
                self.scheduler or self._backend,
                budget_s=float(
                    getattr(self.config, "FleetCalibrationS", 0.2) or 0.0),
            )
        cap = Capability(
            backend=self.config.Backend,
            hash_models=tuple(dict.fromkeys(
                [self.config.HashModel]
                + list(getattr(self.config, "SchedHashModels", ()) or ()))),
            mhs=mhs,
            max_slots=(getattr(self.config, "SchedMaxSlots", 0)
                       if (getattr(self.config, "Scheduler", "off")
                           or "off") == "batching" else 0),
        )
        self.fleet_agent = FleetAgent(
            worker_id=self.config.WorkerID,
            coord_addr=self.config.CoordAddr,
            listen_addr=self.bound_addr,
            capability=cap,
            heartbeat_s=float(
                getattr(self.config, "FleetHeartbeatS", 0.0) or 0.0),
            drain_timeout_s=float(
                getattr(self.config, "FleetDrainTimeoutS", 20.0) or 20.0),
        )
        self.fleet_agent.start()

    def start_forwarder(self) -> None:
        """Drain the result queue into ``CoordRPCHandler.Result`` calls.

        The reference forwarder is fire-and-forget on a connection dialed
        once at boot (cmd/worker/main.go:27-36): a coordinator restart
        silently black-holes every subsequent result.  Here each delivery
        is confirmed (future result with a timeout) and a failure
        re-dials the coordinator with backoff, retrying the SAME message
        — a restarted coordinator receives the result, installs it in
        its (journal-backed) cache, and a client retry completes from
        that cache.

        Coordinator pool (docs/CLUSTER.md): pooled rounds stamp their
        owner's worker-facing address as ``coord_addr``, and delivery
        runs PER DESTINATION — one delivery loop per coordinator, fed
        by a demux of the shared result queue — so a dead pool member's
        retry backoff can never head-of-line-block results owed to a
        live one (messages to the dead member park on ITS loop alone
        and flow the moment it restarts).  Single-coordinator workers
        see exactly one destination and keep the historical per-message
        behavior.
        """

        def _result_trace_id(res) -> int:
            """Trace id straight out of the message's (self-contained
            JSON) tracing token, WITHOUT a tracer side effect — the
            forwarder must not tick vector clocks."""
            try:
                return int(json.loads(
                    bytes(res.get("token") or b"").decode())["trace_id"])
            except (ValueError, KeyError, TypeError):
                return 0

        def _backlog() -> int:
            # total undelivered results across demux + every
            # destination: the signal the gauge existed for ("grows
            # when the coordinator is slow/away").  The values are
            # SNAPSHOTTED: delivery threads call this while the demux
            # may be inserting a new destination, and iterating the
            # live dict would RuntimeError the delivery thread dead
            # mid-message
            return self.result_queue.qsize() + sum(
                q.qsize() for q in list(self._forward_subqueues.values()))

        def delivery_loop(src: "queue.Queue", addr: str) -> None:
            """Deliver ``src``'s messages in order to one destination.
            ``addr`` empty = the config-default coordinator (whose
            connection object doubles as the protocol client and is
            re-dialed in place); otherwise a pool member dialed
            lazily."""
            backoff = 0.2
            extra: Optional[RPCClient] = None
            while True:
                res = src.get()
                metrics.gauge("worker.forward_queue_depth", _backlog())
                if res is None:
                    if extra is not None:
                        try:
                            extra.close()
                        except OSError:
                            pass
                    return
                tid = _result_trace_id(res) if SPANS.enabled else 0
                # the delivery clock starts ONCE per message, outside
                # the retry loop: a delivery that burned attempts and
                # backoff against an unreachable coordinator must show
                # its full stall on the timeline, not just the final
                # (fast) successful attempt
                fwd_ts = time.time()
                fwd_t0 = time.monotonic()
                attempts = 0
                while not self._stopping.is_set():
                    try:
                        attempts += 1
                        if addr:
                            if extra is None:
                                extra = RPCClient(addr)
                            client = extra
                        else:
                            client = self.coordinator
                        client.go(
                            "CoordRPCHandler.Result", res
                        ).result(timeout=10.0)
                        if tid:
                            # the delivery leg of the request timeline:
                            # a delayed/retried Result shows up HERE,
                            # not in worker.solve — exactly the segment
                            # that otherwise hides between two nodes'
                            # clocks (docs/FORENSICS.md)
                            SPANS.record(
                                "worker.result_forward", fwd_ts,
                                time.monotonic() - fwd_t0, trace_id=tid,
                                node=self.config.WorkerID,
                                worker_byte=int(res["worker_byte"]),
                                attempts=attempts,
                                kind=("result" if res.get("secret")
                                      is not None else "ack"),
                            )
                        backoff = 0.2
                        break
                    except Exception as exc:
                        metrics.inc("worker.forward_retries")
                        RECORDER.record(
                            "worker.forward_retry",
                            worker=self.config.WorkerID,
                            queue_depth=_backlog(),
                            error=str(exc),
                        )
                        log.warning(
                            "%s: result delivery to %s failed (%s); "
                            "re-dialing in %.1fs",
                            self.config.WorkerID,
                            addr or self.config.CoordAddr, exc, backoff,
                        )
                        if self._stopping.wait(backoff):
                            return
                        backoff = min(backoff * 2, 5.0)
                        # tear down exactly the connection that failed;
                        # other destinations' loops are independent
                        if addr:
                            if extra is not None:
                                try:
                                    extra.close()
                                except OSError:
                                    pass
                                extra = None
                        else:
                            try:
                                self.coordinator.close()
                            except OSError:
                                pass
                            try:
                                self.coordinator = RPCClient(
                                    self.config.CoordAddr)
                            except OSError:
                                continue

        def destination(addr: str) -> "queue.Queue":
            q = self._forward_subqueues.get(addr)
            if q is None:
                # distpow: ok bounded-queue -- protocol-bounded like
                # the result queue it demuxes: depth is the in-flight
                # rounds x2 owed to ONE coordinator, every message is
                # owed to that coordinator's ack ledger (dropping one
                # wedges its round), and the backlog is observable via
                # worker.forward_queue_depth
                q = self._forward_subqueues[addr] = queue.Queue()
                threading.Thread(
                    target=delivery_loop, args=(q, addr), daemon=True,
                    name=f"forward-{addr or 'default'}",
                ).start()
            return q

        def forward():
            # demux only — never blocks on a destination, so one dead
            # pool member cannot stall the others' deliveries
            while True:
                res = self.result_queue.get()
                if res is None:
                    for q in list(self._forward_subqueues.values()):
                        q.put(None)
                    return
                # pooled rounds stamp their owner's address; popped
                # HERE so the Result frame on the wire stays identical
                reply_to = res.pop("coord_addr", None) or ""
                if reply_to == self.config.CoordAddr:
                    reply_to = ""
                destination(reply_to).put(res)
                metrics.gauge("worker.forward_queue_depth", _backlog())

        self._forwarder = threading.Thread(target=forward, daemon=True)
        self._forwarder.start()

    def run_forever(self, stop: Optional[threading.Event] = None) -> None:
        """Boot the full serving surface and park.  ``stop`` lets a
        signal handler (cli/worker.py) request a graceful teardown —
        fleet drain first, then shutdown; without one this never
        returns (reference parity)."""
        self.initialize_rpcs()
        self.start_forwarder()
        self.start_fleet_agent()
        if stop is None:
            threading.Event().wait()
            return
        stop.wait()
        log.info("%s: stop requested; draining and shutting down",
                 self.config.WorkerID)
        self.shutdown()

    def shutdown(self) -> None:
        try:
            if self.fleet_agent is not None:
                # graceful leave FIRST, while the serving plane is still
                # up: Fleet.Drain blocks (bounded) until this worker's
                # in-flight rounds complete, so a drain mid-round
                # finishes the shard instead of orphaning it
                self.fleet_agent.stop(drain=True)
                self.fleet_agent = None
            self._stopping.set()
            if self.scheduler is not None:
                # first: parked miner threads unblock (their slots
                # finish as cancelled) before the forwarder drains
                self.scheduler.close()
            self.result_queue.put(None)
            self.server.shutdown()
            self.coordinator.close()
            self.handler.result_cache.close()
            self.tracer.close()
        finally:
            if self._armed_watchdog:
                # last armed worker out stops the clock, so it cannot
                # govern unrelated later searches in the process — nor
                # vanish while other armed workers still serve
                # (refcount).  In a finally: a close() failure above
                # must not leak the ref.
                WATCHDOG.release()
                self._armed_watchdog = False
