"""In-process cluster + loadgen + fleet scrape + SLO assertion — the
observe-assert-generate triad in one callable (package docstring).

``run_load_slo`` boots a cluster, replays a :class:`.loadgen.LoadMix`
open-loop against it, sweeps the nodes' Stats RPCs through the fleet
scraper while traffic runs, and judges the merged run-window snapshot
against a declarative SLO config (docs/SLO.md): localhost RPC, seeded
arrivals, and workers that serve on the card.

Device rule: the port's :class:`InProcCluster` boots ``cuda``-backend
workers on ``device="cuda"`` unless the caller asks for another backend
and the CPU (``backend="python"`` or ``"torch"``, ``device="cpu"``, as
the tests do); without a GPU it raises.  ``run_load_slo`` and
``run_soak`` boot their own cluster with that default; a caller that
wants the CPU passes ``cluster=``.  ``Worker`` is
imported inside :class:`InProcCluster`, so this module, and the soak
CLI attached to running processes, import no ``torch``.

Registry caveat (runtime/metrics.py): in-process nodes share ONE
process-wide registry, so scraping the coordinator *and* its workers
returns near-identical snapshots — counter sums over them would
multiply by the node count.  The harness therefore scrapes the
COORDINATOR alone for the judged view (its snapshot already covers the
whole in-process cluster) and uses the worker targets only where
multiplicity is harmless by construction: the merge-vs-single-node
percentile cross-check (percentile estimates are invariant under
uniform count scaling), and the stale-node machinery.  Real multi-
registry merging is exercised by the scrape tests over child
processes.

The port's own copy of the reference's ``load/harness.py``.
"""

from __future__ import annotations

import queue as _queue
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from ..nodes import Client, Coordinator
from ..obs.merge import BUCKET_RATIO, delta_merged
from ..obs.scrape import FleetScraper, NodeTarget
from ..obs.slo import SLOEngine, SLOVerdict, load_slo_config
from ..runtime import faults
from ..runtime.config import ClientConfig, CoordinatorConfig, WorkerConfig
from .loadgen import Arrival, LoadMix, OpenLoopRunner, build_schedule


def exact_percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over raw samples — the combined-stream
    oracle the merged log-bucket estimates are cross-checked against."""
    if not samples:
        return None
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
    return s[idx]


class InProcCluster:
    """coordinator pool + N shared workers + one client, all in this
    process.

    The production shape of an in-process test stack, packaged as
    product code.  Binds on ':0' and wires real addresses afterwards — no
    port races.

    ``backend`` and ``device`` are each worker's (``Worker(...,
    device=)``): by default the CUDA kernels on the card.  The device is
    checked before anything boots, so without a GPU a card device raises
    and no node is left behind.

    ``n_coordinators > 1`` boots the scale-out shape (docs/CLUSTER.md):
    a pool of coordinators over ONE shared worker fleet, each member's
    ring installed via ``set_cluster_peers`` once the real client
    addresses exist, and the client in powlib cluster mode (consistent-
    hash routing, sibling hedging, failover).  ``n_coordinators=1``
    keeps the historical single-coordinator cluster byte-identical.
    """

    def __init__(self, n_workers: int = 2, backend: str = "cuda",
                 coord_extra: Optional[dict] = None,
                 worker_extra: Optional[dict] = None,
                 client_extra: Optional[dict] = None,
                 n_coordinators: int = 1, device="cuda"):
        # the worker (and with it torch) loads here, not at import: the
        # soak CLI attached to running processes imports this module
        from ..backends.cuda_backend import _require_device
        from ..nodes.worker import Worker

        device = _require_device(device)
        self.coordinators: List[Coordinator] = [
            Coordinator(CoordinatorConfig(
                ClientAPIListenAddr="127.0.0.1:0",
                WorkerAPIListenAddr="127.0.0.1:0",
                Workers=["pending:0"] * n_workers,
                **(coord_extra or {}),
            ))
            for _ in range(n_coordinators)
        ]
        self.coordinator = self.coordinators[0]  # back-compat alias
        bound = [c.initialize_rpcs() for c in self.coordinators]
        self.client_addrs = [client for client, _worker in bound]
        self.client_addr = self.client_addrs[0]
        if n_coordinators > 1:
            for i, c in enumerate(self.coordinators):
                c.set_cluster_peers(self.client_addrs, i)
        self.workers: List[Worker] = []
        addrs = []
        for i in range(n_workers):
            w = Worker(WorkerConfig(
                WorkerID=f"loadw{i}",
                ListenAddr="127.0.0.1:0",
                # the config default delivery target; pooled rounds
                # stamp their own reply-to, so every member receives
                # its rounds' Results regardless of this choice
                CoordAddr=bound[0][1],
                Backend=backend,
                WarmupNonceLens=[],
                WarmupWidths=[],
                **(worker_extra or {}),
            ), device=device)
            addrs.append(w.initialize_rpcs())
            w.start_forwarder()
            self.workers.append(w)
        self.worker_addrs = addrs
        for c in self.coordinators:
            c.set_worker_addrs(addrs)
        # the open-loop client: a deep notify queue — the drain runs on
        # one harness thread and a bounded default (10) would make
        # powlib's delivery the closed-loop throttle the generator
        # exists to avoid.  A pool rides CoordAddrs (powlib cluster
        # mode); a single coordinator keeps the plain CoordAddr shape.
        self.client = Client(ClientConfig(
            ClientID="loadgen", CoordAddr=self.client_addr,
            CoordAddrs=self.client_addrs if n_coordinators > 1 else [],
            ChCapacity=100_000, **(client_extra or {}),
        ))
        self.client.initialize()

    def scrape_targets(self, include_workers: bool = False) -> List[NodeTarget]:
        targets = [
            NodeTarget(addr=a, name=(f"coordinator{i}" if i else
                                     "coordinator"),
                       role="coordinator")
            for i, a in enumerate(self.client_addrs)
        ]
        if include_workers:
            targets.extend(
                NodeTarget(addr=a, name=w.config.WorkerID, role="worker")
                for a, w in zip(self.worker_addrs, self.workers)
            )
        return targets

    def kill_coordinator(self, i: int) -> None:
        """Hard-stop pool member ``i`` without draining — the in-proc
        stand-in for SIGKILL.  The member's listeners
        close and its worker links drop; the client's next Mine on a key
        it owned rides powlib's ring-walk failover to the survivor.
        Idempotent; ``close()`` skips already-killed members."""
        c = self.coordinators[i]
        if c is None:
            return
        self.coordinators[i] = None
        c.shutdown()

    def close(self) -> None:
        self.client.close()
        for w in self.workers:
            w.shutdown()
        for c in self.coordinators:
            if c is not None:
                c.shutdown()


class _CompletionTracker:
    """Match notify-queue completions back to their issue times.

    Keyed by (nonce, ntz): Zipf repeats make keys non-unique, so each
    key holds a FIFO of issue times — completions of coalesced/cached
    repeats drain oldest-first, which at worst attributes one repeat's
    latency to its sibling (same key, same round: the error is bounded
    by the round itself)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._issued: Dict[Tuple[bytes, int], deque] = {}
        self.latencies_s: List[float] = []
        self.completed = 0
        self.errors: List[str] = []

    def issued(self, arr: Arrival) -> None:
        with self._lock:
            self._issued.setdefault((arr.nonce, arr.ntz),
                                    deque()).append(time.monotonic())

    def completed_one(self, res) -> None:
        now = time.monotonic()
        with self._lock:
            self.completed += 1
            if getattr(res, "error", None):
                self.errors.append(str(res.error))
            dq = self._issued.get((bytes(res.nonce),
                                   int(res.num_trailing_zeros)))
            if dq:
                self.latencies_s.append(now - dq.popleft())


@contextmanager
def keeping_results(modules=None):
    """Have the harness runs started inside keep what they drain.

    Yields a list that gets each run's completion tracker, in the order
    the runs start; each tracker's ``results`` holds the MineResults it
    drained, so a caller checks every secret.  ``modules`` are the
    harness modules whose tracker is wrapped: this one and
    :mod:`.soak` by default (any module with a ``_CompletionTracker`` of
    this shape will do)."""
    from . import soak

    modules = modules or (sys.modules[__name__], soak)
    saved = [m._CompletionTracker for m in modules]
    trackers: list = []

    class Keeping(saved[0]):
        def __init__(self) -> None:
            super().__init__()
            self.results: list = []
            trackers.append(self)

        def completed_one(self, res) -> None:
            self.results.append(res)
            super().completed_one(res)

    for m in modules:
        m._CompletionTracker = Keeping
    try:
        yield trackers
    finally:
        for m, tracker in zip(modules, saved):
            m._CompletionTracker = tracker


def run_load_slo(
    mix: LoadMix,
    slo_config,
    cluster: Optional[InProcCluster] = None,
    n_workers: int = 2,
    coord_extra: Optional[dict] = None,
    worker_extra: Optional[dict] = None,
    scrape_interval_s: float = 1.0,
    scrape_deadline_s: float = 2.0,
    include_worker_targets: bool = False,
    drain_timeout_s: float = 60.0,
    breach_hooks: bool = True,
    fault_spec: Optional[dict] = None,
) -> Tuple[dict, SLOVerdict]:
    """Replay ``mix`` against a cluster, scraping + judging as it runs.

    Returns ``(report, verdict)``: the report is a JSON-able summary
    (offered/achieved rates, client-observed exact latencies, merged
    run-window views, coalesce/cache evidence); the verdict is the
    typed SLO outcome whose ``exit_code()`` gates CI.  ``fault_spec``
    optionally installs a fault plan for the duration of the run
    (chaos under load), restored afterwards.  ``cluster=None`` boots an
    :class:`InProcCluster` of ``n_workers`` on the card.
    """
    config = slo_config if hasattr(slo_config, "objectives") \
        else load_slo_config(slo_config)
    own_cluster = cluster is None
    if own_cluster:
        cluster = InProcCluster(n_workers=n_workers,
                                coord_extra=coord_extra,
                                worker_extra=worker_extra)
    # the JUDGED view scrapes the coordinator alone (module docstring:
    # in-process nodes share one registry, so summing coordinator AND
    # worker snapshots would multiply every counter by the node count);
    # include_worker_targets only adds the multi-node sweep used for
    # the scale-invariant merge-vs-single-node cross-check below
    scraper = FleetScraper(
        # first coordinator only: under an in-process pool every member
        # shares the one registry, so sweeping them all would multiply
        # the judged counters by the pool size (module docstring)
        cluster.scrape_targets(include_workers=False)[:1],
        deadline_s=scrape_deadline_s,
    )
    engine = SLOEngine(config)
    tracker = _CompletionTracker()
    stop_drain = threading.Event()
    prev_plan = faults.PLAN

    def drain() -> None:
        q = cluster.client.notify_queue
        while not stop_drain.is_set():
            try:
                res = q.get(timeout=0.05)
            except _queue.Empty:
                continue
            tracker.completed_one(res)

    def submit(arr: Arrival) -> None:
        tracker.issued(arr)
        cluster.client.mine(arr.nonce, arr.ntz, hash_model=arr.hash_model)

    stop_sweeps = threading.Event()

    def sweep_loop() -> None:
        while not stop_sweeps.wait(scrape_interval_s):
            try:
                engine.observe(scraper.sweep())
            except Exception:
                # a failed mid-run sweep costs one history point, never
                # the run; the final sweep below is the one that gates
                pass

    try:
        if fault_spec:
            faults.install_from_spec(fault_spec)
        baseline = scraper.sweep()
        engine.observe(baseline)
        drainer = threading.Thread(target=drain, daemon=True,
                                   name="loadgen-drain")
        drainer.start()
        sweeper = threading.Thread(target=sweep_loop, daemon=True,
                                   name="loadgen-sweeps")
        sweeper.start()
        schedule = build_schedule(mix)
        runner = OpenLoopRunner(submit)
        t_start = time.monotonic()
        load_report = runner.run(schedule)
        # drain the tail: open-loop means arrivals never waited for
        # completions, so the backlog finishes after the last arrival
        deadline = time.monotonic() + drain_timeout_s
        # a submit that RAISED never reaches powlib, so no completion
        # (not even an error MineResult) will ever arrive for it —
        # waiting for those would stall every such run for the full
        # drain timeout
        expected = load_report.issued - load_report.submit_errors
        while (tracker.completed < expected
               and time.monotonic() < deadline):
            time.sleep(0.02)
        wall_total_s = time.monotonic() - t_start
        stop_sweeps.set()
        sweeper.join(timeout=scrape_deadline_s + 1.0)
        final = scraper.sweep()
        verdict = engine.evaluate(final, breach_hooks=breach_hooks)
        stop_drain.set()
        drainer.join(timeout=2.0)
        run_window = delta_merged(final, baseline)
        hists = run_window.get("histograms") or {}
        counters = run_window.get("counters") or {}
        solved = [s for s in tracker.latencies_s]
        report = {
            "mix": {
                "rate_hz": mix.rate_hz, "duration_s": mix.duration_s,
                "seed": mix.seed, "n_keys": mix.n_keys,
                "zipf_s": mix.zipf_s,
                "difficulties": [list(d) for d in mix.difficulties],
                "hash_models": [[m or "default", w]
                                for m, w in mix.hash_models],
                "chaos": bool(fault_spec),
            },
            "load": load_report.to_dict(),
            "completed": tracker.completed,
            "request_errors": len(tracker.errors),
            "error_samples": tracker.errors[:3],
            # completions over the FULL wall (arrival window + backlog
            # drain): open-loop lets the backlog outlive the schedule,
            # and dividing by the arrival window alone would overstate
            # a server that is merely queueing
            "wall_total_s": round(wall_total_s, 3),
            "achieved_solves_per_s": round(
                tracker.completed / max(wall_total_s, 1e-9), 3),
            "client_latency_ms": {
                "n": len(solved),
                "p50": _ms(exact_percentile(solved, 0.50)),
                "p95": _ms(exact_percentile(solved, 0.95)),
                "max": _ms(max(solved) if solved else None),
            },
            "merged": {
                "window_s": run_window.get("window_s"),
                "mine_miss_p95_ms": _ms(
                    (hists.get("coord.mine_s.miss") or {}).get("p95")),
                "mine_hit_p95_ms": _ms(
                    (hists.get("coord.mine_s.hit") or {}).get("p95")),
                "cache_hits": counters.get("cache.hit", 0),
                "coalesced_requests": counters.get(
                    "sched.coalesced_requests", 0),
                "admission_rejected": counters.get(
                    "sched.admission_rejected", 0),
                "stale_nodes": final.get("stale_nodes") or [],
            },
            "verdict": verdict.to_dict(),
        }
        if include_worker_targets:
            # merged-vs-single-node oracle: one multi-node sweep,
            # used ONLY here — the
            # cluster-merged percentile must sit within one log bucket
            # of the coordinator's own estimate (the merge may
            # re-bucket, never relocate).  Percentiles are invariant
            # under the shared-registry count multiplication that keeps
            # these worker targets out of the judged view above.
            xcheck = FleetScraper(
                cluster.scrape_targets(include_workers=True),
                deadline_s=scrape_deadline_s,
            )
            try:
                xsnap = xcheck.sweep()
                coord_hists = (xcheck.last_snapshots().get("coordinator")
                               or {}).get("histograms") or {}
                report["oracle_check"] = percentile_within_one_bucket(
                    (xsnap.get("histograms") or {}).get("coord.mine_s.miss"),
                    coord_hists.get("coord.mine_s.miss"),
                )
                report["oracle_check"]["nodes"] = int(xsnap.get("nodes", 0))
            finally:
                xcheck.close()
        return report, verdict
    finally:
        if fault_spec:
            faults.install(prev_plan)
        stop_sweeps.set()
        stop_drain.set()
        scraper.close()
        if own_cluster:
            cluster.close()


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1e3, 3)


def percentile_within_one_bucket(merged_hist: Optional[dict],
                                 oracle_hist: Optional[dict],
                                 stat: str = "p95") -> dict:
    """Merge cross-check: a cluster-merged percentile
    must sit within ONE log bucket (``BUCKET_RATIO``) of a single-node
    oracle's estimate for the same stream — merging may re-bucket, it
    must never move a percentile beyond the representation's own error
    bound (docs/SLO.md "Aggregation")."""
    m = (merged_hist or {}).get(stat)
    o = (oracle_hist or {}).get(stat)
    if not m or not o:
        return {"ok": m == o, "merged": m, "oracle": o, "stat": stat}
    ratio = m / o if m >= o else o / m
    return {
        "ok": ratio <= BUCKET_RATIO + 1e-9,
        "merged": round(m, 6),
        "oracle": round(o, 6),
        "ratio": round(ratio, 4),
        "bound": round(BUCKET_RATIO, 4),
        "stat": stat,
    }
