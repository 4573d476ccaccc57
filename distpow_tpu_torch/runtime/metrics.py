"""Process-wide metrics registry: counters, gauges and log-bucketed
histograms.

The port's own copy of the reference registry (``distpow_tpu/runtime/
metrics.py``).  Every process has one
``REGISTRY``; a caller may also create a ``Metrics`` and pass it to a
backend or to the search driver.  The names the port writes are declared
below (``KNOWN_*``, with the reference's names): the search driver and
the scheduler (``search.*``, ``sched.*``), the worker node (``worker.*``,
``worker.solve_s.<model>``), its dominance cache (``cache.*``), the RPC
layer (``rpc.*``, ``rpc.client.call_s.<method>``,
``rpc.server.dispatch_s.<method>``), the fault plane
(``faults.injected.<kind>``), the fleet agent (``fleet.*``), the resource
sentinels (``proc.*``, ``ring.*``, ``health.leak_suspects``), the span
ring and the flight recorder (``spans.dropped``, ``telemetry.*``), the
coordinator (``coord.*``, ``coord.mine_s.<hit|miss>``), its admission and
coalescing (``sched.admission_rejected``, ``sched.coalesced_requests``),
its fleet registry (``fleet.*``) and pool (``cluster.*``, ``repl.*``), the
client library (``powlib.*``), the slow-request capture
(``forensics.slow_captures``), and the observability and load planes: the
fleet scraper and its spool (``obs.scrapes``, ``obs.scrape_failures``,
``obs.spool_rotations``, ``obs.sweep_s``), the SLO engine (``slo.*``), the
span sweeps (``forensics.fetches``, ``forensics.fetch_failures``), the soak
harness (``soak.*``) and the open-loop generator's lag (``load.lag_s``).
``worker.warmup_failures`` is the port's own: a failed boot warm-up; so
are ``mesh.collective_host_waits`` and ``mesh.collective_s``, the
cross-process min of a mesh in a ``torch.distributed`` group; the device
timeline's ``search.device_s`` (a drained launch's device time) and
``search.past_hit_s`` (a launch left in flight when its search returned),
both written only while ``SPANS.device_timing`` is on; and
``worker.cancel_s``, from the receipt of the Found or Cancel that stopped
a search to its return (the reference's ``worker.time_to_cancel_s``
started at the Mine).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

Number = Union[int, float]

KNOWN_COUNTERS = frozenset({
    "search.hashes", "search.launches", "search.cancelled", "search.found",
    "search.blocking_syncs", "search.persistent_steps", "mesh.collective_host_waits",
    "worker.mine_rpcs", "worker.found_rpcs", "worker.cancel_rpcs",
    "worker.results_sent", "worker.forward_retries", "worker.warmup_failures",
    "coord.mine_rpcs", "coord.fanouts", "coord.late_results",
    "coord.worker_failures", "coord.reassigned_shards",
    "coord.stale_results_dropped", "coord.abandoned_resyncs",
    "powlib.retries", "powlib.reconnects", "powlib.degraded",
    "powlib.retry_after",
    "sched.admission_rejected", "sched.coalesced_requests",
    "fleet.joins", "fleet.lease_expiries", "fleet.drains",
    "fleet.hedged_shards",
    "forensics.slow_captures", "forensics.fetches", "forensics.fetch_failures",
    "obs.scrapes", "obs.scrape_failures", "obs.spool_rotations",
    "slo.evaluations", "slo.breaches",
    "soak.sweeps", "soak.phase_breaches",
    "cluster.not_owner_redirects", "cluster.foreign_mines",
    "cluster.ring_serves",
    "cluster.reroutes", "cluster.failovers", "cluster.sibling_hedges",
    "repl.pushes", "repl.push_failures", "repl.installs",
    "repl.stale_drops", "repl.handoff_keys", "repl.antientropy_rounds",
    "cache.hit", "cache.miss", "cache.add", "cache.evict",
    "sched.launches", "sched.slots_preempted", "sched.fallback_searches",
    "sched.loop_failures", "sched.mixed_hash_launches",
    "rpc.handler_errors", "rpc.codec.negotiated_v2", "rpc.codec.fallback_v1",
    "telemetry.dropped_events", "telemetry.dumps",
    "spans.dropped",
    "health.leak_suspects",
})
# Families minted from runtime values: the literal prefix is one of these.
KNOWN_COUNTER_PREFIXES = frozenset({
    "faults.injected.",
    "search.",  # the backends' exit reasons: search.{cancelled,found}
    "sched.lane_launches.",
})
KNOWN_HISTOGRAMS = frozenset({
    "coord.mine_s.hit", "coord.mine_s.miss",
    "coord.first_result_s", "coord.cancel_propagation_s",
    "powlib.mine_s",
    "cluster.failover_s", "repl.push_lag_s", "repl.handoff_s",
    "worker.solve_s", "worker.cancel_s",
    "search.launch_s", "search.poll_s", "search.device_s", "search.past_hit_s",
    "mesh.collective_s",
    "sched.batch_occupancy", "sched.slot_wait_s",
    "rpc.frame.sent_bytes", "rpc.frame.recv_bytes",
    "fleet.heartbeat_rtt_s",
    "obs.sweep_s", "load.lag_s",
})
KNOWN_HISTOGRAM_PREFIXES = frozenset({
    "rpc.client.call_s.",
    "rpc.server.dispatch_s.",
    "worker.solve_s.",  # per hash model
})
# Gauge names are load-bearing: the resource sentinels (runtime/health.py)
# register only declared ones.
KNOWN_GAUGES = frozenset({
    "worker.active_searches", "worker.mine_queue_depth",
    "worker.forward_queue_depth",
    "search.hashes_per_s", "search.mesh_devices",
    "sched.active_slots", "sched.run_queue_depth",
    "fleet.live_workers",
    "proc.rss_bytes", "proc.open_fds", "proc.threads",
    "ring.spans_depth", "ring.flightrec_depth", "ring.repl_queue_depth",
})
KNOWN_GAUGE_PREFIXES = frozenset()

# Log-bucket geometry: 4 buckets per octave, so a bucket is at most ~19 %
# wide and a percentile estimate errs high by at most that much.
_BUCKETS_PER_OCTAVE = 4
_LOG_GROWTH = math.log(2.0) / _BUCKETS_PER_OCTAVE


class Histogram:
    """count/sum/min/max and log buckets, with percentile estimates (the
    upper bound of the bucket holding the rank) and, per bucket, the last
    ``(trace_id, value, ts)`` observed with a trace id (an exemplar).  The
    owning ``Metrics`` serializes access under its lock."""

    __slots__ = ("count", "sum", "min", "max", "_buckets", "_zeros", "_exemplars")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._buckets: Dict[int, int] = {}
        self._zeros = 0
        self._exemplars: Dict[Optional[int], Tuple[int, float, float]] = {}

    def observe(self, value: Number, trace_id: Optional[int] = None) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if v > 0.0:
            idx = math.floor(math.log(v) / _LOG_GROWTH)
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
        else:
            idx = None
            self._zeros += 1
        if trace_id:
            self._exemplars[idx] = (int(trace_id), v, round(time.time(), 6))

    @staticmethod
    def bound(idx: int) -> float:
        """Upper bound of log-bucket ``idx``."""
        return math.exp((idx + 1) * _LOG_GROWTH)

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (q in [0, 1]); None when empty."""
        if self.count == 0:
            return None
        rank = q * self.count
        cum = self._zeros
        if cum >= rank and self._zeros:
            return 0.0
        for idx in sorted(self._buckets):
            cum += self._buckets[idx]
            if cum >= rank:
                est = self.bound(idx)
                return min(max(est, self.min or est), self.max or est)
        return self.max

    def to_dict(self) -> dict:
        """JSON-able snapshot; ``buckets`` is ``[[upper_bound, count], ...]``
        in ascending order, ``exemplars`` (when any) ``[[upper_bound,
        trace_id, value, ts], ...]``."""
        buckets: List[Tuple[float, int]] = []
        if self._zeros:
            buckets.append((0.0, self._zeros))
        buckets.extend((round(self.bound(i), 9), self._buckets[i]) for i in sorted(self._buckets))
        out = {
            "count": self.count,
            "sum": round(self.sum, 9),
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "buckets": [[b, c] for b, c in buckets],
        }
        if self._exemplars:
            out["exemplars"] = [
                [0.0 if i is None else round(self.bound(i), 9), tid, v, ts]
                for i, (tid, v, ts) in sorted(
                    self._exemplars.items(),
                    key=lambda kv: float("-inf") if kv[0] is None else kv[0])
            ]
        return out


class _Timer:
    """Context manager returned by ``Metrics.time``: observes the block's
    wall-clock seconds into the named histogram."""

    __slots__ = ("_metrics", "_name", "_t0")

    def __init__(self, metrics: "Metrics", name: str):
        self._metrics = metrics
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "_Timer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._metrics.observe(self._name, time.monotonic() - self._t0)


class Metrics:
    def __init__(self) -> None:
        self._counters: Dict[str, Number] = {}
        self._gauges: Dict[str, Number] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self._start = time.monotonic()
        # trace ids passed to observe() are kept as exemplars while this is on
        self.exemplars_enabled = True

    def inc(self, name: str, n: Number = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: Number) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: Number, trace_id: Optional[int] = None) -> None:
        """One sample into the named histogram (created on first use)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value, trace_id if self.exemplars_enabled else None)

    def time(self, name: str) -> _Timer:
        """``with metrics.time("x.y"): ...`` observes the block's seconds
        into histogram ``x.y``."""
        return _Timer(self, name)

    def get(self, name: str) -> Number:
        """A counter, else a gauge, else 0."""
        with self._lock:
            return self._counters.get(name, self._gauges.get(name, 0))

    def get_histogram(self, name: str) -> Optional[dict]:
        with self._lock:
            h = self._hists.get(name)
            return h.to_dict() if h is not None else None

    def get_observed(self, name: str) -> Dict[str, Number]:
        """count, sum, min and max of a histogram (count 0 when unseen)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return {"count": 0, "sum": 0}
            return {"count": h.count, "sum": h.sum, "min": h.min, "max": h.max}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "uptime_secs": round(time.monotonic() - self._start, 3),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {name: h.to_dict() for name, h in self._hists.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._start = time.monotonic()


REGISTRY = Metrics()
