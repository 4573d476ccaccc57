"""Process-wide metrics registry: counters, gauges and log-bucketed
histograms.

The port's own copy of the reference registry (``distpow_tpu/runtime/
metrics.py``), without the lint declarations.  Every process has one
``REGISTRY``; a caller may also create a ``Metrics`` and pass it to a
backend or to the search driver.  Names the port writes:

* counters ``search.hashes``, ``search.launches``, ``search.found``,
  ``search.cancelled``, ``search.blocking_syncs`` (the search driver and
  the scheduler), ``sched.launches``, ``sched.mixed_hash_launches``,
  ``sched.lane_launches.<lane>``, ``sched.slots_preempted``,
  ``sched.fallback_searches``, ``sched.loop_failures`` (the scheduler),
  ``spans.dropped``, ``telemetry.dropped_events``, ``telemetry.dumps``;
* gauges ``search.hashes_per_s`` (the driver's rate meter),
  ``sched.active_slots``, ``sched.run_queue_depth``;
* histograms ``search.launch_s`` (time blocked on one launch's result),
  ``sched.batch_occupancy`` (real slots per engine launch),
  ``sched.slot_wait_s`` (submit to first launch).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

Number = Union[int, float]

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
