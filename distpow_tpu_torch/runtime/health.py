"""Resource sentinels: per-node self-telemetry gauges and a leak trend
detector (docs/SOAK.md "Sentinels").

The gap (ROADMAP item 4): every observability plane so far watches the
WORKLOAD — latency, fan-outs, cache hits.  Nothing watches the process
itself, so the classic long-haul failures (a thread leaked per request,
an fd leaked per reconnect, a ring quietly pinned at capacity) are
invisible to every 60-second test and every SLO objective.  Two pieces
close it:

* :class:`ResourceSentinels` — samples process self-telemetry (RSS via
  ``/proc/self/statm`` with a ``resource.getrusage`` fallback, fd count
  via ``/proc/self/fd``, thread count) plus the occupancy of every
  bounded ring the repo owns (span ring, flight-recorder ring, and any
  registered probe such as the replication push queue) into DECLARED
  gauges (``proc.*`` / ``ring.*`` — runtime/metrics.py KNOWN_GAUGES).
  The node ``Stats`` handlers call :meth:`ResourceSentinels.sample`
  before snapshotting, so the gauges ride the existing Stats RPC,
  ``--prom`` exposition, fleet scraper, and time-series retention with
  zero new plumbing.  Forwarder backlog and sched run queue already
  ship as ``worker.forward_queue_depth`` / ``sched.run_queue_depth``.

* :class:`LeakSentinel` — a trend detector over a gauge's retained
  trajectory (obs/timeseries.py ``gauge_series``): least-squares slope
  over a configurable window, judged against a noise floor (the total
  rise across the window must clear an absolute floor AND the series
  must actually climb, not wobble — a noisy-but-flat gauge fits a
  near-zero slope and stays quiet; tests/test_health.py pins both
  directions).  A suspect becomes a typed ``health.leak_suspect``
  flight-recorder event + ``health.leak_suspects`` counter increment,
  deduplicated per gauge per detector instance, and a
  :class:`LeakSuspect` entry in the soak verdict (load/soak.py).

Sampling is read-only and bounded (two /proc reads, one directory
listing, a couple of ring locks) — cheap enough for every Stats call.

The port's own copy of the reference's ``runtime/health.py``
(``distpow_tpu/runtime/health.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import REGISTRY as metrics
from .spans import SPANS
from .telemetry import RECORDER

log = logging.getLogger("distpow.health")

_PAGE_SIZE = 4096
try:
    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):  # non-POSIX
    pass


def rss_bytes() -> Optional[float]:
    """Resident set size.  ``/proc/self/statm`` (current RSS) when the
    platform has it; ``resource.getrusage`` (peak RSS — still monotone
    under a leak, which is what the sentinel needs) otherwise."""
    try:
        with open("/proc/self/statm") as fh:
            return float(int(fh.read().split()[1]) * _PAGE_SIZE)
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        # ru_maxrss is KiB on Linux, bytes on macOS; Linux took the
        # /proc path above, so scale for the common fallback
        return float(ru.ru_maxrss) * (1.0 if ru.ru_maxrss > 1 << 30
                                      else 1024.0)
    except (ImportError, OSError, ValueError):
        return None


def open_fds() -> Optional[float]:
    try:
        return float(len(os.listdir("/proc/self/fd")))
    except OSError:
        return None


class ResourceSentinels:
    """Gauge sampler for process self-telemetry and ring depths.

    Probes are ``name -> callable() -> Optional[float]``; a probe
    returning None (unsupported platform, ring not wired yet) simply
    skips its gauge that round.  Probe names must be DECLARED gauges
    (KNOWN_GAUGES) — :meth:`register_probe` enforces it so a typo'd
    sentinel cannot hide from the trend detector."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._probes: Dict[str, Callable[[], Optional[float]]] = {}
        self.register_probe("proc.rss_bytes", rss_bytes)
        self.register_probe("proc.open_fds", open_fds)
        self.register_probe("proc.threads",
                            lambda: float(threading.active_count()))
        self.register_probe("ring.spans_depth",
                            lambda: float(SPANS.depth()))
        self.register_probe("ring.flightrec_depth",
                            lambda: float(RECORDER.depth()))

    def register_probe(self, name: str,
                       fn: Callable[[], Optional[float]]) -> None:
        from .metrics import KNOWN_GAUGES

        if name not in KNOWN_GAUGES:
            raise ValueError(
                f"sentinel probe {name!r} is not a declared gauge — add "
                f"it to runtime/metrics.py KNOWN_GAUGES")
        with self._lock:
            self._probes[name] = fn

    def sample(self) -> Dict[str, float]:
        """Run every probe and set its gauge; returns what was set.
        Best-effort per probe: one failing probe must not cost the
        Stats snapshot it rides on."""
        with self._lock:
            probes = list(self._probes.items())
        out: Dict[str, float] = {}
        for name, fn in probes:
            try:
                v = fn()
            except Exception as exc:
                log.debug("sentinel probe %s failed: %s", name, exc)
                continue
            if v is None:
                continue
            metrics.gauge(name, v)
            out[name] = v
        return out


#: process-global sampler, the REGISTRY/RECORDER pattern — the node
#: Stats handlers call ``SENTINELS.sample()`` before snapshotting.
SENTINELS = ResourceSentinels()


def least_squares_slope(
        series: Sequence[Tuple[float, float]]) -> Optional[float]:
    """Ordinary least-squares slope (units/second) of ``(ts, value)``
    points; None with fewer than two distinct timestamps."""
    n = len(series)
    if n < 2:
        return None
    mean_t = sum(t for t, _ in series) / n
    mean_v = sum(v for _, v in series) / n
    sxx = sum((t - mean_t) ** 2 for t, _ in series)
    if sxx <= 0.0:
        return None
    sxy = sum((t - mean_t) * (v - mean_v) for t, v in series)
    return sxy / sxx


@dataclass(frozen=True)
class LeakSuspect:
    """One gauge the trend detector judged monotone-climbing."""

    gauge: str
    slope_per_s: float
    rise: float         # slope * observed span: total climb judged
    window_s: float     # observed span of the judged series
    points: int
    first: float
    last: float

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class LeakSentinel:
    """Trend detector over gauge trajectories (module docstring).

    ``noise_floor`` is the absolute rise (gauge units over the whole
    window) below which a climb is noise: 1.5 means "flag only if the
    fitted line climbs more than 1.5 threads/fds", while RSS callers
    pass bytes.  ``min_monotone_frac`` additionally requires that
    fraction of consecutive steps to be non-decreasing, so an
    oscillating gauge whose endpoints happen to rise stays quiet."""

    def __init__(self, window_s: float = 120.0, min_points: int = 6,
                 noise_floor: float = 2.0,
                 min_monotone_frac: float = 0.7):
        self.window_s = float(window_s)
        self.min_points = int(min_points)
        self.noise_floor = float(noise_floor)
        self.min_monotone_frac = float(min_monotone_frac)
        self._flagged: set = set()

    def judge_series(
            self, gauge: str,
            series: Sequence[Tuple[float, float]]) -> Optional[LeakSuspect]:
        """Judge one gauge trajectory; no side effects (unit tests call
        this directly)."""
        if len(series) < self.min_points:
            return None
        slope = least_squares_slope(series)
        if slope is None or slope <= 0.0:
            return None
        span = series[-1][0] - series[0][0]
        rise = slope * span
        if rise <= self.noise_floor:
            return None
        steps = [series[i + 1][1] - series[i][1]
                 for i in range(len(series) - 1)]
        up = sum(1 for d in steps if d >= 0)
        if up < self.min_monotone_frac * len(steps):
            return None
        return LeakSuspect(gauge=gauge, slope_per_s=slope, rise=rise,
                           window_s=span, points=len(series),
                           first=series[0][1], last=series[-1][1])

    def check(self, store, gauges: Optional[Sequence[str]] = None,
              now: Optional[float] = None,
              noise_floors: Optional[Dict[str, float]] = None
              ) -> List[LeakSuspect]:
        """Sweep gauge trajectories retained in a
        :class:`~distpow_tpu.obs.timeseries.TimeSeriesStore`; each NEW
        suspect (per-gauge dedup — a leak stays leaking, one verdict
        entry is enough) increments ``health.leak_suspects`` and
        records a ``health.leak_suspect`` flight-recorder event."""
        names = list(gauges) if gauges is not None else [
            g for g in store.gauge_names()
            if g.startswith(("proc.", "ring."))
        ]
        floors = noise_floors or {}
        out: List[LeakSuspect] = []
        for name in names:
            series = store.gauge_series(name, window_s=self.window_s,
                                        now=now)
            floor = floors.get(name)
            if floor is None:
                suspect = self.judge_series(name, series)
            else:
                saved, self.noise_floor = self.noise_floor, float(floor)
                try:
                    suspect = self.judge_series(name, series)
                finally:
                    self.noise_floor = saved
            if suspect is None:
                continue
            out.append(suspect)
            if name in self._flagged:
                continue
            self._flagged.add(name)
            metrics.inc("health.leak_suspects")
            RECORDER.record(
                "health.leak_suspect", gauge=name,
                slope_per_s=round(suspect.slope_per_s, 6),
                rise=round(suspect.rise, 3),
                window_s=round(suspect.window_s, 3),
                points=suspect.points,
                first=suspect.first, last=suspect.last,
            )
            log.warning(
                "leak suspect: %s climbed %.3g over %.1fs "
                "(slope %.3g/s across %d points)",
                name, suspect.rise, suspect.window_s,
                suspect.slope_per_s, suspect.points)
        return out
