"""Bounded multi-resolution retention for fleet sweeps (docs/SOAK.md).

A :class:`TimeSeriesStore` holds timestamped MERGED cluster snapshots
(the ``obs.merge.merge_snapshots`` shape the fleet scraper produces) in
resolution tiers, answers the windowed delta queries the SLO engine's
burn windows need, and spools every accepted point to append-only JSONL
for post-mortem replay.

Tier math (the downsampling discipline): snapshots are CUMULATIVE —
counters and histogram bucket counts only grow — so "downsample to one
point per 10 s" means *keep the last snapshot of each 10-second
interval*, not averaging.  A windowed query is a bucket-wise delta
between two retained snapshots (``obs.merge.delta_merged``), and
bucket counts subtract exactly on the shared log grid, so a percentile
over a downsampled tier is *bit-identical* to the full-resolution
oracle evaluated at the same two snapshots; the only degradation from
downsampling is that the window BOUNDARY lands up to one resolution
step earlier than requested, which widens the window slightly and can
move the estimate by at most one log-grid bucket (~19%).

Each tier is a bounded deque: points older than the tier's retention
are evicted on append, and a hard ``maxlen`` backstops the math (a
stalled clock must not grow memory).  The finest tier (resolution 0)
keeps every sweep; coarser tiers keep the last point per resolution
interval.  Queries search finest-first so recent windows get full
resolution and older windows degrade gracefully.

The JSONL spool reuses the flight-recorder rotation machinery
(``runtime.telemetry.rotate_if_over``): one ``{"ts": ..., "merged":
...}`` object per line, size-capped segments ``spool.jsonl.N``, and
:func:`replay_spool` walks the segments oldest-first to rebuild a
store (or feed any offline analysis) after the process is gone.  The
spool's lines are the reference's: either package replays the other's.

The port's own copy of the reference's ``obs/timeseries.py``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from ..runtime.metrics import REGISTRY as metrics
from ..runtime.telemetry import iter_rotated_jsonl, rotate_if_over
from .merge import delta_merged

log = logging.getLogger("distpow.timeseries")

DEFAULT_SPOOL_MAX_BYTES = 8 * 1024 * 1024
DEFAULT_SPOOL_KEEP = 3

#: per-tier hard point cap: retention/resolution bounds the count when
#: time flows normally; this backstops a stalled or hostile clock.
_TIER_MAXLEN = 4096


@dataclass(frozen=True)
class Tier:
    """One retention tier: keep (at most) one point per
    ``resolution_s`` interval, for ``retention_s`` back.
    ``resolution_s == 0`` keeps every appended point."""

    resolution_s: float
    retention_s: float


#: every sweep for 5 min -> 10 s downsamples for 1 h -> 1 min for a day
DEFAULT_TIERS: Tuple[Tier, ...] = (
    Tier(0.0, 300.0),
    Tier(10.0, 3600.0),
    Tier(60.0, 86400.0),
)


class TimeSeriesStore:
    """Tiered in-memory retention of merged cluster snapshots, with an
    optional rotated JSONL spool (module docstring)."""

    def __init__(self, tiers: Tuple[Tier, ...] = DEFAULT_TIERS,
                 spool_path: Optional[str] = None,
                 spool_max_bytes: int = DEFAULT_SPOOL_MAX_BYTES,
                 spool_keep: int = DEFAULT_SPOOL_KEEP):
        if not tiers:
            raise ValueError("need at least one tier")
        ordered = sorted(tiers, key=lambda t: t.resolution_s)
        for t in ordered:
            if t.retention_s <= 0:
                raise ValueError(f"tier retention must be positive: {t}")
        self._tiers: Tuple[Tier, ...] = tuple(ordered)
        self._points: List[deque] = [
            deque(maxlen=_TIER_MAXLEN) for _ in ordered
        ]
        self._lock = threading.Lock()
        self._spool_path = spool_path
        self._spool_max_bytes = int(spool_max_bytes)
        self._spool_keep = int(spool_keep)

    @property
    def tiers(self) -> Tuple[Tier, ...]:
        return self._tiers

    # -- ingest -------------------------------------------------------------
    def append(self, merged: dict, ts: Optional[float] = None) -> None:
        """Retain one merged cluster snapshot.  ``ts`` defaults to the
        snapshot's own ``ts`` (wall-clock: the scraper stamps it) —
        deterministic tests pass explicit timestamps."""
        t = float(ts if ts is not None
                  else merged.get("ts") or time.time())
        with self._lock:
            for tier, points in zip(self._tiers, self._points):
                if tier.resolution_s <= 0:
                    points.append((t, merged))
                else:
                    slot = int(t // tier.resolution_s)
                    if points and int(points[-1][0]
                                      // tier.resolution_s) == slot:
                        # same resolution interval: the LAST cumulative
                        # snapshot wins (tier math, module docstring)
                        points[-1] = (t, merged)
                    else:
                        points.append((t, merged))
                while points and points[0][0] < t - tier.retention_s:
                    points.popleft()
            self._spool_locked(t, merged)

    def _spool_locked(self, ts: float, merged: dict) -> None:
        if not self._spool_path:
            return
        try:
            with open(self._spool_path, "a") as fh:
                fh.write(json.dumps({"ts": ts, "merged": merged}) + "\n")
        except OSError as exc:
            log.warning("time-series spool append failed: %s", exc)
            return
        if rotate_if_over(self._spool_path, self._spool_max_bytes,
                          self._spool_keep):
            metrics.inc("obs.spool_rotations")

    # -- point queries ------------------------------------------------------
    def __len__(self) -> int:
        """Distinct retained points (a snapshot present in several tiers
        counts once)."""
        with self._lock:
            return len({t for points in self._points for t, _ in points})

    def tier_points(self, i: int) -> List[Tuple[float, dict]]:
        """One tier's retained ``(ts, merged)`` points (tests)."""
        with self._lock:
            return list(self._points[i])

    def latest(self) -> Optional[Tuple[float, dict]]:
        with self._lock:
            return self._latest_locked()

    def _latest_locked(self) -> Optional[Tuple[float, dict]]:
        best: Optional[Tuple[float, dict]] = None
        for points in self._points:
            if points and (best is None or points[-1][0] > best[0]):
                best = points[-1]
        return best

    def snapshot_at(self, ts: float) -> Optional[Tuple[float, dict]]:
        """The newest retained snapshot with ``ts' <= ts`` — searched
        finest-tier-first so recent boundaries resolve at full
        resolution and older ones fall back to downsampled points."""
        with self._lock:
            return self._snapshot_at_locked(ts)

    def _snapshot_at_locked(self, ts: float) -> Optional[Tuple[float, dict]]:
        best: Optional[Tuple[float, dict]] = None
        for points in self._points:
            for t, snap in reversed(points):
                if t <= ts:
                    if best is None or t > best[0]:
                        best = (t, snap)
                    break
        return best

    def _oldest_locked(self) -> Optional[Tuple[float, dict]]:
        best: Optional[Tuple[float, dict]] = None
        for points in self._points:
            if points and (best is None or points[0][0] < best[0]):
                best = points[0]
        return best

    # -- windowed queries ---------------------------------------------------
    def window(self, window_s: float,
               now: Optional[float] = None) -> Optional[dict]:
        """The windowed cluster view ``delta_merged(latest, boundary)``
        where the boundary is the newest snapshot at least ``window_s``
        old (the SLO engine's burn-window contract).  With history
        shallower than the window the OLDEST point stands in — the
        widest window actually observed; with fewer than two points the
        latest snapshot is returned as-is (cumulative degradation, same
        as the engine's one-shot mode).  Returns None when empty."""
        with self._lock:
            latest = self._latest_locked()
            if latest is None:
                return None
            t_now = float(now if now is not None else latest[0])
            boundary = self._snapshot_at_locked(t_now - float(window_s))
            if boundary is None:
                oldest = self._oldest_locked()
                if oldest is not None and oldest[0] < latest[0]:
                    boundary = oldest
        return delta_merged(latest[1], boundary[1] if boundary else None)

    def range_window(self, start_ts: float,
                     end_ts: float) -> Optional[dict]:
        """The windowed view between two HISTORICAL instants: the delta
        between the retained snapshots at ``end_ts`` and ``start_ts``
        (each resolved by the :meth:`snapshot_at` contract, so a
        downsampled tier answers for older instants).  Degrades to
        cumulative when no point precedes ``start_ts``; None when no
        point precedes ``end_ts`` at all.  This is the soak harness's
        per-phase judgment query (load/soak.py)."""
        with self._lock:
            end = self._snapshot_at_locked(float(end_ts))
            if end is None:
                return None
            start = self._snapshot_at_locked(float(start_ts))
            if start is not None and start[0] >= end[0]:
                start = None
        return delta_merged(end[1], start[1] if start else None)

    def counter_rate(self, name: str, window_s: float,
                     now: Optional[float] = None) -> Optional[float]:
        """Windowed per-second rate of a (merged, cumulative) counter;
        None with no usable window."""
        win = self.window(window_s, now)
        if not win:
            return None
        dt = float(win.get("window_s") or 0.0)
        if dt <= 0:
            return None
        return float((win.get("counters") or {}).get(name, 0)) / dt

    def gauge_series(self, name: str, window_s: Optional[float] = None,
                     now: Optional[float] = None,
                     node: Optional[str] = None) -> List[Tuple[float, float]]:
        """The retained ``(ts, value)`` trajectory of one gauge —
        fleet-summed by default, one node's with ``node=`` — deduped
        across tiers and sorted by time.  This is what the leak
        sentinels' trend detector consumes (runtime/health.py)."""
        with self._lock:
            by_ts: Dict[float, float] = {}
            for points in self._points:
                for t, snap in points:
                    if node is None:
                        g = snap.get("gauges") or {}
                    else:
                        g = ((snap.get("per_node") or {}).get(node)
                             or {}).get("gauges") or {}
                    if name in g:
                        by_ts[t] = float(g[name])
            series = sorted(by_ts.items())
        if window_s is not None and series:
            t_now = float(now if now is not None else series[-1][0])
            series = [p for p in series if p[0] >= t_now - float(window_s)]
        return series

    def gauge_names(self) -> List[str]:
        """Every gauge name seen in any retained snapshot."""
        with self._lock:
            names = set()
            for points in self._points:
                for _, snap in points:
                    names.update((snap.get("gauges") or {}).keys())
        return sorted(names)


def replay_spool(path: str) -> Iterator[Tuple[float, dict]]:
    """Yield ``(ts, merged)`` from a (possibly rotated) spool, oldest
    first — the post-mortem entry point: ``store = TimeSeriesStore();
    for ts, m in replay_spool(p): store.append(m, ts)`` rebuilds the
    windowed-query surface from disk."""
    for obj in iter_rotated_jsonl(path):
        if isinstance(obj, dict) and "merged" in obj:
            try:
                yield float(obj.get("ts", 0.0)), obj["merged"]
            except (TypeError, ValueError):
                continue
