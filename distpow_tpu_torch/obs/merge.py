"""Bucket-wise merging of per-node metric snapshots into cluster views.

Every node's ``Stats`` RPC ships ``runtime/metrics.py`` snapshots whose
histograms are LOG-BUCKETED with a single global geometry (4 buckets
per octave — the bucket bounds are value-derived, not configured), so
two nodes' histograms for the same series are defined over the same
bucket grid and merge exactly: summing the per-bucket counts of N nodes
yields the histogram a single node observing the union stream would
have built.  Cluster percentiles computed over the merged buckets
therefore carry the SAME error bound as node-local ones — the estimate
errs high by at most one bucket width (~19%) — which is what lets the
load harness cross-check a merged p95 against a single-node oracle
within one bucket.

Counters and gauges sum; ``min``/``max`` combine; per-node and
per-hash-model breakdowns ride alongside the merged series so a
cluster-wide regression can be attributed without a second sweep.

The port's own copy of the reference's ``obs/merge.py``: the grid is
the port registry's (``runtime/metrics._LOG_GROWTH``), which is the
reference's, so snapshots of either package's nodes merge alike.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterable, List, Optional, Tuple

from ..runtime.metrics import _LOG_GROWTH

#: one log bucket's width, as a ratio: bounds grow by 2^(1/4)
#: (runtime/metrics.py _BUCKETS_PER_OCTAVE) — "within one bucket" means
#: within this factor.
BUCKET_RATIO = 2.0 ** 0.25

#: histogram families whose suffix is a hash-model name
#: (``worker.solve_s.<model>`` — nodes/worker.py): the per-model
#: breakdown the per-model SLO objectives read.
PER_MODEL_HISTOGRAM_PREFIX = "worker.solve_s."


def _snap_bound(bound: float) -> float:
    """Snapshot bucket bounds are rounded to 9 decimals
    (``Histogram.to_dict``); snap them back onto the exact log grid so
    merged percentile estimates are bit-identical to what the owning
    registry itself would report (merge == combined-stream oracle,
    exactly)."""
    if bound <= 0.0:
        return bound
    return math.exp(round(math.log(bound) / _LOG_GROWTH) * _LOG_GROWTH)


def merged_percentile(buckets: List[Tuple[float, int]], count: int,
                      mn: Optional[float], mx: Optional[float],
                      q: float) -> Optional[float]:
    """Estimated q-quantile over a merged ``[[upper_bound, count], ...]``
    bucket list — the same estimator ``runtime/metrics.py``
    ``Histogram.percentile`` applies to a single node's buckets (each
    estimate is its bucket's upper bound, clamped to the observed
    extremes; a leading 0.0 bucket counts non-positive samples)."""
    if count <= 0:
        return None
    rank = q * count
    cum = 0
    last_bound: Optional[float] = None
    for bound, n in sorted(buckets):
        cum += n
        last_bound = bound
        if cum >= rank:
            if bound == 0.0:
                return 0.0
            est = _snap_bound(bound)
            return min(max(est, mn if mn is not None else est),
                       mx if mx is not None else est)
    # fewer bucketed samples than rank (possible after a clamped delta
    # across a counter reset): fall back like the single-node estimator
    return mx if mx is not None else last_bound


def _hist_stats(buckets: List[Tuple[float, int]], count: int, total: float,
                mn: Optional[float], mx: Optional[float]) -> dict:
    """Assemble the ``Histogram.to_dict`` shape from merged pieces."""
    return {
        "count": count,
        "sum": round(total, 9),
        "min": mn,
        "max": mx,
        "p50": merged_percentile(buckets, count, mn, mx, 0.50),
        "p95": merged_percentile(buckets, count, mn, mx, 0.95),
        "p99": merged_percentile(buckets, count, mn, mx, 0.99),
        "buckets": [[b, c] for b, c in sorted(buckets)],
    }


def merge_histograms(hists: Iterable[dict]) -> dict:
    """Merge ``Histogram.to_dict`` snapshots bucket-wise.

    The inputs share one global bucket geometry, so buckets merge by
    exact upper-bound identity; count/sum add, min/max combine, and the
    percentile estimates are recomputed over the merged buckets.
    Exemplars (docs/FORENSICS.md) merge bucket-wise too: each merged
    bucket keeps the FRESHEST ``(trace_id, value, ts)`` any node
    retained — "which request last landed here" is a cluster-wide
    question with a single answer per bucket."""
    buckets: Dict[float, int] = {}
    exemplars: Dict[float, list] = {}
    count = 0
    total = 0.0
    mn: Optional[float] = None
    mx: Optional[float] = None
    for h in hists:
        if not h:
            continue
        count += int(h.get("count", 0))
        total += float(h.get("sum", 0.0))
        for bound, n in h.get("buckets", []):
            buckets[float(bound)] = buckets.get(float(bound), 0) + int(n)
        for bound, tid, v, ts in h.get("exemplars", []):
            cur = exemplars.get(float(bound))
            if cur is None or float(ts) > float(cur[3]):
                exemplars[float(bound)] = [float(bound), tid, v, ts]
        for v, pick in ((h.get("min"), min), (h.get("max"), max)):
            if v is None:
                continue
            if pick is min:
                mn = v if mn is None else min(mn, v)
            else:
                mx = v if mx is None else max(mx, v)
    out = _hist_stats(sorted(buckets.items()), count, total, mn, mx)
    if exemplars:
        out["exemplars"] = [exemplars[b] for b in sorted(exemplars)]
    return out


def delta_histogram(new: Optional[dict], old: Optional[dict]) -> dict:
    """The histogram of samples observed BETWEEN two cumulative
    snapshots of one series — the windowed view the SLO engine's
    fast/slow burn-rate evaluation runs on (docs/SLO.md).

    Bucket counts subtract (clamped at zero: a node restart resets its
    registry, and a negative bucket would poison the percentile walk);
    ``min``/``max`` are not recoverable from cumulative snapshots, so
    the delta keeps the NEW snapshot's extremes — percentile clamping
    stays conservative.  Exemplars keep the NEW snapshot's view too:
    "last request observed in this bucket" is already a point-in-time
    fact, not a cumulative one."""
    if not new:
        return _hist_stats([], 0, 0.0, None, None)
    if not old:
        return dict(new)
    ob = {float(b): int(n) for b, n in old.get("buckets", [])}
    buckets: Dict[float, int] = {}
    for bound, n in new.get("buckets", []):
        d = int(n) - ob.get(float(bound), 0)
        if d > 0:
            buckets[float(bound)] = d
    count = max(0, int(new.get("count", 0)) - int(old.get("count", 0)))
    total = max(0.0, float(new.get("sum", 0.0)) - float(old.get("sum", 0.0)))
    out = _hist_stats(sorted(buckets.items()), count, total,
                      new.get("min"), new.get("max"))
    if new.get("exemplars"):
        out["exemplars"] = [list(e) for e in new["exemplars"]]
    return out


def merge_snapshots(node_snaps: Dict[str, dict],
                    stale: Optional[Dict[str, dict]] = None) -> dict:
    """Merge per-node ``Stats`` snapshots into one cluster snapshot.

    ``node_snaps`` maps node name -> its snapshot (the dict the node's
    Stats RPC returned); ``stale`` maps node name -> status metadata for
    nodes whose snapshot is a LAST-SEEN copy rather than fresh (the
    scraper's shared-deadline contract: a frozen node is reported, not
    waited for).  Returns::

        {"ts", "counters", "gauges", "histograms",   # cluster-merged
         "per_node":  {name: {"role", "status", "age_s", ...}},
         "per_model": {model: {"solve_s": merged-histogram}},
         "stale_nodes": [names]}

    Counters sum (each node's registry counts disjoint local events);
    gauges sum too — the cluster's queue depth / active slots is the
    fleet total, and per-node values stay readable in ``per_node``.
    """
    stale = stale or {}
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hist_by_name: Dict[str, List[dict]] = {}
    per_node: Dict[str, dict] = {}
    for name, snap in node_snaps.items():
        snap = snap or {}
        meta = dict(stale.get(name) or {"status": "ok", "age_s": 0.0})
        meta.setdefault("status", "ok")
        meta["role"] = snap.get("role", meta.get("role", "unknown"))
        meta["uptime_secs"] = snap.get("uptime_secs")
        meta["counters"] = dict(snap.get("counters") or {})
        meta["gauges"] = dict(snap.get("gauges") or {})
        per_node[name] = meta
        for k, v in (snap.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in (snap.get("gauges") or {}).items():
            gauges[k] = gauges.get(k, 0) + v
        for k, h in (snap.get("histograms") or {}).items():
            hist_by_name.setdefault(k, []).append(h)
    histograms = {k: merge_histograms(hs) for k, hs in hist_by_name.items()}
    per_model: Dict[str, dict] = {}
    for k, h in histograms.items():
        if k.startswith(PER_MODEL_HISTOGRAM_PREFIX):
            model = k[len(PER_MODEL_HISTOGRAM_PREFIX):]
            if model:
                per_model[model] = {"solve_s": h}
    return {
        "ts": round(time.time(), 6),
        "nodes": len(node_snaps),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "per_node": per_node,
        "per_model": per_model,
        "stale_nodes": sorted(n for n, m in stale.items()
                              if m.get("status") == "stale"),
    }


def delta_merged(new: dict, old: Optional[dict]) -> dict:
    """Windowed cluster snapshot: counter deltas (clamped at zero) and
    bucket-wise histogram deltas between two merged snapshots.  Gauges
    are point-in-time and keep the new values."""
    if not old:
        return new
    counters = {
        k: max(0, v - (old.get("counters") or {}).get(k, 0))
        for k, v in (new.get("counters") or {}).items()
    }
    histograms = {
        k: delta_histogram(h, (old.get("histograms") or {}).get(k))
        for k, h in (new.get("histograms") or {}).items()
    }
    out = dict(new)
    out["counters"] = counters
    out["histograms"] = histograms
    out["window_s"] = round(
        float(new.get("ts", 0.0)) - float(old.get("ts", 0.0)), 6)
    return out
