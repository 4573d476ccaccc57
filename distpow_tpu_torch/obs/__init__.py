"""Cluster observability plane (docs/SLO.md).

Every node has its own registry, histograms, and ``stats --prom`` —
per-node observability.  This package is the *cluster-level* layer on
top of it:

* :mod:`.merge`  — bucket-wise merging of the per-node log-bucketed
  histogram snapshots into cluster percentiles, plus counter/gauge
  aggregation with per-node and per-hash-model breakdowns;
* :mod:`.scrape` — a fleet scraper that polls every node's ``Stats``
  RPC concurrently under one shared deadline (RPC futures and the
  wire codec), marking unreachable or frozen nodes ``stale`` with their
  last-seen age instead of stalling the sweep;
* :mod:`.slo`    — a declarative SLO engine: objectives in a checked-in
  config file (config/slo.json) evaluated over merged snapshots with
  fast/slow burn-rate windows, producing a typed verdict, a nonzero
  exit code for CI, and a flight-recorder breach event + critical-path
  dump (:mod:`.trace_profile`, with the top-k slowest request
  timelines) on breach;
* :mod:`.forensics` — per-request cross-node forensics
  (docs/FORENSICS.md): concurrent ``Node.Spans`` sweeps over the fleet
  and timeline stitching that names the shard/segment a slow Mine
  spent its time in;
* :mod:`.timeseries` — bounded multi-resolution retention of merged
  sweeps (docs/SOAK.md): tiered downsampling on the shared
  log-bucket grid, windowed delta queries (the SLO engine's burn
  windows read these), gauge trajectories for the leak sentinels, and
  a rotated JSONL spool for post-mortem replay.

The port's own copy of the reference's ``obs/`` package: it imports no
``torch``, so the device-less CLIs that use it stay free of it.  Nodes,
snapshots, span replies and spool files cross between the two packages.

Consumers: ``python -m distpow_tpu_torch.cli.stats --cluster``,
``python -m distpow_tpu_torch.cli.slo``, ``python -m
distpow_tpu_torch.cli.forensics``, and the open-loop load harness and
soak (``distpow_tpu_torch/load/``).
"""

from .forensics import fetch_spans, render_timeline, stitch_timeline
from .merge import merge_histograms, merge_snapshots, merged_percentile
from .scrape import FleetScraper, NodeTarget, scrape_cluster
from .slo import (
    ObjectiveVerdict,
    SLOConfigError,
    SLOEngine,
    SLOVerdict,
    load_slo_config,
)
from .timeseries import DEFAULT_TIERS, Tier, TimeSeriesStore, replay_spool

__all__ = [
    "fetch_spans",
    "stitch_timeline",
    "render_timeline",
    "merge_histograms",
    "merge_snapshots",
    "merged_percentile",
    "FleetScraper",
    "NodeTarget",
    "scrape_cluster",
    "SLOConfigError",
    "SLOEngine",
    "SLOVerdict",
    "ObjectiveVerdict",
    "load_slo_config",
    "Tier",
    "TimeSeriesStore",
    "DEFAULT_TIERS",
    "replay_spool",
]
