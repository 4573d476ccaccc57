"""Cluster SLO gate (``obs/slo.py``; docs/SLO.md).

    python -m distpow_tpu_torch.cli.slo --config config/slo.json \
        --addr COORD [--addr WORKER ...] [--deadline SECS] \
        [--interval SECS --count N] [--json]

Scrapes every ``--addr`` node's Stats concurrently (one shared
deadline; frozen nodes go ``stale``, the verdict still renders), merges
the snapshots, and evaluates the declarative SLO config.  Exit code is
the CI contract:

* ``0`` — every objective passed (warns included: a warn is a page-
  worthy signal, not a gate failure);
* ``1`` — at least one objective BREACHED (the breach also lands as an
  ``slo.breach`` flight-recorder event, plus a ring dump with the
  critical path when a telemetry dir is configured);
* ``2`` — config error (malformed JSON, unknown metric name): the gate
  refuses to evaluate rather than pass vacuously.

``--interval``/``--count`` run repeated sweeps feeding the burn-rate
windows (one-shot runs degrade both windows to cumulative —
docs/SLO.md); the final evaluation's exit code is returned.

The port's own copy of the reference's ``cli/slo.py``; it imports no
``torch``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..obs.scrape import FleetScraper, NodeTarget
from ..obs.slo import SLOConfigError, SLOEngine, load_slo_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="evaluate cluster SLOs over merged node metrics")
    ap.add_argument("--config", required=True,
                    help="SLO config JSON (see config/slo.json)")
    ap.add_argument("--addr", action="append", default=None,
                    help="node RPC address (repeatable; comma lists ok)")
    ap.add_argument("--discover", metavar="COORD_ADDR", action="append",
                    default=None,
                    help="pull the sweep list from the coordinators' "
                         "live membership tables (Fleet.Members, "
                         "dedup-merged across the pool — one member of "
                         "a sharded pool names the rest via the ring; "
                         "docs/CLUSTER.md); repeatable, comma lists ok. "
                         "Extra --addr flags merge in.")
    ap.add_argument("--role", choices=["auto", "coordinator", "worker"],
                    default="auto")
    ap.add_argument("--deadline", type=float, default=5.0,
                    help="shared sweep deadline (seconds)")
    ap.add_argument("--interval", type=float, default=None,
                    help="sweep every SECS, feeding the burn-rate windows")
    ap.add_argument("--count", type=int, default=0,
                    help="with --interval: evaluate after N sweeps "
                         "(default 3)")
    ap.add_argument("--json", action="store_true",
                    help="print the typed verdict as JSON")
    args = ap.parse_args(argv)
    addrs = [a for flag in (args.addr or []) for a in flag.split(",") if a]
    if args.interval is not None and args.interval <= 0:
        ap.error("--interval SECS must be positive")
    if args.discover:
        from ..runtime.rpc import RPCError
        from .stats import discover_cluster_addrs

        try:
            discovered = discover_cluster_addrs(args.discover,
                                                timeout=args.deadline)
        except (OSError, RPCError, RuntimeError) as exc:
            print(f"error: membership discovery against "
                  f"{','.join(args.discover)} failed: {exc}",
                  file=sys.stderr)
            return 2
        addrs = discovered + [a for a in addrs if a not in discovered]
    if not addrs:
        ap.error("--addr (or --discover) is required")

    try:
        config = load_slo_config(args.config)
    except SLOConfigError as exc:
        print(f"slo config error: {exc}", file=sys.stderr)
        return 2

    # span_addrs: on breach the engine sweeps these nodes' Node.Spans
    # for the slow-request timelines — this gate process has no local
    # span ring of its own (docs/FORENSICS.md)
    engine = SLOEngine(config, span_addrs=addrs)
    scraper = FleetScraper(
        [NodeTarget(addr=a, role=args.role) for a in addrs],
        deadline_s=args.deadline,
    )
    try:
        sweeps = max(1, args.count or 3) if args.interval else 1
        for i in range(sweeps):
            if i:
                time.sleep(args.interval)
            engine.observe(scraper.sweep())
        verdict = engine.evaluate()
    except (OSError, RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    finally:
        scraper.close()
    print(json.dumps(verdict.to_dict(), indent=2) if args.json
          else verdict.render(), flush=True)
    return verdict.exit_code()


if __name__ == "__main__":
    sys.exit(main())
