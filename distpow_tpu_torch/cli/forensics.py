"""Request forensics inspector (docs/FORENSICS.md).

    python -m distpow_tpu_torch.cli.forensics --addr A [--addr B ...]
        [--trace TRACE_ID] [--deadline SECS] [--json]
    python -m distpow_tpu_torch.cli.forensics --discover COORD_ADDR
        [--trace TRACE_ID] [--deadline SECS] [--json]

Fetches the span rings of every listed fleet member concurrently
(``Node.Spans``, one shared ``--deadline`` — an unreachable node is
reported, never waited for), stitches the cross-node timeline for one
trace id, and prints it with the slowness verdicts: the slowest
segment overall and the slowest *shard-attributed* segment ("here is
the shard that made this Mine slow").

``--discover COORD_ADDR`` pulls the scrape list from the coordinator's
live membership table (``Fleet.Members``, docs/FLEET.md) exactly like
``stats --cluster --discover``, so an elastic fleet is swept without a
hand-maintained address list; extra ``--addr`` flags merge in.

Without ``--trace``, a summaries sweep runs first and the SLOWEST
recent trace across the fleet is chosen — "show me the worst request
you remember" with no id in hand.  Trace ids come from anywhere the
tracing plane surfaces them: a client's ``MineResult`` token, histogram
exemplars (``stats --prom --openmetrics``), a ``forensics.slow_request``
flight-recorder capture, or an SLO breach dump's ``slow_requests``.

``--json`` prints the stitched timeline as machine-readable JSON — the
span-ring shape the reference's ``scripts/trace_profile.py`` reads.

Exit codes: 0 — timeline stitched; 1 — no spans found for the trace
(or no node answered); 2 — usage error.

The port's own copy of the reference's ``cli/forensics.py``; it imports
no ``torch``.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="stitch one request's cross-node span timeline"
    )
    ap.add_argument("--addr", action="append", default=None,
                    help="node RPC address host:port (repeatable; each "
                         "flag may hold a comma list)")
    ap.add_argument("--discover", metavar="COORD_ADDR", action="append",
                    default=None,
                    help="pull the sweep list from the coordinators' "
                         "live membership tables (Fleet.Members, "
                         "dedup-merged across the pool — one member of "
                         "a sharded pool names the rest via the ring; "
                         "docs/CLUSTER.md); repeatable, comma lists ok")
    ap.add_argument("--trace", type=int, default=None,
                    help="trace id to stitch; omitted = the slowest "
                         "recent trace any swept node remembers")
    ap.add_argument("--deadline", type=float, default=5.0,
                    help="shared sweep deadline in seconds")
    ap.add_argument("--limit", type=int, default=512,
                    help="max spans fetched per node")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable stitched timeline on stdout")
    args = ap.parse_args(argv)

    from ..obs.forensics import (
        fetch_spans,
        render_timeline,
        slowest_trace_id,
        stitch_timeline,
    )
    from ..runtime.rpc import RPCError

    addrs = [a for flag in (args.addr or []) for a in flag.split(",") if a]
    if args.discover:
        from .stats import discover_cluster_addrs

        try:
            discovered = discover_cluster_addrs(args.discover,
                                                timeout=args.deadline)
        except (OSError, RPCError, RuntimeError) as exc:
            print(f"error: membership discovery against "
                  f"{','.join(args.discover)} failed: {exc}",
                  file=sys.stderr)
            return 1
        addrs = discovered + [a for a in addrs if a not in discovered]
    if not addrs:
        ap.error("--addr (or --discover) is required")

    trace_id = args.trace
    if trace_id is None:
        summaries = fetch_spans(addrs, trace_id=None,
                                deadline_s=args.deadline,
                                limit=args.limit)
        trace_id = slowest_trace_id(summaries)
        if trace_id is None:
            print("error: no node remembers any trace (span rings "
                  "empty, or no node answered)", file=sys.stderr)
            return 1
        print(f"# --trace omitted: stitching the slowest recent trace "
              f"{trace_id}", file=sys.stderr)

    fetched = fetch_spans(addrs, trace_id=trace_id,
                          deadline_s=args.deadline, limit=args.limit)
    timeline = stitch_timeline(fetched, trace_id)
    if args.as_json:
        print(json.dumps(timeline, indent=2))
    else:
        print(render_timeline(timeline))
    return 0 if timeline["spans"] else 1


if __name__ == "__main__":
    sys.exit(main())
