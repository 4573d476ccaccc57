"""Node metrics inspector.

    python -m distpow_tpu_torch.cli.stats --addr HOST:PORT
        [--role auto|coordinator|worker] [--prom] [--watch SECS [--count N]]
    python -m distpow_tpu_torch.cli.stats --cluster --addr A [--addr B ...]
        [--deadline SECS] [--prom]
    python -m distpow_tpu_torch.cli.stats --cluster --discover COORD_ADDR
        [--deadline SECS] [--prom]

Dials the node's RPC port, calls its ``Stats`` method, and prints the
JSON snapshot.  ``--role auto`` (default) tries the role-agnostic
``Node.Stats`` alias first (every current node answers it without
minting a handler error), falling back to the coordinator's then the
worker's service name for pre-alias nodes.  For a coordinator, use the
CLIENT-facing listen address.  A port worker's snapshot also carries
``device`` and ``kernel_launches`` (the launches of each CUDA kernel
form in its process); the JSON shows them as they are.

``--cluster`` accepts MULTIPLE ``--addr`` flags (each may also be a
comma-separated list), polls every node's Stats concurrently under one
shared ``--deadline``, and prints the bucket-wise MERGED cluster
snapshot (``obs/``, docs/SLO.md): summed counters/gauges,
merged histograms with cluster percentiles, per-node status — a node
that fails to answer in time is reported ``stale`` with its last-seen
age, never waited for.  With ``--prom`` the merged series are emitted
cluster-labelled (``distpow_node_info{node=...}`` /
``distpow_node_stale{node=...}`` per node rides alongside).

``--discover COORD_ADDR`` replaces the hand-maintained ``--addr`` list
with the coordinator's LIVE membership table (``Fleet.Members``,
docs/FLEET.md): the sweep covers the coordinator plus every current
member — static and lease-registered alike — so an elastic fleet is
tracked automatically as workers join, drain and expire.  Extra
``--addr`` flags still merge in (e.g. a node outside this
coordinator's fleet).

``--prom`` renders the snapshot as Prometheus text exposition (version
0.0.4): counters/gauges become ``distpow_<name>`` samples and every
histogram becomes a full ``_bucket{le=...}/_sum/_count`` family built
from the registry's log buckets (``device`` and ``kernel_launches`` get
no family).  ``--prom --openmetrics`` upgrades to OpenMetrics: buckets
carry their retained ``{trace_id=...}`` exemplars (the forensics plane's
pointer from "p99 moved" to the one request that landed there —
docs/FORENSICS.md) and the exposition closes with ``# EOF``.
``--watch SECS`` re-fetches every SECS seconds and prints counter
deltas plus live histogram quantiles (``--count N`` bounds the
refreshes; default unbounded, Ctrl-C exits).  docs/METRICS.md is the
registry catalog.

The port's own copy of the reference's ``cli/stats.py``; it imports no
``torch`` and reads either package's nodes.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout

from ..runtime.rpc import RPCClient, RPCError


def fetch_stats(addr: str, role: str = "auto", timeout: float = 5.0) -> dict:
    # ONE role->service table for every observability consumer: the
    # fleet scraper owns it (obs/scrape.py _SERVICES — auto tries the
    # role-agnostic Node.Stats alias first); duplicating it here is how
    # the CLI and the scraper would drift apart
    from ..obs.scrape import _SERVICES

    services = _SERVICES[role]
    # pinned to the JSON floor codec: this diagnostic dials a FRESH
    # connection per fetch (watch mode rides out restarts that way), and
    # a per-poll rpc.hello would tick the observed node's negotiation
    # counters — the watcher must not perturb the counters it watches
    client = RPCClient(addr, timeout=timeout, codec="json")
    try:
        last: Exception = RuntimeError("no services tried")
        for method in services:
            try:
                return client.call(method, {}, timeout=timeout)
            except (RPCError, FutureTimeout) as exc:
                # FutureTimeout is only an OSError alias on 3.11+
                last = exc
        raise last
    finally:
        client.close()


def discover_cluster_addrs(coord_addrs, timeout: float = 5.0) -> list:
    """Coordinator membership -> scrape address list (``Fleet.Members``
    dedup-merged across the POOL; docs/FLEET.md, docs/CLUSTER.md).

    ``coord_addrs``: one address (the historical shape) or a list of
    coordinator addresses.  The pool is expanded first: any member's
    Stats snapshot names the whole ring (the coordinator ``cluster``
    key), so ONE seed suffices to cover a sharded pool — and the probe
    rides the error-free ``Node.Stats`` path, never minting
    ``rpc.handler_errors`` on the node being observed (the
    watcher-perturbation class docs/SLO.md documents).  Every reachable
    pool coordinator's ``Fleet.Members`` is then merged with
    de-duplication, so the sweep covers all coordinators plus every
    current member — static and lease-registered alike — across all
    shards.  Draining members are still scraped (they serve until their
    lease releases); expired ones are already gone from the tables.
    Raises only when NO coordinator answered; a partially-dead pool
    still yields the survivors' view.
    """
    seeds = ([coord_addrs] if isinstance(coord_addrs, str)
             else list(coord_addrs))
    coords: list = []
    for flag in seeds:
        for a in flag.split(","):
            if a and a not in coords:
                coords.append(a)
    # pool expansion via the ring advertised in Stats snapshots —
    # probed CONCURRENTLY under one shared deadline (the FleetScraper
    # discipline): a frozen pool member must cost the sweep at most
    # one timeout total, not one per serial probe
    expansion = _concurrent_probe(
        coords, lambda a: fetch_stats(a, timeout=timeout), timeout)
    for a in list(coords):
        snap = expansion.get(a)
        if not isinstance(snap, dict):
            continue
        ring = (snap.get("cluster") or {}).get("ring") or {}
        for _member, addr in ring.get("members") or []:
            if addr and addr not in coords:
                coords.append(addr)
    addrs = list(coords)

    def members_of(coord: str) -> dict:
        client = RPCClient(coord, timeout=timeout, codec="json")
        try:
            return client.call("Fleet.Members", {}, timeout=timeout)
        finally:
            client.close()

    tables = _concurrent_probe(coords, members_of, timeout)
    reached = 0
    last_exc: Exception = RuntimeError("no coordinator addresses given")
    for coord in coords:
        table = tables.get(coord)
        if not isinstance(table, dict):
            if isinstance(table, Exception):
                last_exc = table
            elif table is None and coords:
                last_exc = RuntimeError(
                    f"{coord} missed the {timeout}s discovery deadline")
            continue
        reached += 1
        for m in table.get("workers") or []:
            a = m.get("addr")
            if a and a not in addrs:
                addrs.append(a)
    if not reached:
        raise last_exc
    return addrs


def _concurrent_probe(addrs, fn, deadline_s: float) -> dict:
    """Run ``fn(addr)`` for every address on its own thread and join
    them all under ONE shared deadline — addr -> result dict, with
    exceptions held as values and deadline-missers absent.  Threads
    are daemons, so an abandoned slow probe cannot pin the CLI."""
    results: dict = {}

    def one(a):
        try:
            results[a] = fn(a)
        except Exception as exc:
            results[a] = exc

    threads = [threading.Thread(target=one, args=(a,), daemon=True)
               for a in addrs]
    for t in threads:
        t.start()
    deadline = time.monotonic() + deadline_s
    for t in threads:
        t.join(timeout=max(0.05, deadline - time.monotonic()))
    return dict(results)


def _prom_name(name: str) -> str:
    """Registry name -> Prometheus metric name (dots and any other
    non-identifier characters become underscores)."""
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    if safe and safe[0].isdigit():
        safe = "_" + safe
    return f"distpow_{safe}"


def _prom_num(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snap: dict, openmetrics: bool = False) -> str:
    """Snapshot -> Prometheus text exposition (0.0.4).

    Histograms are re-emitted cumulatively from the snapshot's
    non-cumulative log buckets (runtime/metrics.py Histogram.to_dict),
    closed by the mandatory ``+Inf`` bucket equal to ``_count``.

    ``openmetrics=True`` (``--prom --openmetrics``) upgrades the output
    to OpenMetrics: each bucket that retains an exemplar appends the
    ``# {trace_id="..."} value ts`` clause (docs/FORENSICS.md — the
    pointer from a bucket to the one request that last landed there),
    and the exposition is closed by the mandatory ``# EOF``.
    """
    out = []
    role = snap.get("role", "unknown")
    out.append("# HELP distpow_node_info node role marker (value is 1)")
    out.append("# TYPE distpow_node_info gauge")
    out.append(f'distpow_node_info{{role="{role}"}} 1')
    if "uptime_secs" in snap:
        out.append("# TYPE distpow_uptime_seconds gauge")
        out.append(f"distpow_uptime_seconds {_prom_num(snap['uptime_secs'])}")
    for name, v in sorted((snap.get("counters") or {}).items()):
        pname = _prom_name(name) + "_total"
        out.append(f"# TYPE {pname} counter")
        out.append(f"{pname} {_prom_num(v)}")
    for name, v in sorted((snap.get("gauges") or {}).items()):
        pname = _prom_name(name)
        out.append(f"# TYPE {pname} gauge")
        out.append(f"{pname} {_prom_num(v)}")
    for name, h in sorted((snap.get("histograms") or {}).items()):
        pname = _prom_name(name)
        out.append(f"# TYPE {pname} histogram")
        exemplars = {}
        if openmetrics:
            exemplars = {_prom_num(b): (tid, v, ts)
                         for b, tid, v, ts in h.get("exemplars", [])}
        cum = 0
        for le, count in h.get("buckets", []):
            cum += count
            line = f'{pname}_bucket{{le="{_prom_num(le)}"}} {cum}'
            ex = exemplars.get(_prom_num(le))
            if ex is not None:
                tid, v, ts = ex
                line += (f' # {{trace_id="{tid}"}} {_prom_num(v)} '
                         f"{_prom_num(ts)}")
            out.append(line)
        out.append(f'{pname}_bucket{{le="+Inf"}} {h["count"]}')
        out.append(f"{pname}_sum {_prom_num(h.get('sum', 0))}")
        out.append(f"{pname}_count {h['count']}")
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"


def render_cluster_prometheus(cluster: dict, openmetrics: bool = False) -> str:
    """Merged cluster snapshot -> Prometheus text exposition.

    The merged counters/gauges/histograms render through the same
    single-node path (they share its snapshot shape) under
    ``role="cluster"``; per-node membership, staleness, and last-seen
    age ride as labelled gauges so one scrape shows both the cluster
    view and which nodes it is missing.  ``openmetrics`` appends the
    merged exemplars to the bucket lines (render_prometheus) — the
    ``# EOF`` terminator is re-seated after the per-node block so the
    exposition stays well-formed."""
    body = render_prometheus(dict(cluster, role="cluster"),
                             openmetrics=openmetrics)
    if openmetrics:
        body = body.rstrip("\n").rsplit("\n# EOF", 1)[0] + "\n"
    out = [body.rstrip("\n")]
    per_node = cluster.get("per_node") or {}
    if per_node:
        out.append("# HELP distpow_node_stale node missed the sweep "
                   "deadline (1) or answered (0)")
        out.append("# TYPE distpow_node_stale gauge")
        for name, meta in sorted(per_node.items()):
            role = meta.get("role", "unknown")
            out.append(
                f'distpow_node_info{{role="{role}",node="{name}"}} 1')
            stale = 1 if meta.get("status") == "stale" else 0
            out.append(f'distpow_node_stale{{node="{name}"}} {stale}')
            age = meta.get("age_s")
            if age is not None:
                out.append(
                    f'distpow_node_age_seconds{{node="{name}"}} '
                    f"{_prom_num(age)}")
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"


def _fmt_quantiles(h: dict) -> str:
    def f(v):
        return "-" if v is None else f"{v:.4g}"

    return (f"n={h['count']} p50={f(h.get('p50'))} "
            f"p95={f(h.get('p95'))} p99={f(h.get('p99'))} "
            f"max={f(h.get('max'))}")


def render_watch_delta(prev: dict, snap: dict) -> str:
    """One --watch refresh frame: counter deltas since the previous
    snapshot (only movers shown), current gauges, histogram quantiles."""
    out = [f"--- {snap.get('role', '?')} @ {time.strftime('%H:%M:%S')} "
           f"(uptime {snap.get('uptime_secs', 0):.0f}s)"]
    pc = (prev.get("counters") or {}) if prev else {}
    moved = False
    for name, v in sorted((snap.get("counters") or {}).items()):
        d = v - pc.get(name, 0)
        if d:
            out.append(f"  {name:34s} {v:>12} (+{d})")
            moved = True
    if not moved:
        out.append("  (no counter movement)")
    for name, v in sorted((snap.get("gauges") or {}).items()):
        out.append(f"  {name:34s} {v:>12}")
    for name, h in sorted((snap.get("histograms") or {}).items()):
        out.append(f"  {name:34s} {_fmt_quantiles(h)}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="print a distpow node's metrics")
    ap.add_argument("--addr", action="append", default=None,
                    help="node RPC address host:port (repeatable with "
                         "--cluster; each flag may hold a comma list)")
    ap.add_argument("--discover", metavar="COORD_ADDR", action="append",
                    default=None,
                    help="with --cluster: pull the scrape list from the "
                         "coordinators' live membership tables "
                         "(Fleet.Members, dedup-merged across the pool) "
                         "instead of --addr flags; repeatable, comma "
                         "lists ok — one member of a sharded pool is "
                         "enough, the ring names the rest "
                         "(docs/CLUSTER.md)")
    ap.add_argument("--role", choices=["auto", "coordinator", "worker"],
                    default="auto")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--prom", action="store_true",
                    help="Prometheus text exposition instead of JSON")
    ap.add_argument("--openmetrics", action="store_true",
                    help="with --prom: OpenMetrics output — histogram "
                         "buckets carry their retained trace-id "
                         "exemplars and the exposition ends with # EOF "
                         "(docs/FORENSICS.md)")
    ap.add_argument("--watch", type=float, metavar="SECS", default=None,
                    help="refresh every SECS seconds, printing deltas")
    ap.add_argument("--count", type=int, default=0,
                    help="with --watch: stop after N refreshes (0 = forever)")
    ap.add_argument("--cluster", action="store_true",
                    help="scrape every --addr concurrently and print the "
                         "merged cluster snapshot (docs/SLO.md)")
    ap.add_argument("--deadline", type=float, default=5.0,
                    help="with --cluster: shared sweep deadline in seconds"
                         " — slower nodes are reported stale, not waited on")
    args = ap.parse_args(argv)
    addrs = [a for flag in (args.addr or []) for a in flag.split(",") if a]
    if args.watch is not None and args.watch <= 0:
        ap.error("--watch SECS must be positive")
    if args.discover and not args.cluster:
        ap.error("--discover requires --cluster")
    if args.openmetrics and not args.prom:
        ap.error("--openmetrics requires --prom")
    if not addrs and not args.discover:
        ap.error("--addr (or --cluster --discover) is required")
    if args.cluster:
        if args.watch is not None:
            ap.error("--cluster does not support --watch")
        from ..obs.scrape import scrape_cluster

        if args.discover:
            try:
                discovered = discover_cluster_addrs(
                    args.discover, timeout=args.timeout)
            except (OSError, RPCError, FutureTimeout, RuntimeError) as exc:
                print(f"error: membership discovery against "
                      f"{','.join(args.discover)} failed: {exc}",
                      file=sys.stderr)
                return 1
            # explicit --addr extras merge in after the discovered set
            addrs = discovered + [a for a in addrs if a not in discovered]

        cluster = scrape_cluster(addrs, deadline_s=args.deadline,
                                 role=args.role)
        text = render_cluster_prometheus(
            cluster, openmetrics=args.openmetrics
        ) if args.prom else json.dumps(cluster, indent=2, sort_keys=True)
        try:
            print(text, flush=True)
        except BrokenPipeError:
            return 0
        # partial visibility is an error signal for scripts: a sweep
        # that lost nodes exits 1 even though it printed what it saw
        return 1 if cluster.get("stale_nodes") else 0
    if len(addrs) != 1:
        ap.error("multiple --addr values require --cluster")
    args.addr = addrs[0]

    try:
        prev: dict = {}
        n = 0
        while True:
            try:
                snap = fetch_stats(args.addr, args.role, args.timeout)
            except (OSError, RPCError, FutureTimeout) as exc:
                if args.watch is None:
                    raise
                # watch mode exists to observe nodes THROUGH outages: a
                # refused dial during a restart must not end the session
                # at exactly the moment the deltas matter.  A failed
                # fetch still consumes one --count slot, so a bounded
                # watch terminates even against a permanently dead node
                print(f"[stats] fetch failed ({exc}); retrying in "
                      f"{args.watch}s", file=sys.stderr)
                n += 1
                if args.count and n >= args.count:
                    return 1
                time.sleep(args.watch)
                continue
            if args.prom:
                text = render_prometheus(snap,
                                         openmetrics=args.openmetrics)
            elif args.watch is not None:
                text = render_watch_delta(prev, snap)
            else:
                text = json.dumps(snap, indent=2, sort_keys=True)
            try:
                print(text, flush=True)
            except BrokenPipeError:  # e.g. piped into `head`
                return 0
            if args.watch is None:
                return 0
            prev = snap
            n += 1
            if args.count and n >= args.count:
                return 0
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0
    except (OSError, RPCError, FutureTimeout) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
