"""Cross-node request forensics assembly (docs/FORENSICS.md).

The span layer (runtime/spans.py) gives every node a bounded ring of
per-trace timing spans and a ``Node.Spans`` RPC to export them; this
module turns those per-node rings into ONE answer to "which
shard/slot/launch made this request slow":

* :func:`fetch_spans` sweeps every fleet member's ``Node.Spans``
  concurrently under one shared deadline — the scraper discipline
  (obs/scrape.py): per-node poll threads, an unreachable or frozen
  node is reported, never waited for;
* :func:`stitch_timeline` merges the per-node span lists into one
  wall-clock-ordered timeline (dedup by ``(node, seq, name, ts)`` —
  in-process harnesses share a ring, so every node answers with the
  union), anchors relative offsets at the earliest span, and
  attributes the request's slowness: the slowest SEGMENT overall and
  the slowest *shard-attributed* segment (``worker.solve`` /
  ``worker.result_forward`` / ``coord.reassign`` — the spans that name
  a shard), which is the "here is the shard that made it slow" verdict
  the CLI reports.

Clock caveat: spans carry wall-clock start timestamps, so cross-node
offsets are only as honest as the fleet's clock sync — within one
machine (the harnesses) they are exact; across hosts, NTP-grade skew
shifts whole nodes' lanes without changing any span's duration, and
durations are what the slowness verdicts rank.

The port's own copy of the reference's ``obs/forensics.py``.  The
``Node.Spans`` replies of either package's nodes stitch alike.

Consumer: ``python -m distpow_tpu_torch.cli.forensics``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, List, Optional

from ..runtime.metrics import REGISTRY as metrics
from ..runtime.rpc import RPCClient, RPCError

#: umbrella spans cover the whole request by construction — they can
#: never be the "slowest segment" verdict (they'd always win).
UMBRELLA_SPANS = frozenset({"powlib.mine", "coord.mine"})

#: attr keys that name a shard on a span (docs/FORENSICS.md span
#: vocabulary).  Deliberately excludes ``winner_byte``: the
#: first-result span's winner is the FASTEST shard, and ranking it as
#: "slow" would invert the verdict.
_SHARD_KEYS = ("shard", "worker_byte")


def shard_of(span: Optional[dict]) -> Optional[int]:
    """The shard a span names, or None for unattributed spans."""
    if not span:
        return None
    attrs = span.get("attrs") or {}
    for k in _SHARD_KEYS:
        v = attrs.get(k)
        if v is not None:
            return int(v)
    return None


def fetch_spans(addrs: List[str], trace_id: Optional[int] = None,
                deadline_s: float = 5.0, dial_timeout_s: float = 2.0,
                limit: int = 512) -> dict:
    """Concurrent ``Node.Spans`` sweep over ``addrs`` under one shared
    deadline.  With a ``trace_id``, each node answers with its spans
    for that trace; without one, with summaries of its recent traces
    (how a caller finds the trace worth fetching).  Returns
    ``{"nodes": {addr: reply}, "unreachable": {addr: error}}`` — the
    sweep always completes within ~``deadline_s``."""
    metrics.inc("forensics.fetches")
    results: Dict[str, dict] = {}
    errors: Dict[str, str] = {}
    lock = threading.Lock()
    deadline = time.monotonic() + float(deadline_s)

    def poll(addr: str) -> None:
        client = None
        try:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("sweep deadline exhausted")
            client = RPCClient(addr,
                               timeout=min(dial_timeout_s, remaining))
            params: dict = {"limit": int(limit)}
            if trace_id is not None:
                params["trace_id"] = int(trace_id)
            remaining = max(0.05, deadline - time.monotonic())
            reply = client.go("Node.Spans", params).result(
                timeout=remaining)
            with lock:
                results[addr] = reply or {}
        except (OSError, RPCError, RuntimeError, TimeoutError,
                FutureTimeout) as exc:
            metrics.inc("forensics.fetch_failures")
            with lock:
                errors[addr] = f"{type(exc).__name__}: {exc}"
        finally:
            if client is not None:
                try:
                    client.close()
                except OSError:
                    pass

    threads = []
    for addr in addrs:
        t = threading.Thread(target=poll, args=(addr,), daemon=True,
                             name=f"forensics-{addr}")
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()) + 0.25)
    return {"nodes": results, "unreachable": errors}


def slowest_request_timelines(addrs: List[str], k: int = 5,
                              deadline_s: float = 5.0) -> List[dict]:
    """Top-k slowest recent request timelines across a REMOTE fleet —
    the cross-process twin of ``SPANS.slowest_traces`` (same shape:
    per-trace summaries with their span trees attached).  One
    summaries sweep ranks the candidates; one per-trace sweep fetches
    each tree (k is small and bounded).  Used by the SLO engine's
    breach evidence when the judging process has no local span ring —
    the ``cli/slo.py`` gate observing a separate-process cluster."""
    summaries = fetch_spans(addrs, trace_id=None, deadline_s=deadline_s)
    ranked: Dict[int, dict] = {}
    for reply in (summaries.get("nodes") or {}).values():
        for t in reply.get("traces") or []:
            tid = t.get("trace_id")
            if tid is None:
                continue
            cur = ranked.get(tid)
            if cur is None or float(t.get("dur_s") or 0.0) > \
                    float(cur.get("dur_s") or 0.0):
                ranked[tid] = dict(t)
    top = sorted(ranked.values(),
                 key=lambda t: -float(t.get("dur_s") or 0.0))[:k]
    out = []
    for t in top:
        fetched = fetch_spans(addrs, trace_id=t["trace_id"],
                              deadline_s=deadline_s)
        t["spans"] = stitch_timeline(fetched, t["trace_id"])["spans"]
        out.append(t)
    return out


def slowest_trace_id(fetched: dict) -> Optional[int]:
    """From a summaries sweep (``fetch_spans`` with no trace_id), the
    id of the slowest recent trace across every node that answered."""
    best_tid = None
    best_dur = -1.0
    for reply in (fetched.get("nodes") or {}).values():
        for t in reply.get("traces") or []:
            d = float(t.get("dur_s") or 0.0)
            if d > best_dur:
                best_dur = d
                best_tid = t.get("trace_id")
    return best_tid


def stitch_timeline(fetched: dict, trace_id: int) -> dict:
    """Merge the per-node span lists into one request timeline
    (module docstring).  The returned dict is the forensics CLI's
    ``--json`` shape, which the reference's ``scripts/trace_profile.py``
    reads as its span-ring input."""
    spans: List[dict] = []
    seen = set()
    for label, reply in (fetched.get("nodes") or {}).items():
        answering = reply.get("node") or label
        for s in reply.get("spans") or []:
            node = s.get("node") or answering
            key = (node, s.get("seq"), s.get("name"), s.get("ts"))
            if key in seen:
                continue
            seen.add(key)
            spans.append(dict(s, node=node))
    spans.sort(key=lambda s: (s.get("ts", 0.0), s.get("seq", 0)))
    out: dict = {
        "format": "spans",
        "trace_id": int(trace_id),
        "spans": spans,
        "nodes": sorted({s["node"] for s in spans}),
        "unreachable": dict(fetched.get("unreachable") or {}),
    }
    if not spans:
        return out
    epoch = min(s["ts"] for s in spans)
    for s in spans:
        s["rel_ms"] = round((s["ts"] - epoch) * 1000.0, 3)
    out["wall_s"] = round(
        max(s["ts"] + s.get("dur_s", 0.0) for s in spans) - epoch, 6)
    segments = [s for s in spans if s["name"] not in UMBRELLA_SPANS]
    if segments:
        out["slowest"] = max(segments, key=lambda s: s.get("dur_s", 0.0))
    shard_segs = [s for s in segments if shard_of(s) is not None]
    if shard_segs:
        seg = max(shard_segs, key=lambda s: s.get("dur_s", 0.0))
        out["slowest_shard_segment"] = seg
        out["slow_shard"] = shard_of(seg)
    return out


def _fmt_attrs(attrs: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))


def render_timeline(tl: dict) -> str:
    """Human one-screen timeline: per-span rows in wall-clock order
    with relative offsets, closed by the slowness verdicts."""
    head = [f"# trace {tl['trace_id']}: {len(tl.get('spans') or [])} "
            f"span(s) across {len(tl.get('nodes') or [])} node(s)"
            + (f", {tl['wall_s']:.3f}s wall" if "wall_s" in tl else "")]
    for addr, err in sorted((tl.get("unreachable") or {}).items()):
        head.append(f"# unreachable: {addr} ({err})")
    rows = []
    for s in tl.get("spans") or []:
        rows.append(
            f"  {s.get('rel_ms', 0.0):>10.1f}ms "
            f"+{s.get('dur_s', 0.0) * 1000.0:>9.1f}ms "
            f"[{s.get('node', '?')}] {s['name']}  "
            f"{_fmt_attrs(s.get('attrs') or {})}".rstrip()
        )
    tail = []
    slow = tl.get("slowest")
    if slow is not None:
        tail.append(f"# slowest segment: {slow['name']} on "
                    f"{slow.get('node', '?')} "
                    f"({slow.get('dur_s', 0.0) * 1000.0:.1f}ms)")
    seg = tl.get("slowest_shard_segment")
    if seg is not None:
        tail.append(f"# slow shard: {tl['slow_shard']} via {seg['name']} "
                    f"on {seg.get('node', '?')} "
                    f"({seg.get('dur_s', 0.0) * 1000.0:.1f}ms)")
    return "\n".join(head + rows + tail)
