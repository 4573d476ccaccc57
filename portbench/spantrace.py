"""What a card's idle time goes to, by its worker's own spans.

The reduction, on plain tuples: device and host events ``(name, start_ns,
duration_ns)`` as ``profile.py`` takes them from the profiler, and the
worker's span records (``SpanRecorder.since``: ``ts`` and ``dur_s`` in
seconds of ``time.time``, ``trace_id`` the Mine a span belongs to), which a
clock anchor puts on the profiler's clock.  ``summarize`` gives the keys a
worker's profile summary would carry:

* ``clock_offset_ms``: the profiler's clock less ``time.time``, from
  ``clock_anchors``' bracketed ranges;
* ``idle_by_span``: seconds of the traced window (first to last host
  operation, as ``profile.summarize`` cuts it) in which the card ran
  nothing, by the span each open search was in (``idle_by_span``);
* ``idle_s`` and ``idle_in_search_s``: the idle seconds, and those in which
  at least one ``worker.solve`` span was open; 100 × the latter ÷
  ``window_s`` is ``device_idle_in_search``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

from .profile import Event, merged

Span = Tuple[str, int, int, int]  # label, start_ns, end_ns on the profiler's clock, trace_id

SEARCH_SPAN = "worker.solve"
NO_SEARCH = "no search open"
PROBE = "search.enqueue.probe"
ANCHOR = "distpow.clock_anchor"


def idle_gaps(device: Sequence[Event], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of ``[lo, hi)`` in which no device event runs."""
    busy = merged([(max(s, lo), min(s + d, hi)) for _, s, d in device if s < hi and s + d > lo])
    edges, at = [], lo
    for s, e in busy:
        if s > at:
            edges.append((at, s))
        at = max(at, e)
    if hi > at:
        edges.append((at, hi))
    return edges


def spans_on_profiler_clock(spans: Sequence[dict], offset_ns: int) -> List[Span]:
    """Span records as ``(label, start_ns, end_ns, trace_id)`` on the
    profiler's clock; the label is the span's name, ``PROBE`` for the
    enqueue of a search's width-0 probe."""
    out = []
    for sp in spans:
        start = round(sp["ts"] * 1e9) + offset_ns
        probe = sp["name"] == "search.enqueue" and sp.get("attrs", {}).get("vw") == 0
        out.append((PROBE if probe else sp["name"], start, start + round(sp["dur_s"] * 1e9),
                    int(sp.get("trace_id", 0))))
    return out


def _labels(open_spans: Dict[int, Span]) -> List[str]:
    """One label for each trace with a span open: its innermost span (the
    one opened last, the shorter of two opened together); none where no
    ``SEARCH_SPAN`` is open."""
    if not any(sp[0] == SEARCH_SPAN for sp in open_spans.values()):
        return []
    inner: Dict[int, Span] = {}
    for sp in open_spans.values():
        held = inner.get(sp[3])
        if held is None or (sp[1], -sp[2]) > (held[1], -held[2]):
            inner[sp[3]] = sp
    return [sp[0] for sp in inner.values()]


def idle_by_span(gaps: Sequence[Tuple[int, int]], spans: Sequence[Span]) -> Dict[str, float]:
    """Seconds of ``gaps`` by label.  Each idle instant is shared equally
    among the traces (searches) with a span open across it, each giving its
    share to its innermost span; where no ``SEARCH_SPAN`` is open it goes to
    ``NO_SEARCH``.  So every idle second is given out exactly once, and a
    search's short spans do not take the instants of the others'."""
    points = []  # (time, order, kind, index): ends before starts at one instant
    for i, (_, s, e, _) in enumerate(spans):
        if e > s:
            points += [(s, 1, "open", i), (e, 0, "close", i)]
    for s, e in gaps:
        points += [(s, 1, "gap", 1), (e, 0, "gap", -1)]
    points.sort()
    out: Dict[str, float] = {}
    open_spans: Dict[int, Span] = {}
    in_gap, prev = 0, None
    for t, _, kind, i in points:
        if in_gap and prev is not None and t > prev:
            labels = _labels(open_spans) or [NO_SEARCH]
            for label in labels:
                out[label] = out.get(label, 0.0) + (t - prev) / 1e9 / len(labels)
        prev = t
        if kind == "gap":
            in_gap += i
        elif kind == "open":
            open_spans[i] = spans[i]
        else:
            open_spans.pop(i, None)
    return out


def in_search_s(idle: Dict[str, float]) -> float:
    """The idle seconds in which a search was open."""
    return sum(s for label, s in idle.items() if label != NO_SEARCH)


def clock_anchors(n: int = 8) -> List[Tuple[int, int]]:
    """Record ``n`` ``ANCHOR`` ranges with the profiler that is recording,
    each bracketed by two ``time.time_ns()`` reads; the brackets, for
    ``anchor_offset_ns``."""
    from torch.profiler import record_function

    brackets = []
    for _ in range(n):
        t0 = time.time_ns()
        with record_function(ANCHOR):
            pass
        brackets.append((t0, time.time_ns()))
    return brackets


def anchor_offset_ns(host: Sequence[Event], brackets: Sequence[Tuple[int, int]]) -> int:
    """The profiler's clock less ``time.time_ns``: where the profiler put an
    ``ANCHOR`` range less the middle of the two ``time.time_ns()`` reads
    that bracket it, the ``i``-th range with the ``i``-th bracket, of the
    narrowest bracket (the one least stretched by another thread taking the
    interpreter between its reads)."""
    starts = sorted(s for name, s, _ in host if name == ANCHOR)
    if len(starts) != len(brackets) or not starts:
        raise RuntimeError(f"the profiler recorded {len(starts)} clock anchors "
                           f"for {len(brackets)} brackets")
    start, (t0, t1) = min(zip(starts, brackets), key=lambda sb: sb[1][1] - sb[1][0])
    return start - (t0 + t1) // 2


def summarize(device: Sequence[Event], host: Sequence[Event], spans: Sequence[dict],
              brackets: Sequence[Tuple[int, int]]) -> dict:
    """The keys above, over the same traced window as
    ``profile.summarize``."""
    offset = anchor_offset_ns(host, brackets)
    lo = min(s for _, s, _ in host)
    hi = max(s + d for _, s, d in host)
    idle = idle_by_span(idle_gaps(device, lo, hi), spans_on_profiler_clock(spans, offset))
    return {"clock_offset_ms": offset / 1e6, "idle_by_span": idle,
            "idle_s": sum(idle.values()), "idle_in_search_s": in_search_s(idle)}
