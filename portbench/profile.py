"""Reduce one worker process's profiler trace of the window to a summary.

The node launcher (``launcher.py``) runs ``torch.profiler`` over
the measured window only and hands its events here as plain tuples
``(name, start_ns, duration_ns)``: the device's operations (kernels,
copies, fills) and the host's (PyTorch operators and CUDA runtime calls,
on any thread).  The summary is what the per-layer metrics and the
result's ``breakdown`` read:

* ``window_s``: the traced window's length, from the first host
  operation the profiler recorded to the end of the last one (the
  harness's own window where it recorded none);
* ``busy_s``: the union of the device operations' intervals, each cut to
  the traced window, so that ``busy_s <= window_s``;
* ``device_ops``: seconds of device time by operation name, cut the same
  way;
* ``idle_gaps``: the longest stretches of the traced window in which the
  device ran nothing, each named by the host operation that overlapped it
  most (``"no host op"`` where none did).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Event = Tuple[str, int, int]  # name, start_ns, duration_ns

TOP_GAPS = 10


def merged(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, non-overlapping union of ``(start, end)`` intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label(gap: Tuple[int, int], host: Sequence[Event]) -> str:
    best, best_ns = "no host op", 0
    for name, s, d in host:
        ov = min(gap[1], s + d) - max(gap[0], s)
        if ov > best_ns:
            best, best_ns = name, ov
    return best


def summarize(device: Sequence[Event], host: Sequence[Event], window_s: float) -> dict:
    if not host:
        return {"window_s": window_s, "busy_s": 0.0, "device_ops": {}, "idle_gaps": []}
    lo = min(s for _, s, _ in host)
    hi = max(s + d for _, s, d in host)
    cut = [(name, max(s, lo), min(s + d, hi)) for name, s, d in device if s < hi and s + d > lo]
    busy = merged([(s, e) for _, s, e in cut])
    ops: Dict[str, float] = {}
    for name, s, e in cut:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
    edges = [(lo, busy[0][0])] + [(a[1], b[0]) for a, b in zip(busy, busy[1:])] \
        + [(busy[-1][1], hi)] if busy else [(lo, hi)]
    gaps = sorted((g for g in edges if g[1] > g[0]), key=lambda g: g[0] - g[1])[:TOP_GAPS]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_ops": ops,
        "idle_gaps": [[_label(g, host), (g[1] - g[0]) / 1e9] for g in gaps],
    }


def split_events(events) -> Tuple[List[Event], List[Event]]:
    """Kineto's events (``prof.profiler.kineto_results.events()``) as the
    device's and the host's tuples."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        item = (e.name(), int(e.start_ns()), int(e.duration_ns()))
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    return device, host
