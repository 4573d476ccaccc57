"""What the per-layer metrics read: one measured window of a run.

Each ``metrics/<name>.py`` has ``read(window) -> float | None`` and reads
only this: the window's length, its verified solves (each with its
difficulty, its latency and the candidates the winning worker tried up to
its secret, ``reference.candidates``), the ``Stats``
snapshots of every node at the window's open and close, the workers'
profile summaries (``profile.py``; none without ``--trace 1`` or without
a card), the configuration, and the card's peak (``peaks.json``).  A
reader that finds nothing to read returns ``None`` and its metric is left
out of the result.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Snapshot = dict  # a node's Stats reply: counters, gauges, histograms


def exact_percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over raw samples (copied from the port's
    ``load/harness.py`` ``exact_percentile``)."""
    if not samples:
        return None
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
    return s[idx]


def hist_delta(pair: Tuple[Snapshot, Snapshot], name: str) -> Tuple[int, float]:
    """The window's ``(count, sum)`` of a histogram: after less before."""
    before, after = (p["histograms"].get(name, {"count": 0, "sum": 0.0}) for p in pair)
    return after["count"] - before["count"], after["sum"] - before["sum"]


@dataclass
class Window:
    seconds: float
    config: dict
    solves: List[Tuple[int, float, int]]  # (ntz, latency s, candidates) of each verified solve
    coordinator: Tuple[Snapshot, Snapshot]
    workers: List[Tuple[Snapshot, Snapshot]]
    profiles: List[dict] = field(default_factory=list)
    peak: Optional[dict] = None

    def workers_hist(self, name: str) -> Tuple[int, float]:
        """A histogram's window ``(count, sum)`` over every worker."""
        count, total = 0, 0.0
        for pair in self.workers:
            c, s = hist_delta(pair, name)
            count, total = count + c, total + s
        return count, total
