"""In-flight request coalescing — one fan-out round, many waiters.

The coordinator's documented fix for concurrent identical ``Mine``
requests was a per-key mutex: the duplicate BLOCKS until the first
request's whole round completes, then re-checks the cache
(nodes/coordinator.py module docstring).  Correct, but serialized — K
identical requests pay K sequential lock acquisitions and K cache
round-trips, and the (K-1) waiters occupy dispatch threads doing
nothing useful.

Coalescing upgrades that: the FIRST request for a key becomes the
round's *leader* and runs the miss protocol exactly as before; every
concurrent duplicate becomes a *waiter* that parks on the round's
completion event and then replies straight from the dominance cache the
leader's round just filled.  One fan-out, N replies, and each waiter's
trace keeps today's duplicate shape (CoordinatorMine -> CacheMiss ->
CacheHit -> CoordinatorSuccess) — the trace oracle cannot tell the
difference, which is the point: coalescing is a scheduling change, not
a protocol change.

Leader failures propagate: the leader parks its exception on the round
before releasing the waiters, so a rejected (AdmissionReject) or failed
round rejects/fails every coalesced request with the same typed error
instead of stranding the waiters.

The port's own copy of the reference's ``sched/coalesce.py``
(``distpow_tpu/sched/coalesce.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple


class _Round:
    __slots__ = ("ev", "error", "waiters")

    def __init__(self) -> None:
        self.ev = threading.Event()
        self.error: Optional[BaseException] = None
        self.waiters = 0


class Handle:
    """One request's membership in a coalesced round.

    ``leader`` is fixed at join time.  The leader MUST call
    :meth:`finish` on every exit path (success or error) — waiters
    block on it; :meth:`wait`/:meth:`error` are the waiter side.
    """

    __slots__ = ("_coalescer", "_key", "_round", "leader")

    def __init__(self, coalescer: "Coalescer", key: tuple, round_: _Round,
                 leader: bool) -> None:
        self._coalescer = coalescer
        self._key = key
        self._round = round_
        self.leader = leader

    def finish(self, error: Optional[BaseException] = None) -> None:
        self._coalescer._finish(self._key, self._round, error)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._round.ev.wait(timeout)

    def error(self) -> Optional[BaseException]:
        return self._round.error


class Coalescer:
    """Key -> in-flight round registry with leader election by arrival
    order (first joiner leads; deterministic under the dispatch lock)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rounds: Dict[Tuple, _Round] = {}

    def join(self, key: tuple) -> Handle:
        with self._lock:
            r = self._rounds.get(key)
            if r is None:
                r = self._rounds[key] = _Round()
                return Handle(self, key, r, leader=True)
            r.waiters += 1
            return Handle(self, key, r, leader=False)

    def _finish(self, key: tuple, round_: _Round,
                error: Optional[BaseException]) -> None:
        with self._lock:
            if self._rounds.get(key) is round_:
                del self._rounds[key]
            round_.error = error
        round_.ev.set()

    def inflight(self) -> int:
        with self._lock:
            return len(self._rounds)
