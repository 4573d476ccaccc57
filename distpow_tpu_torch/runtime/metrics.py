"""A small thread-safe counter/observe registry for the search driver.

Holds only what the driver writes: the counters ``search.launches``,
``search.hashes``, ``search.found``, ``search.cancelled``,
``search.blocking_syncs`` and the ``search.launch_s`` observations
(count, sum, min, max).  Callers create a ``Metrics`` and pass it, or
use the process-wide ``REGISTRY`` the backends default to.
"""

from __future__ import annotations

import threading
from typing import Dict, Union

Number = Union[int, float]


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Number] = {}
        self._obs: Dict[str, Dict[str, Number]] = {}

    def inc(self, name: str, n: Number = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def observe(self, name: str, value: Number) -> None:
        with self._lock:
            o = self._obs.get(name)
            if o is None:
                self._obs[name] = {"count": 1, "sum": value, "min": value, "max": value}
            else:
                o["count"] += 1
                o["sum"] += value
                o["min"] = min(o["min"], value)
                o["max"] = max(o["max"], value)

    def get(self, name: str) -> Number:
        with self._lock:
            return self._counters.get(name, 0)

    def get_observed(self, name: str) -> Dict[str, Number]:
        with self._lock:
            return dict(self._obs.get(name, {"count": 0, "sum": 0}))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._obs.clear()


REGISTRY = Metrics()
