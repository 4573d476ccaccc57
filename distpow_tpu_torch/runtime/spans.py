"""Request-forensics spans: per-trace-id timing records.

The port's own copy of the reference span layer (``distpow_tpu/runtime/
spans.py``).  A span is ``(trace_id, name, node, start_ts, dur_s,
attrs)``, recorded into one bounded process-global ring, ``SPANS``.  A
request thread binds its trace id (``SPANS.bind``); the layers below it
(the search driver's ``search.launch``, the scheduler's ``sched.slot``)
read it back through the thread-local.  ``with SPANS.span(...)`` is the
begin-site form; ``SPANS.begin`` opens a span that another thread finishes
(a scheduler slot is submitted on the caller's thread and finished on the
device loop).  ``DISTPOW_SPANS=0`` turns recording off.
``SlowRequestTrigger`` is the coordinator's slow-request capture policy.

The port adds the device timeline (``SPANS.device_timing``), off by
default and set only by ``configure(device_timing=...)``.  With it on, the
search driver times each launch on the device (``search.device_s``,
``search.past_hit_s``) and records its host enqueue (``search.enqueue``),
and the worker a Mine's ``worker.mine_start`` (``await_launch`` /
``launched``).  ``since(seq)`` reads the ring from a sequence number on, so
that a reader polling it loses no span to the ring's bound; a gap in the
sequence numbers it returns is what the ring overwrote before the reader
came.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .metrics import REGISTRY as metrics

DEFAULT_CAPACITY = 4096

#: span names that anchor a whole request (the per-trace "root"):
#: trace summaries and slowest-trace ranking prefer these durations.
ROOT_SPANS = ("coord.mine", "powlib.mine")

_tls = threading.local()


class _NullSpan:
    """Returned when recording is disabled: every operation is a no-op,
    so call sites never branch on the enabled flag themselves."""

    __slots__ = ()

    def annotate(self, **attrs) -> None:
        pass

    def finish(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = _NullSpan()


class SpanHandle:
    """One open span.  ``finish()`` records it exactly once; the
    context-manager form finishes at block exit (and tags an
    ``outcome`` on exceptions so an error path is visible in the
    timeline, not just absent)."""

    __slots__ = ("_rec", "trace_id", "name", "node", "attrs", "ts",
                 "_t0", "_done")

    def __init__(self, rec: "SpanRecorder", trace_id: int, name: str,
                 node: str, attrs: dict):
        self._rec = rec
        self.trace_id = trace_id
        self.name = name
        self.node = node
        self.attrs = attrs
        self.ts = time.time()
        self._t0 = time.monotonic()
        self._done = False

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def finish(self, **attrs) -> None:
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        self._rec._append(self.trace_id, self.name, self.node, self.ts,
                          time.monotonic() - self._t0, self.attrs)

    def __enter__(self) -> "SpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # a handle the block already finished must not be touched: its
        # attrs dict is aliased into the recorded span
        if self._done:
            return
        if exc_type is not None and "outcome" not in self.attrs:
            self.attrs["outcome"] = f"error:{exc_type.__name__}"
        self.finish()


class _Bind:
    """Context manager installing (trace_id, node) on the current
    thread; nests correctly (restores the previous binding)."""

    __slots__ = ("_tid", "_node", "_prev")

    def __init__(self, trace_id: int, node: str):
        self._tid = int(trace_id)
        self._node = node

    def __enter__(self) -> "_Bind":
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = (self._tid, self._node)
        return self

    def __exit__(self, *exc) -> None:
        _tls.ctx = self._prev


class SpanRecorder:
    """Bounded ring of finished spans (module docstring)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._enabled = os.environ.get("DISTPOW_SPANS", "1") != "0"
        self._device_timing = False

    # -- configuration ------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def device_timing(self) -> bool:
        """The device timeline's switch (``configure``)."""
        return self._device_timing

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None,
                  device_timing: Optional[bool] = None) -> None:
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
            if capacity is not None and capacity != self._spans.maxlen:
                self._spans = deque(self._spans, maxlen=int(capacity))
            if device_timing is not None:
                self._device_timing = bool(device_timing)

    # -- thread-local request binding ---------------------------------------
    @staticmethod
    def bind(trace_id: int, node: str = "") -> _Bind:
        """Bind the current thread to a request: spans recorded below
        the RPC surface (search drivers, scheduler submit) inherit the
        trace id and node without plumbing them through every call."""
        return _Bind(trace_id, node)

    @staticmethod
    def current_trace_id() -> int:
        ctx = getattr(_tls, "ctx", None)
        return ctx[0] if ctx else 0

    @staticmethod
    def current_node() -> str:
        ctx = getattr(_tls, "ctx", None)
        return ctx[1] if ctx else ""

    @staticmethod
    def await_launch(handle) -> None:
        """Leave ``handle`` open until this thread's next device launch
        (``launched``): a Mine's ``worker.mine_start``, opened at the RPC's
        receipt, ends where its search first launches."""
        _tls.until_launch = handle

    @staticmethod
    def launched() -> None:
        """Finish the span this thread left open until a launch, if any."""
        handle = getattr(_tls, "until_launch", None)
        if handle is not None:
            _tls.until_launch = None
            handle.finish()

    # -- recording ----------------------------------------------------------
    def _resolve(self, trace_id, node):
        tid = self.current_trace_id() if trace_id is None else int(trace_id)
        nd = self.current_node() if node is None else node
        return tid, nd

    def span(self, name: str, trace_id: Optional[int] = None,
             node: Optional[str] = None, **attrs):
        """The sanctioned begin-site form: ``with SPANS.span(...)``."""
        if not self._enabled:
            return _NULL
        tid, nd = self._resolve(trace_id, node)
        return SpanHandle(self, tid, name, nd, attrs)

    def begin(self, name: str, trace_id: Optional[int] = None,
              node: Optional[str] = None, **attrs):
        """Open a span that a DIFFERENT scope will ``finish()`` — for
        work crossing a thread boundary.  Every call site must have one
        finish point, because a leaked handle is a span that never
        happened."""
        if not self._enabled:
            return _NULL
        tid, nd = self._resolve(trace_id, node)
        return SpanHandle(self, tid, name, nd, attrs)

    def record(self, name: str, start_ts: float, dur_s: float,
               trace_id: Optional[int] = None, node: Optional[str] = None,
               **attrs) -> None:
        """Record a span whose timing the caller already measured
        (explicit start/duration — the coordinator's fanout stages are
        carved out of timestamps it takes anyway)."""
        if not self._enabled:
            return
        tid, nd = self._resolve(trace_id, node)
        self._append(tid, name, nd, start_ts, dur_s, attrs)

    def event(self, name: str, trace_id: Optional[int] = None,
              node: Optional[str] = None, **attrs) -> None:
        """Zero-duration marker span (a hedge, a reassignment)."""
        self.record(name, time.time(), 0.0, trace_id, node, **attrs)

    def _append(self, trace_id: int, name: str, node: str, ts: float,
                dur_s: float, attrs: dict) -> None:
        with self._lock:
            self._seq += 1
            if len(self._spans) == self._spans.maxlen:
                # ring overwrite: per-trace fetches lose the oldest
                # span — counted so a truncated timeline is attributable
                # to capacity, not a bug
                metrics.inc("spans.dropped")
            self._spans.append({
                "seq": self._seq,
                "trace_id": int(trace_id),
                "name": name,
                "node": node,
                "ts": round(ts, 6),
                "dur_s": round(float(dur_s), 6),
                "attrs": attrs,
            })

    # -- reading ------------------------------------------------------------
    def depth(self) -> int:
        """Current ring occupancy — the ``ring.spans_depth`` gauge the
        resource sentinels export (runtime/health.py)."""
        with self._lock:
            return len(self._spans)

    @property
    def total_recorded(self) -> int:
        """Monotonic count of spans ever recorded — the delta source
        for "did anything record?" checks (ring LENGTH saturates at
        capacity and reads as a zero delta forever after)."""
        with self._lock:
            return self._seq

    def recent(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._spans)
        return out if n is None else out[-n:]

    def since(self, seq: int) -> List[dict]:
        """The spans recorded after sequence number ``seq`` that the ring
        still holds, oldest first.  A reader that passes the last ``seq`` it
        was given reads every span once; where the first span returned is
        later than ``seq + 1``, the ring overwrote the ones between before
        the reader came."""
        with self._lock:
            out = list(self._spans)
            n = max(0, min(len(out), self._seq - int(seq)))
        return out[len(out) - n:]

    def spans_for(self, trace_id: int,
                  limit: Optional[int] = None) -> List[dict]:
        out = [s for s in self.recent() if s["trace_id"] == int(trace_id)]
        return out if limit is None else out[-limit:]

    def trace_summaries(self, limit: int = 50) -> List[dict]:
        """Newest-first per-trace summaries: root span (when captured),
        span count, and the trace's slowest span — the ``Spans`` RPC's
        no-trace_id reply, which is how a caller finds the trace worth
        fetching in full."""
        by_tid: Dict[int, dict] = {}
        for s in self.recent():
            tid = s["trace_id"]
            if tid == 0:
                continue
            cur = by_tid.setdefault(tid, {
                "trace_id": tid, "spans": 0, "ts": s["ts"],
                "root": None, "dur_s": 0.0, "slowest": None,
                "slowest_dur_s": 0.0,
            })
            cur["spans"] += 1
            cur["ts"] = min(cur["ts"], s["ts"])
            if s["name"] in ROOT_SPANS and s["dur_s"] >= cur["dur_s"]:
                cur["root"] = s["name"]
                cur["dur_s"] = s["dur_s"]
            if s["dur_s"] >= cur["slowest_dur_s"]:
                cur["slowest"] = s["name"]
                cur["slowest_dur_s"] = s["dur_s"]
        out = sorted(by_tid.values(), key=lambda r: -r["ts"])[:limit]
        for r in out:
            if r["root"] is None:
                # no root captured (ring overwrote it, or a partial
                # trace): rank by the slowest member instead
                r["dur_s"] = r["slowest_dur_s"]
        return out

    def slowest_traces(self, k: int = 5) -> List[dict]:
        """Top-k slowest recent traces WITH their span trees — what an
        slow-request dump attaches."""
        summaries = sorted(self.trace_summaries(limit=256),
                           key=lambda r: -r["dur_s"])[:k]
        return [dict(s, spans=self.spans_for(s["trace_id"]))
                for s in summaries]

    def reset(self) -> None:
        """Testing hook (configuration is kept)."""
        with self._lock:
            self._spans.clear()
            self._seq = 0


SPANS = SpanRecorder()


class SlowRequestTrigger:
    """Slow-request auto-capture policy (docs/FORENSICS.md).

    Two independent arms, either of which fires the capture:

    * a FIXED threshold (``threshold_s`` > 0): any request slower than
      the budget is evidence by definition;
    * a ROLLING p99 exceedance (``p99_factor`` > 0): a request slower
      than ``p99_factor x`` the p99 of the last ``window`` requests is
      a tail outlier even when the absolute budget is generous.  The
      rolling arm stays quiet until ``min_samples`` requests have been
      observed, so boot-time compiles cannot spray captures.

    ``observe`` judges the sample against the PRE-observation window —
    a slow request must not lift its own bar — then folds it in.
    Thread-safe; the coordinator calls it once per completed miss.
    """

    def __init__(self, threshold_s: float = 0.0, p99_factor: float = 0.0,
                 window: int = 256, min_samples: int = 20):
        self.threshold_s = float(threshold_s or 0.0)
        self.p99_factor = float(p99_factor or 0.0)
        self.min_samples = int(min_samples)
        self._durs: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()

    @property
    def armed(self) -> bool:
        return self.threshold_s > 0.0 or self.p99_factor > 0.0

    def observe(self, dur_s: float) -> Optional[str]:
        """Returns the trigger reason ("threshold" / "p99") when the
        sample should be captured, else None."""
        dur_s = float(dur_s)
        reason = None
        with self._lock:
            if self.threshold_s > 0.0 and dur_s > self.threshold_s:
                reason = "threshold"
            elif self.p99_factor > 0.0 and \
                    len(self._durs) >= self.min_samples:
                ordered = sorted(self._durs)
                p99 = ordered[min(len(ordered) - 1,
                                  int(0.99 * (len(ordered) - 1)))]
                if dur_s > self.p99_factor * p99:
                    reason = "p99"
            self._durs.append(dur_s)
        return reason
