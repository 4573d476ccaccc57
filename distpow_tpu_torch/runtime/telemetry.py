"""Flight recorder: a bounded in-memory ring of recent annotated events,
journaled periodically and dumped whole on faults.

The port's own copy of the reference recorder (``distpow_tpu/runtime/
telemetry.py``).  ``RECORDER.record(kind, **fields)`` appends an event
(the scheduler records ``sched.slot_preempt`` and ``sched.loop_failure``,
the watchdog ``watchdog.hang``); ``configure`` enables an append-only
JSONL journal and a dump directory, and ``dump`` writes the ring with a
metrics snapshot to one JSON file.  With nothing configured (the default)
the recorder is memory-only.  ``DISTPOW_TELEMETRY_DIR`` configures both
from the environment.  ``rotate_if_over`` and ``iter_rotated_jsonl`` are
the rotation shared with the time-series spool (``obs/timeseries.py``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import List, Optional

from .metrics import REGISTRY as metrics

log = logging.getLogger("distpow.telemetry")

DEFAULT_CAPACITY = 2048
DEFAULT_JOURNAL_INTERVAL_S = 5.0
# Journal rotation: the append-only JSONL journal grows without bound
# under load — once the live file exceeds the
# byte cap it is rotated to ``<path>.1`` (older segments shift to .2,
# .3, ...) and segments beyond the keep count are deleted, so total
# disk is bounded at ~(keep + 1) x max_bytes while recent history
# stays greppable in order.
DEFAULT_JOURNAL_MAX_BYTES = 8 * 1024 * 1024
DEFAULT_JOURNAL_KEEP = 3


def rotate_if_over(path: str, max_bytes: int, keep: int) -> bool:
    """Size-capped JSONL rotation shared by every append-only spool the
    repo writes (flight-recorder journal here; the time-series spool in
    obs/timeseries.py): once the live file at ``path`` reaches
    ``max_bytes``, shift ``path.(i)`` -> ``path.(i+1)`` (dropping
    segments beyond ``keep``) and the live file to ``path.1``, bounding
    total disk at ~(keep + 1) x max_bytes.  Returns True when a
    rotation happened.  Best-effort: a failed rename costs rotation,
    never the caller's appends.  Callers serialize against their own
    appends (renames are bounded local metadata operations — the
    FileSink discipline)."""
    if max_bytes <= 0:
        return False
    try:
        if os.path.getsize(path) < max_bytes:
            return False
        keep = max(0, int(keep))
        oldest = f"{path}.{keep}"
        if keep == 0:
            os.remove(path)
            return True
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(keep - 1, 0, -1):
            seg = f"{path}.{i}"
            if os.path.exists(seg):
                os.replace(seg, f"{path}.{i + 1}")
        os.replace(path, f"{path}.1")
        return True
    except OSError as exc:
        log.warning("journal rotation failed for %s: %s", path, exc)
        return False


def iter_rotated_jsonl(path: str):
    """Yield parsed JSON objects from a rotated spool, oldest segment
    first (``path.N`` ... ``path.1``, then the live file), skipping
    lines that fail to parse (a crash mid-append leaves at most one
    torn tail line per segment)."""
    segments = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        segments.append(f"{path}.{i}")
        i += 1
    segments.reverse()
    if os.path.exists(path):
        segments.append(path)
    for seg in segments:
        try:
            with open(seg) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except ValueError:
                        continue
        except OSError as exc:
            log.warning("spool segment unreadable: %s: %s", seg, exc)


class FlightRecorder:
    """Bounded ring of annotated events with JSONL journaling and
    dump-on-fault snapshots (module docstring)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._journaled_seq = 0  # highest seq already flushed to JSONL
        self._journal_path: Optional[str] = None
        self._journal_interval = DEFAULT_JOURNAL_INTERVAL_S
        self._journal_max_bytes = DEFAULT_JOURNAL_MAX_BYTES
        self._journal_keep = DEFAULT_JOURNAL_KEEP
        self._journal_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._dump_dir: Optional[str] = None
        self._dump_n = 0  # dump-file uniqueness counter (see dump())

    # -- recording ----------------------------------------------------------
    def record(self, kind: str, /, **fields) -> None:
        """Append one annotated event.  ``kind`` is a dotted tag
        (``fault.injected``, ``watchdog.hang``, ``coord.fanout``);
        ``fields`` must be JSON-able."""
        with self._lock:
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                # ring overwrite: the oldest event is lost — count it so
                # a journal gap is attributable to capacity, not a bug
                metrics.inc("telemetry.dropped_events")
            self._events.append({
                "seq": self._seq,
                "ts": round(time.time(), 6),
                "kind": kind,
                **fields,
            })

    def recent(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if n is None else evs[-n:]

    def depth(self) -> int:
        """Current ring occupancy — the ``ring.flightrec_depth`` gauge
        the resource sentinels export (runtime/health.py)."""
        with self._lock:
            return len(self._events)

    # -- configuration ------------------------------------------------------
    def configure(self, journal_path: Optional[str] = None,
                  journal_interval_s: float = DEFAULT_JOURNAL_INTERVAL_S,
                  dump_dir: Optional[str] = None,
                  journal_max_bytes: int = DEFAULT_JOURNAL_MAX_BYTES,
                  journal_keep: int = DEFAULT_JOURNAL_KEEP) -> None:
        """Enable the periodic JSONL journal and/or the dump directory.

        The recorder — and therefore the journal — is PER PROCESS: in
        the production one-process-per-node topology that means per
        node, but an in-process multi-node harness shares one ring, so
        the journal keeps the FIRST configured path (a later node's
        re-path would silently redirect the earlier node's already-
        announced journal mid-write).  The conflict is
        logged loudly instead."""
        if journal_path:
            # create the journal's directory up front: a missing
            # TelemetryDir must not silently cost every flush (the
            # dump path makedirs too, which would otherwise mask this)
            try:
                d = os.path.dirname(journal_path)
                if d:
                    os.makedirs(d, exist_ok=True)
            except OSError as exc:
                log.error("flight-recorder journal dir unusable: %s", exc)
        with self._lock:
            if dump_dir:
                self._dump_dir = dump_dir
            if journal_path:
                if self._journal_path and self._journal_path != journal_path:
                    log.warning(
                        "flight-recorder journal already bound to %s; "
                        "ignoring re-path to %s (one journal per process "
                        "— events of all in-process nodes land in the "
                        "first-configured file)",
                        self._journal_path, journal_path,
                    )
                    journal_path = None
                else:
                    self._journal_path = journal_path
                    self._journal_interval = float(journal_interval_s)
                    self._journal_max_bytes = int(journal_max_bytes)
                    self._journal_keep = max(0, int(journal_keep))
        if journal_path and (self._journal_thread is None
                             or not self._journal_thread.is_alive()):
            self._stop.clear()
            self._journal_thread = threading.Thread(
                target=self._journal_loop, name="flight-recorder-journal",
                daemon=True,
            )
            self._journal_thread.start()

    def stop(self) -> None:
        """Stop the journal thread after one final flush (tests; node
        shutdown leaves the daemon thread to die with the process)."""
        self._stop.set()
        t = self._journal_thread
        if t is not None:
            t.join(timeout=5.0)
            self._journal_thread = None
        self.flush_journal()

    # -- journal ------------------------------------------------------------
    def _journal_loop(self) -> None:
        while not self._stop.wait(self._journal_interval):
            self.flush_journal()

    def flush_journal(self) -> None:
        """Append every not-yet-journaled ring event to the JSONL file.
        Best-effort: a full disk costs journal lines, never protocol
        progress (the TCPSink drop-don't-block discipline).  The
        journaled watermark only advances AFTER a successful write, so
        a transient failure (ENOSPC blip) retries those events on the
        next flush instead of skipping them while they still sit in the
        ring; the write happens under the ring lock —
        a bounded local append, the FileSink discipline — so racing
        explicit flushes cannot duplicate lines."""
        with self._lock:
            path = self._journal_path
            pending = [e for e in self._events
                       if e["seq"] > self._journaled_seq]
            if not path or not pending:
                return
            lines = "".join(json.dumps(e) + "\n" for e in pending)
            try:
                with open(path, "a") as fh:
                    fh.write(lines)
            except OSError as exc:
                log.warning("flight-recorder journal append failed "
                            "(will retry next flush): %s", exc)
                return
            self._journaled_seq = pending[-1]["seq"]
            self._maybe_rotate_locked(path)

    def _maybe_rotate_locked(self, path: str) -> None:
        """Size-capped rotation via the shared :func:`rotate_if_over`.
        Runs under the ring lock right after a successful append so a
        racing flush can neither double-rotate nor append to a
        mid-rotation file."""
        rotate_if_over(path, self._journal_max_bytes, self._journal_keep)

    # -- dump-on-fault ------------------------------------------------------
    def dump(self, reason: str, dump_dir: Optional[str] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write the whole ring plus a metrics snapshot to one JSON
        file; returns its path, or None when no dump directory is
        configured (memory-only mode) or the write fails.  Called by
        the watchdog's hang verdict and chaos harnesses."""
        d = dump_dir or self._dump_dir
        if not d:
            return None
        payload = {
            "reason": reason,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "events": self.recent(),
            "metrics": metrics.snapshot(),
        }
        if extra:
            payload["extra"] = extra
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)
        # uniqueness rides a per-process counter, not the wall clock:
        # two same-reason dumps in one millisecond (or a backward clock
        # step) must not truncate earlier fault evidence
        with self._lock:
            self._dump_n += 1
            n = self._dump_n
        path = os.path.join(
            d, f"flightrec-{safe}-{int(time.time() * 1000)}-{n}.json"
        )
        try:
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as fh:
                json.dump(payload, fh, indent=1)
                fh.write("\n")
        except OSError as exc:
            log.error("flight-recorder dump failed: %s", exc)
            return None
        metrics.inc("telemetry.dumps")
        log.warning("flight recorder dumped %d event(s) to %s (%s)",
                    len(payload["events"]), path, reason)
        return path

    def reset(self) -> None:
        """Testing hook: drop ring contents and journal bookkeeping
        (configuration is kept)."""
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._journaled_seq = 0


RECORDER = FlightRecorder()


def _env_configure() -> None:
    d = os.environ.get("DISTPOW_TELEMETRY_DIR")
    if not d:
        return
    RECORDER.configure(
        journal_path=os.path.join(d, f"telemetry-{os.getpid()}.jsonl"),
        dump_dir=d,
    )


_env_configure()
