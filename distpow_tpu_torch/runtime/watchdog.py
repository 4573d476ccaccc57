"""Device-hang watchdog: turn a wedged device into a clean process death.

The port's own copy of the reference watchdog (``distpow_tpu/runtime/
watchdog.py``).  Code that drives the device wraps itself in
``WATCHDOG.active()`` and calls ``WATCHDOG.beat()`` at each host-side sync
point: between launches in the search driver, before each blocking fetch,
and in the scheduler's loop.  A daemon monitor fires when an active
section goes ``timeout`` seconds without a beat; Python cannot cancel the
hung call, so the default action is ``os._exit(EXIT_CODE)``.  A launch that
may build the CUDA kernels (nvcc, one uninterruptible host call) runs
inside ``WATCHDOG.grace(FIRST_COMPILE_GRACE_S)``.  Beats cost two
attribute reads and are no-ops while the watchdog is not started, which is
the default.
"""

from __future__ import annotations

import logging
import os
import threading
from contextlib import contextmanager
from time import monotonic
from typing import Callable, Optional

log = logging.getLogger("distpow.watchdog")

# Distinctive exit code so supervisors / tests can tell a watchdog death
# from a crash.  (Avoids the 128+signal range and small shell codes.)
EXIT_CODE = 43

# Grace window for ONE launch that may build the kernels (see
# ``DeviceWatchdog.grace``): the reference's value, sized for its largest
# compile; an nvcc build of every kernel source takes minutes at most.  A
# device that hangs during such a launch is still detected, just after
# this window.
FIRST_COMPILE_GRACE_S = 1800.0


class DeviceWatchdog:
    """Monitor for device-driving sections that stop making progress.

    One instance (the module-level ``WATCHDOG``) is shared process-wide:
    a worker owns one device, so if any dispatch hangs, every search on
    the device is stuck — a single staleness clock is the right model.
    The corollary (documented limitation): beats from a *live* search
    can mask a hung one in the same process; detection then happens as
    soon as the live search drains.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._active = 0
        self._last_beat = 0.0
        self._timeout = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._on_hang: Optional[Callable[[float], None]] = None
        self._arm_lock = threading.Lock()  # serializes acquire/release
        self._refs = 0  # acquire/release co-owners
        self._graces: list[float] = []  # active grace windows (multiset)
        self.fired = threading.Event()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self, timeout_s: float,
              on_hang: Optional[Callable[[float], None]] = None) -> None:
        """Start the monitor.  ``on_hang(stale_seconds)`` overrides the
        default die-by-``os._exit(EXIT_CODE)`` action (tests use this)."""
        if timeout_s <= 0:
            raise ValueError("watchdog timeout must be positive")
        with self._lock:
            if self.running:
                raise RuntimeError("watchdog already running")
            self._timeout = float(timeout_s)
            self._on_hang = on_hang
            self._last_beat = monotonic()
            self._stop.clear()
            self.fired.clear()
            self._thread = threading.Thread(
                target=self._monitor, name="device-watchdog", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        with self._lock:
            self._thread = None
            # _active is deliberately NOT reset: sections still inside
            # active() will run their paired decrements when they
            # unwind; zeroing here would drive the counter negative and
            # permanently blind a re-armed watchdog

    def acquire(self, timeout_s: float) -> None:
        """Refcounted arming for co-owners (one per in-process worker):
        the first acquire starts the monitor, later ones share it (the
        first timeout wins — one device, one staleness clock), and the
        matching ``release`` of the last owner stops it."""
        with self._arm_lock:
            self._refs += 1
            if not self.running:
                self.start(timeout_s)
                log.info("device-hang watchdog armed (timeout %gs)",
                         timeout_s)
            elif self._timeout != timeout_s:
                log.warning(
                    "device-hang watchdog already armed at %gs; ignoring "
                    "requested timeout %gs (one clock per process)",
                    self._timeout, timeout_s,
                )

    def release(self) -> None:
        with self._arm_lock:
            self._refs = max(0, self._refs - 1)
            if self._refs == 0:
                self.stop()

    def beat(self) -> None:
        if self._thread is None:
            return
        # distpow: ok unguarded-shared-write -- lock-free by documented
        # design (class docstring): beat() sits on the per-launch hot
        # path, the store of a monotonic float is atomic under the GIL,
        # and the staleness window tolerates one torn/lost beat
        self._last_beat = monotonic()

    @contextmanager
    def active(self):
        """Mark the enclosing block as device-driving.  Nestable and
        concurrency-safe (a counter, not a flag).

        Counts unconditionally — NOT only while the monitor runs — so a
        section already in flight when a later ``start()``/``acquire()``
        arms the watchdog is covered for the rest of its duration.
        ``start()`` re-seeds ``_last_beat``, so arming over
        an already-hung section fires one full timeout later; beats stay
        no-ops while stopped, and the per-section lock cost is paid once
        per search, not per beat."""
        with self._lock:
            self._active += 1
            self._last_beat = monotonic()
        try:
            yield
        finally:
            with self._lock:
                self._active -= 1

    @contextmanager
    def grace(self, seconds: float):
        """Widen the no-progress window for ONE known-long operation.

        A kernel build cannot beat: it is one uninterruptible host call.
        Inside a ``grace(s)`` block the effective timeout is
        ``max(timeout, s)``; a genuinely hung device is still detected,
        just ``s`` seconds later, and only for the annotated operation.
        Nestable and thread-safe: active windows form a multiset and
        the widest CURRENTLY-active one wins, so an inner ``grace(900)``
        stops widening the window the moment it exits.  Exit re-seeds the beat clock so the normal
        window restarts cleanly.
        """
        s = float(seconds)
        with self._lock:
            self._graces.append(s)
            self._last_beat = monotonic()
        try:
            yield
        finally:
            with self._lock:
                self._graces.remove(s)
                self._last_beat = monotonic()

    def _monitor(self) -> None:
        poll = min(1.0, self._timeout / 4)
        while not self._stop.wait(poll):
            if self._active <= 0:
                # idle: nothing is driving the device; keep the clock
                # fresh so the first beat of the next section starts a
                # clean window
                # distpow: ok unguarded-shared-write -- monitor-thread
                # refresh of the same GIL-atomic monotonic store as
                # beat(); racing a concurrent beat() only makes the
                # clock fresher, never staler
                self._last_beat = monotonic()
                continue
            # snapshot beat + grace state atomically: reading the beat
            # first and the grace list second races a grace() exit in
            # between (stale computed against the wide window's old
            # beat, limit against the restored narrow one -> false
            # fire on a healthy device)
            with self._lock:
                stale = monotonic() - self._last_beat
                limit = self._timeout
                if self._graces:
                    limit = max(limit, max(self._graces))
            if stale > limit:
                log.critical(
                    "device watchdog: %d active device section(s) made no "
                    "progress for %.1fs (timeout %.1fs) — the accelerator "
                    "dispatch is presumed hung; exiting so the coordinator "
                    "can reassign this worker's shards",
                    self._active, stale, limit,
                )
                # dump-on-fault: capture the flight-recorder ring and a
                # metrics snapshot BEFORE any exit path — the hang
                # narrative must not depend on someone tailing a log
                # (runtime/telemetry.py; no-op when no dump dir is
                # configured).  Local import: telemetry is imported for
                # the fault path only, so the beat hot path and the
                # stdlib-only importers of this module pay nothing.
                from .telemetry import RECORDER

                RECORDER.record("watchdog.hang", stale_s=round(stale, 3),
                                limit_s=limit, active=self._active)
                RECORDER.dump("device-hang")
                if self._on_hang is not None:
                    # callback first, THEN the observable event: waiters
                    # on ``fired`` may assert on the callback's effects
                    self._on_hang(stale)
                    self.fired.set()
                    return
                self.fired.set()
                # Flush logs before the hard exit (os._exit skips
                # atexit/finally by design: the process state is wedged).
                logging.shutdown()
                os._exit(EXIT_CODE)


WATCHDOG = DeviceWatchdog()
