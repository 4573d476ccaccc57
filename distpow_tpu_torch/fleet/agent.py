"""Worker-side fleet agent: calibrate, register, heartbeat, drain.

Lifecycle (docs/FLEET.md "Joining and leaving"):

1. **Calibrate** — a short budgeted search measures the backend's MH/s
   (capability.py ``calibrate_mhs``; best-effort, 0.0 = unknown).
2. **Register** — ``Fleet.Register`` with the worker's reachable RPC
   address and capability; the reply's lease id + TTL + heartbeat hint
   arm the heartbeat loop.  Registration retries with backoff on its
   own daemon thread, so a worker booted before its coordinator still
   joins once the coordinator is up.
3. **Heartbeat** — one persistent loop thread renews the lease every
   interval; the observed round trip feeds ``fleet.heartbeat_rtt_s``.
   An "unknown lease" error means the lease was lost (SIGSTOP past the
   TTL, coordinator restart, partition) — the agent RE-REGISTERS with
   the same worker id and carries on with the fresh lease; transport
   failures re-dial with backoff.
4. **Drain** — ``stop(drain=True)`` (the worker's shutdown path) issues
   a bounded ``Fleet.Drain`` so in-flight shards finish before the
   lease is released; only then does shutdown proceed.  A dead
   coordinator cannot block shutdown: the drain call is bounded and
   best-effort.

The agent is a pure client of the RPC layer — heartbeats ride
wire v2 when the coordinator speaks it, and the fault plane can
refuse/delay/drop them like any other frame (chaos tests).

The port's own copy of the reference's ``fleet/agent.py``
(``distpow_tpu/fleet/agent.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from ..runtime.metrics import REGISTRY as metrics
from ..runtime.rpc import RPCClient, RPCError, RPCTransportError
from ..runtime.telemetry import RECORDER
from .capability import Capability

log = logging.getLogger("distpow.fleet")


class FleetAgent:
    """One worker's membership client (module docstring)."""

    #: registration retry backoff bounds (jitter-free: one worker, one
    #: coordinator — the powlib thundering-herd concern does not apply)
    REGISTER_BACKOFF_S = 0.2
    REGISTER_BACKOFF_MAX_S = 5.0

    def __init__(self, worker_id: str, coord_addr: str, listen_addr: str,
                 capability: Capability, heartbeat_s: float = 0.0,
                 drain_timeout_s: float = 20.0) -> None:
        self.worker_id = worker_id
        self.coord_addr = coord_addr
        self.listen_addr = listen_addr
        self.capability = capability
        #: 0 = use the coordinator's hint from the Register reply
        self._heartbeat_s = float(heartbeat_s)
        self._drain_timeout_s = float(drain_timeout_s)
        self._client: Optional[RPCClient] = None
        self._lease_id: Optional[str] = None
        self._interval = 1.0
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registered = threading.Event()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Arm the register+heartbeat loop (one persistent daemon
        thread; never spawned per beat)."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"fleet-agent-{self.worker_id}",
        )
        self._thread.start()

    def wait_registered(self, timeout: float = 10.0) -> bool:
        """Block until the first successful registration (tests, smoke
        scripts); True on success within ``timeout``."""
        return self._registered.wait(timeout)

    def pause(self) -> None:
        """Suspend heartbeats WITHOUT releasing the lease — the
        in-process stand-in for a frozen worker (bench --membership's
        straggler; the real-SIGSTOP variant lives in the subprocess
        tests)."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def stop(self, drain: bool = True) -> dict:
        """Stop the loop; optionally drain first (bounded).  Returns
        the drain reply (or a marker dict when no drain happened)."""
        self._stop.set()
        out: dict = {"drained": False, "skipped": True}
        client, lease = self._client, self._lease_id
        if drain and client is not None and lease is not None:
            try:
                out = client.call(
                    "Fleet.Drain",
                    {"lease_id": lease, "timeout_s": self._drain_timeout_s},
                    timeout=self._drain_timeout_s + 5.0,
                )
                out["skipped"] = False
                RECORDER.record("fleet.drained", worker_id=self.worker_id,
                                drained=bool(out.get("drained")))
            except Exception as exc:  # best-effort by contract
                log.info("%s: drain failed (%s); leaving by lease expiry",
                         self.worker_id, exc)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._client is not None:
            try:
                self._client.close()
            except OSError:
                pass
            self._client = None
        return out

    # -- the loop -----------------------------------------------------------
    def _dial(self) -> RPCClient:
        if self._client is None or self._client.dead:
            if self._client is not None:
                try:
                    self._client.close()
                except OSError:
                    pass
            self._client = RPCClient(self.coord_addr, timeout=5.0)
        return self._client

    def _register_once(self) -> None:
        client = self._dial()
        reply = client.call("Fleet.Register", {
            "worker_id": self.worker_id,
            "addr": self.listen_addr,
            "capability": self.capability.to_wire(),
        }, timeout=10.0)
        self._lease_id = str(reply["lease_id"])
        hint = float(reply.get("heartbeat_s") or 1.0)
        self._interval = self._heartbeat_s if self._heartbeat_s > 0 else hint
        self._registered.set()
        log.info("%s: joined fleet (lease %s, ttl %.1fs, beating every "
                 "%.2fs)", self.worker_id, self._lease_id,
                 float(reply.get("ttl_s") or 0.0), self._interval)

    def _run(self) -> None:
        backoff = self.REGISTER_BACKOFF_S
        while not self._stop.is_set():
            try:
                if self._lease_id is None:
                    self._register_once()
                    backoff = self.REGISTER_BACKOFF_S
                    # registration itself proved liveness: wait a full
                    # interval before the first heartbeat, so the
                    # registry's cadence EMA never sees a near-zero
                    # register->beat gap (a tiny first sample would
                    # drag the fleet's median — and with it the hedge
                    # threshold — low enough to flag HEALTHY members
                    # as stale between ordinary beats)
                    if self._stop.wait(self._interval):
                        return
                    continue
                if self._paused.is_set():
                    if self._stop.wait(0.05):
                        return
                    continue
                t0 = time.monotonic()
                client = self._dial()
                client.call("Fleet.Heartbeat",
                            {"lease_id": self._lease_id},
                            timeout=min(10.0, self._interval * 4 + 1.0))
                metrics.observe("fleet.heartbeat_rtt_s",
                                time.monotonic() - t0)
                backoff = self.REGISTER_BACKOFF_S  # healthy again
                if self._stop.wait(self._interval):
                    return
            except (RPCTransportError, OSError) as exc:
                # coordinator away: keep the lease id (it may still be
                # valid when the coordinator returns) and re-dial.
                # OSError belongs HERE, not below — a refused re-dial
                # raises it raw from the RPCClient constructor, and
                # misreading that as a lost lease would re-register and
                # retire a perfectly valid lease mid-round (register's twin-retirement closes
                # the coordinator's healthy connection to this worker).
                log.info("%s: heartbeat transport failure (%s); retrying "
                         "in %.1fs", self.worker_id, exc, backoff)
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, self.REGISTER_BACKOFF_MAX_S)
            except RPCError as exc:
                # handler-level rejection — almost always "unknown
                # lease": the lease was lost while we were gone
                # (SIGSTOP past the TTL).  Re-register FRESH: the
                # registry retires any stale twin under our worker id,
                # so recovery cannot double-own first-byte space.
                log.info("%s: lease lost (%s); re-registering",
                         self.worker_id, exc)
                RECORDER.record("fleet.lease_lost",
                                worker_id=self.worker_id, error=str(exc))
                self._lease_id = None
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, self.REGISTER_BACKOFF_MAX_S)
