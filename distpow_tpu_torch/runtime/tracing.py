"""Token-passing distributed tracing with vector clocks.

Re-implements the role the DistributedClocks/tracing library plays in the
reference (SURVEY.md section 5): every node owns a ``Tracer`` with an
identity; a request's life is one ``Trace`` created at the client
(powlib/powlib.go:104); causality crosses process boundaries by embedding
``trace.generate_token()`` in RPC payloads and calling
``tracer.receive_token(token)`` at the receiver (every reference RPC
struct carries a Token field, e.g. worker.go:58,72, coordinator.go:72,87).

Mechanics:

* Each tracer maintains a vector clock over tracer identities.  Recording
  an action and generating/receiving a token all tick the local component;
  receiving merges the sender's clock (element-wise max) before ticking —
  the standard happens-before stitch.
* Tokens are self-contained JSON: ``{trace_id, vc}``.
* Events stream to a pluggable sink: ``TCPSink`` talks to the standalone
  tracing server process (cmd/tracing-server equivalent,
  cli/tracing_server_main.py), ``FileSink`` writes directly,
  ``MemorySink`` captures for tests (the trace-parity oracle).

Thread safety: a tracer may be used from many request threads (the
reference records from RPC handler goroutines); the clock and sink are
mutex-guarded.

The port's own copy of the reference's ``runtime/tracing.py``
(``distpow_tpu/runtime/tracing.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import struct
import threading
import zlib
from typing import Dict, List, Optional

from .actions import Action

Token = bytes


class MemorySink:
    """Captures events in memory; the unit-test trace oracle."""

    def __init__(self):
        self.events: List[dict] = []
        self._lock = threading.Lock()

    def emit(self, event: dict) -> None:
        with self._lock:
            self.events.append(event)

    def close(self) -> None:
        pass

    # -- test helpers ------------------------------------------------------
    def actions(self, identity: Optional[str] = None, trace_id: Optional[int] = None):
        with self._lock:
            evs = list(self.events)
        out = []
        for e in evs:
            if e["type"] != "action":
                continue
            if identity is not None and e["identity"] != identity:
                continue
            if trace_id is not None and e["trace_id"] != trace_id:
                continue
            out.append((e["identity"], e["action"], e["body"]))
        return out


class FileSink:
    """Appends human-readable trace lines to a local file."""

    def __init__(self, path: str):
        self._f = open(path, "a", buffering=1)
        self._lock = threading.Lock()

    def emit(self, event: dict) -> None:
        with self._lock:
            self._f.write(format_trace_line(event) + "\n")

    def close(self) -> None:
        with self._lock:
            self._f.close()


class TCPSink:
    """Ships events to the tracing server over a framed-JSON TCP stream."""

    def __init__(self, addr: str, secret: bytes = b""):
        self._addr = addr
        self._secret = bytes(secret)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        host, _, port = self._addr.rpartition(":")
        sock = socket.create_connection((host or "127.0.0.1", int(port)))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = json.dumps(
            {"type": "hello", "secret": base64.b64encode(self._secret).decode()}
        ).encode()
        sock.sendall(struct.pack(">I", len(hello)) + hello)
        return sock

    def emit(self, event: dict) -> None:
        """Ship one event; a broken connection is retried once and then the
        event is dropped.  Tracing must never poison the protocol path: a
        tracing-server restart or hiccup costs trace records, not mining
        requests."""
        payload = json.dumps(event).encode()
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        # distpow: ok transitive-blocking-under-lock -- the
                        # sink lock doubles as the exclusive-redialer
                        # guard: exactly one tracer thread dials after a
                        # drop while the rest queue behind it, and the
                        # dial is bounded by the connect timeout
                        self._sock = self._connect()
                    # distpow: ok no-blocking-under-lock -- the sink lock
                    # is the per-connection frame serializer (same
                    # invariant as rpc._write_frame); only tracer threads
                    # of this process contend here, and a wedged tracing
                    # server costs trace records, never protocol progress
                    self._sock.sendall(
                        struct.pack(">I", len(payload)) + payload
                    )
                    return
                except OSError:
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    if attempt == 1:
                        return  # drop the event

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None


def format_trace_line(event: dict) -> str:
    """Human trace format: [identity] TraceID=… Action field=value, …"""
    if event["type"] == "action":
        body = ", ".join(f"{k}={v}" for k, v in event["body"].items())
        return (
            f"[{event['identity']}] TraceID={event['trace_id']} "
            f"{event['action']} {body}"
        )
    return f"[{event['identity']}] {event['type']} TraceID={event.get('trace_id')}"


class Trace:
    """One causal trace (a single request's life across nodes)."""

    def __init__(self, tracer: "Tracer", trace_id: int):
        self.tracer = tracer
        self.trace_id = trace_id

    def record_action(self, action: Action) -> None:
        self.tracer._record(self.trace_id, action)

    def record_actions(self, *actions: Action) -> None:
        """Record several actions under ONE tracer-lock critical section.

        Needed wherever an invariant spans a multi-action sequence — e.g.
        the cache replacement pair CacheRemove→CacheAdd (coordinator.go:
        436-454 emits them back-to-back from inside the cache mutex, so no
        other action of the same node can interleave).  With per-action
        locking a concurrent handler thread could slot an event between
        them and the trace checker's adjacency invariant would (correctly)
        flag the emitted order even though cache state was consistent.
        """
        self.tracer._record_many(self.trace_id, actions)

    def generate_token(self) -> Token:
        return self.tracer._generate_token(self.trace_id)


class Tracer:
    """Per-node tracing endpoint (DistributedClocks tracing.Tracer role)."""

    def __init__(self, identity: str, sink, secret: bytes = b""):
        self.identity = identity
        self.sink = sink
        self.secret = bytes(secret)
        self._vc: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._next_trace = [0]

    # -- trace lifecycle ---------------------------------------------------
    def create_trace(self) -> Trace:
        with self._lock:
            self._next_trace[0] += 1
            # trace ids are unique per (identity, counter); fold a STABLE
            # identity hash in so ids from different clients don't collide
            # yet two runs of the same scenario yield the same ids — the
            # golden-trace diff harness (tests/test_trace_parity.py)
            # depends on run-to-run determinism, which Python's built-in
            # hash() breaks via PYTHONHASHSEED randomization
            ident_tag = zlib.crc32(self.identity.encode()) & 0xFFFFFFFF
            tid = ident_tag << 32 | self._next_trace[0]
        return Trace(self, tid)

    def receive_token(self, token: Token) -> Trace:
        data = json.loads(bytes(token).decode())
        with self._lock:
            for ident, clock in data["vc"].items():
                self._vc[ident] = max(self._vc.get(ident, 0), clock)
            self._tick_locked()
            vc = dict(self._vc)
            # emit INSIDE the lock: clock tick and wire order must agree,
            # or concurrent threads ship events out of clock order and the
            # ShiViz happens-before stream is corrupt
            # distpow: ok no-blocking-under-lock -- that ordering invariant
            # REQUIRES the emit under the clock lock; the TCP sink degrades
            # to dropping events rather than blocking indefinitely
            self._emit(
                {
                    "type": "receive_token",
                    "identity": self.identity,
                    "trace_id": data["trace_id"],
                    "vc": vc,
                }
            )
        return Trace(self, data["trace_id"])

    def close(self) -> None:
        self.sink.close()

    # -- internals ---------------------------------------------------------
    def _tick_locked(self) -> None:
        self._vc[self.identity] = self._vc.get(self.identity, 0) + 1

    def _record(self, trace_id: int, action: Action) -> None:
        self._record_many(trace_id, (action,))

    def _record_many(self, trace_id: int, actions) -> None:
        with self._lock:
            for action in actions:
                self._tick_locked()
                vc = dict(self._vc)
                # distpow: ok no-blocking-under-lock -- clock tick and
                # wire order must agree (see receive_token); emitting
                # outside the lock lets concurrent recorders invert the
                # happens-before stream
                self._emit(
                    {
                        "type": "action",
                        "identity": self.identity,
                        "trace_id": trace_id,
                        "action": action.name,
                        "body": action.to_fields(),
                        "vc": vc,
                    }
                )

    def _generate_token(self, trace_id: int) -> Token:
        with self._lock:
            self._tick_locked()
            vc = dict(self._vc)
            # distpow: ok no-blocking-under-lock -- clock tick and wire
            # order must agree (see receive_token)
            self._emit(
                {
                    "type": "generate_token",
                    "identity": self.identity,
                    "trace_id": trace_id,
                    "vc": vc,
                }
            )
        return json.dumps({"trace_id": trace_id, "vc": vc}).encode()

    def _emit(self, event: dict) -> None:
        self.sink.emit(event)


def make_tracer(
    identity: str,
    server_addr: str = "",
    secret: bytes = b"",
    sink=None,
) -> Tracer:
    """Build a tracer for a node config: TCP to the tracing server when an
    address is configured, else a local memory sink (tracing effectively
    off, but the API stays live)."""
    if sink is None:
        sink = TCPSink(server_addr, secret) if server_addr else MemorySink()
    return Tracer(identity, sink, secret)


def encode_token(token: Optional[Token]) -> Optional[str]:
    """Legacy (pre-wire-v2) form: tokens as base64 strings inside JSON
    RPC payloads.  Kept because ``decode_token`` must keep accepting
    frames from peers that still send this form."""
    if token is None:
        return None
    return base64.b64encode(bytes(token)).decode()


def wire_token(token: Optional[Token]) -> Optional[bytes]:
    """Tokens ride RPC payloads as raw bytes: wire v2 ships them
    verbatim; the JSON codec renders bytes as arrays of ints
    (runtime/rpc.py ``_json_default``) — both of which
    ``decode_token`` accepts alongside the legacy base64 string."""
    return None if token is None else bytes(token)


def decode_token(s) -> Optional[Token]:
    """Accept every wire form a peer may send: ``None``, the legacy
    base64 string (pre-v2 senders), a list of ints (wire v1 from a v2
    sender), or raw bytes (wire v2)."""
    if s is None:
        return None
    if isinstance(s, str):
        return base64.b64decode(s)
    return bytes(s)
