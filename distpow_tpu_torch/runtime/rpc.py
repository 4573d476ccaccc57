"""Framed-JSON TCP RPC — the framework's DCN-level communication backend.

Plays the role Go ``net/rpc`` plays in the reference (SURVEY.md section 2
component 11): blocking unary calls (rpc.Client.Call,
coordinator.go:195,226), async calls returning a completion handle
(rpc.Client.Go, powlib/powlib.go:156, cmd/worker/main.go:35), one server
servicing multiple listeners (the coordinator's segregated client/worker
listeners, coordinator.go:334-351), and concurrent dispatch of requests.

Wire framing: 4-byte big-endian length prefix + payload.  Two payload
codecs exist (docs/RPC.md):

* **v1 (JSON)** — UTF-8 JSON, the format every version of this repo has
  spoken.  Request ``{"id": n, "method": "Service.Method", "params":
  {...}}``; response ``{"id": n, "result": ..., "error": null | str}``.
  Byte fields travel as arrays of ints (the natural JSON form of the
  reference's ``[]uint8``) and tracing tokens as base64 strings —
  senders pass ``bytes`` and the codec renders both legacy forms
  (``_json_default`` / ``_jsonify_tokens``), keeping JSON-mode frames
  byte-identical to pre-v2 versions of this repo.
* **v2 (binary)** — the struct-packed codec in runtime/wire.py: raw
  ``bytes`` for nonce/secret/token, interned method and key ids, a
  dedicated ``retry_after`` header field.  Negotiated PER CONNECTION at
  dial time: the client sends a plain-JSON ``rpc.hello`` request; a
  v2-capable server acks it and both sides switch, while any other
  server answers it like any unknown method — an error frame — and the
  client transparently stays on JSON.  Mixed-version clusters therefore
  interoperate with no configuration; ``DISTPOW_RPC_CODEC=json`` pins
  the process to v1 for A/B measurement (bench.py --control-plane).

The fault-injection plane (runtime/faults.py) mutates the *encoded
frame* — delay/drop/duplicate/truncate behave identically on both
codecs — and the ``rpc.frame.{sent,recv}_bytes`` histograms measure the
payload shrink directly.  Within a TPU pod the hot path never touches
this transport — device fan-out rides ICI collectives
(parallel/mesh_search.py); this backend carries only control-plane
traffic between hosts, as the north-star design prescribes
(BASELINE.json: "the coordinator/worker RPC boundary stays intact").

The port's own copy of the reference's ``runtime/rpc.py``
(``distpow_tpu/runtime/rpc.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import struct
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

from . import faults, wire
from .metrics import REGISTRY as metrics


class RPCError(Exception):
    pass


class RPCTransportError(RPCError):
    """A connection-level failure — refused dial, failed/partial send,
    reader death — as opposed to an error *returned by* the remote
    handler (which stays a plain :class:`RPCError`).  The distinction is
    what makes client-side retry safe: a transport failure means the
    peer may never have seen (or finished) the call, so re-issuing an
    idempotent RPC (``Mine`` — the dominance cache absorbs repeats) is
    correct, while a handler error would just be re-earned."""


class RPCRetryAfter(RPCError):
    """The remote handler REJECTED the call with server-paced
    backpressure (the scheduler's admission control,
    sched/admission.py): the ``retry_after`` field of the response
    frame says when to try again.  A third retry class beside the two
    above: unlike a handler error it IS worth re-issuing — the server
    itself asked for the retry — and unlike a transport failure the
    retry is paced by the server's hint and must not burn the client's
    transport-failure budget (nodes/powlib.py)."""

    def __init__(self, message: str, delay_s: float):
        super().__init__(message)
        self.delay_s = float(delay_s)


class RPCNotOwner(RPCError):
    """The remote coordinator REJECTED the call because the cluster
    ring maps the key to a different shard (the scale-out plane's
    typed redirect — distpow_tpu/cluster/, docs/CLUSTER.md).  The
    ``ring`` attribute is the coordinator's fresh ring snapshot
    (``HashRing.to_wire`` dict), carried in the response frame's
    dedicated ``ring`` field: the client adopts it and re-routes in one
    round trip, with no separate discovery call.  A fourth retry class:
    like RETRY_AFTER it is worth re-issuing (elsewhere) and must not
    burn the transport retry budget — the connection is healthy and the
    server did exactly its job."""

    def __init__(self, message: str, ring: dict):
        super().__init__(message)
        self.ring = dict(ring or {})


#: pseudo-method of the per-connection codec negotiation exchange.  The
#: hello rides an ordinary v1 frame so a JSON-only peer handles it as a
#: normal (unknown-method) request; it is NOT passed through the fault
#: plane's per-frame hooks — dial-time faults already model the
#: negotiation window via the ``@connect`` pseudo-method.
HELLO_METHOD = "rpc.hello"
HELLO_TIMEOUT_S = 5.0

#: process defaults, overridable per client/server: "auto" negotiates
#: v2 with transparent JSON fallback; "json" pins v1; "binary" requires
#: v2 and fails the dial when the peer can't speak it.
CLIENT_CODEC_DEFAULT = os.environ.get("DISTPOW_RPC_CODEC") or "auto"
SERVER_NEGOTIATE_DEFAULT = os.environ.get("DISTPOW_RPC_CODEC") != "json"


def _json_default(o):
    """``bytes`` params render as arrays of ints on the JSON wire — the
    exact frames pre-v2 versions of this repo sent, so a v2 process
    pinned (or negotiated down) to JSON stays wire-identical."""
    if isinstance(o, (bytes, bytearray, memoryview)):
        return list(bytes(o))
    raise TypeError(f"{type(o).__name__} is not JSON-encodable")


def _jsonify_tokens(obj: dict) -> dict:
    """Tracing tokens travel as base64 strings on the JSON wire — the
    exact pre-v2 form, which a genuinely old peer's ``decode_token``
    (base64-only) can parse.  Every OTHER byte field was an int array
    before v2 and stays one via ``_json_default``; the token is the one
    field whose legacy form differed, so it alone needs this rewrite
    (rendered as an int array, it would break mixed-version clusters)."""
    for key in ("params", "result"):
        inner = obj.get(key)
        if isinstance(inner, dict) and \
                isinstance(inner.get("token"), (bytes, bytearray, memoryview)):
            obj = dict(obj)
            obj[key] = dict(inner, token=base64.b64encode(
                bytes(inner["token"])).decode())
    return obj


class _JsonCodec:
    """Wire v1: UTF-8 JSON payloads."""

    name = "json"
    version = 1

    @staticmethod
    def encode(obj: dict) -> bytes:
        return json.dumps(_jsonify_tokens(obj), default=_json_default).encode()

    @staticmethod
    def decode(data: bytes):
        return json.loads(data.decode())


class _BinaryCodec:
    """Wire v2: the struct-packed codec (runtime/wire.py)."""

    name = "binary"
    version = wire.WIRE_VERSION

    @staticmethod
    def encode(obj: dict) -> bytes:
        return wire.encode_frame(obj)

    @staticmethod
    def decode(data: bytes) -> dict:
        return wire.decode_frame(data)


JSON_CODEC = _JsonCodec()
BINARY_CODEC = _BinaryCodec()


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("connection closed")
        buf += part
    return buf


def _read_frame(sock: socket.socket, codec=JSON_CODEC) -> dict:
    (length,) = struct.unpack(">I", _read_exact(sock, 4))
    if length > 64 * 1024 * 1024:
        raise RPCError(f"oversized frame: {length} bytes")
    metrics.observe("rpc.frame.recv_bytes", length)
    return codec.decode(_read_exact(sock, length))


def _write_frame(sock: socket.socket, obj: dict, lock: threading.Lock,
                 codec=JSON_CODEC) -> None:
    payload = codec.encode(obj)
    metrics.observe("rpc.frame.sent_bytes", len(payload))
    with lock:
        # distpow: ok no-blocking-under-lock -- this lock IS the frame
        # serializer: interleaved sendall from two threads would corrupt
        # the length-prefixed stream; the send is bounded by SO_SNDTIMEO
        sock.sendall(struct.pack(">I", len(payload)) + payload)


def _write_truncated(sock: socket.socket, obj: dict,
                     lock: threading.Lock, codec=JSON_CODEC) -> None:
    """Fault-plane helper (faults.py kind="truncate"): write a partial
    frame — length prefix plus roughly half the payload — so the peer's
    ``_read_exact`` sees a mid-frame connection reset when the caller
    tears the socket down right after.  Codec-agnostic: the tear is at
    the byte level, exactly like a real mid-frame reset."""
    payload = codec.encode(obj)
    frame = struct.pack(">I", len(payload)) + payload
    try:
        with lock:
            # distpow: ok no-blocking-under-lock -- same frame-serializer
            # lock as _write_frame; the deliberately-torn fault frame must
            # not interleave with a concurrent healthy write either
            sock.sendall(frame[: max(5, len(frame) // 2)])
    except OSError:
        pass


def split_addr(addr: str) -> Tuple[str, int]:
    """Connect-side parse: a host-less ':port' targets the local host."""
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def split_bind_addr(addr: str) -> Tuple[str, int]:
    """Listen-side parse: a host-less ':port' binds all interfaces, like
    Go's net.Listen — reference configs use bare ':port' addresses
    (config/coordinator_config.json) and must stay multi-host capable."""
    host, _, port = addr.rpartition(":")
    return host, int(port)


class StatsOnly:
    """Observability-only view of a node handler, for registration
    under the role-agnostic ``Node`` service name (nodes/coordinator.py,
    nodes/worker.py): callers resolve any node's Stats — and, since the
    forensics plane (docs/FORENSICS.md), its span ring via ``Spans`` —
    without knowing or mis-probing its role, so auto-role discovery
    never mints ``rpc.handler_errors`` on the node being observed
    (distpow_tpu/obs/scrape.py, docs/SLO.md).  The protocol surface
    stays single-named; this view never exposes protocol methods."""

    def __init__(self, handler):
        self._handler = handler

    def Stats(self, params) -> dict:
        return self._handler.Stats(params)

    def Spans(self, params) -> dict:
        """Span-ring export (runtime/spans.py, docs/FORENSICS.md).

        ``{"trace_id": N}`` returns every retained span of that trace;
        without a trace_id the reply carries per-trace SUMMARIES of the
        recent ring (how a forensics caller finds the trace worth
        fetching in full).  ``limit`` bounds either list.  The ring is
        process-global, so an in-process multi-node harness answers
        with the union — each span's ``node`` field keeps attribution
        honest (the stitcher dedups by (node, seq))."""
        from .spans import SPANS

        limit = int(params.get("limit") or 512)
        tracer = getattr(self._handler, "tracer", None)
        out = {"node": getattr(tracer, "identity", "")}
        tid = params.get("trace_id")
        if tid is None:
            out["traces"] = SPANS.trace_summaries(limit=limit)
        else:
            out["spans"] = SPANS.spans_for(int(tid), limit=limit)
        return out


class RPCServer:
    """Multi-listener RPC server dispatching ``Service.Method`` requests.

    Each connection gets a reader thread; each request is dispatched on its
    own worker thread so slow handlers (the coordinator's blocking ``Mine``)
    never head-of-line-block other requests on the same connection —
    matching Go net/rpc's goroutine-per-request semantics.

    ``negotiate`` (default: module ``SERVER_NEGOTIATE_DEFAULT``) governs
    wire-v2 negotiation: when False the server is JSON-only and an
    incoming ``rpc.hello`` falls through to normal dispatch — the
    unknown-service error a pre-v2 server would return, which is
    exactly the reply that makes v2 clients fall back transparently.
    """

    def __init__(self, negotiate: Optional[bool] = None):
        self._negotiate = (SERVER_NEGOTIATE_DEFAULT
                           if negotiate is None else bool(negotiate))
        #: optional callable returning extra keys merged into the
        #: ``rpc.hello`` ack result beside ``codec`` (the cluster
        #: plane's ring advertisement — docs/CLUSTER.md).  The ack is
        #: always plain JSON, so the payload must be JSON-encodable;
        #: pre-cluster clients ignore keys they don't know.
        self.hello_extra = None
        self._services: Dict[str, object] = {}
        self._listeners = []
        self._threads = []
        self._conns = set()
        self._lock = threading.Lock()
        self._shutdown = threading.Event()

    def register(self, name: str, handler: object) -> None:
        self._services[name] = handler

    def listen(self, addr: str) -> str:
        """Bind a listener; returns the bound address (resolves ':0')."""
        host, port = split_bind_addr(addr)
        ls = socket.create_server((host, port), reuse_port=False)
        self._listeners.append(ls)
        bound = ls.getsockname()
        return f"{host or '127.0.0.1'}:{bound[1]}"

    def serve_in_background(self) -> None:
        for ls in self._listeners:
            # distpow: ok unbounded-thread-spawn -- bounded: one
            # acceptor per listener, and listeners are a small fixed
            # set wired at boot (the coordinator's two)
            t = threading.Thread(target=self._accept_loop, args=(ls,), daemon=True)
            t.start()
            self._threads.append(t)

    def _accept_loop(self, ls: socket.socket) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = ls.accept()
            except OSError:
                return
            if self._shutdown.is_set():
                # the wake-up connection from shutdown(), or a late dial
                try:
                    conn.close()
                except OSError:
                    pass
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            # distpow: ok unbounded-thread-spawn -- deliberate
            # thread-per-connection: Go net/rpc parity (the reference's
            # accept loop spawns a goroutine per conn), and the peer set
            # is the cluster's node count, not open traffic
            threading.Thread(
                target=self._conn_loop, args=(conn,), daemon=True
            ).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        # per-connection codec, shared with this connection's dispatch
        # threads via a one-slot holder; flipped only by the hello
        # exchange below, which the client sends before any other frame
        codec: List[object] = [JSON_CODEC]
        try:
            peer = "%s:%s" % conn.getpeername()[:2]
        except OSError:
            peer = ""
        try:
            while True:
                req = _read_frame(conn, codec[0])
                if not isinstance(req, dict):
                    # valid JSON, wrong shape (e.g. a bare number):
                    # drop the connection rather than crash the
                    # dispatch thread on req.get (adversarial-input
                    # hardening, round 4)
                    raise RPCError(f"non-object frame: {type(req).__name__}")
                if self._negotiate and req.get("method") == HELLO_METHOD:
                    # answered INLINE on the reader thread: the ack must
                    # hit the wire before any frame of the new codec is
                    # read, and the handshake is the connection's first
                    # exchange so nothing else can be in flight
                    self._handle_hello(conn, wlock, req, codec)
                    continue
                # distpow: ok unbounded-thread-spawn -- deliberate
                # goroutine-per-request parity (class docstring): a slow
                # handler (the blocking Mine) must not head-of-line-block
                # the connection; depth is bounded by the caller's own
                # in-flight window, and admission control sheds
                # load before this layer sees it
                threading.Thread(
                    target=self._dispatch,
                    args=(conn, wlock, req, peer, codec),
                    daemon=True,
                ).start()
        except (ConnectionError, OSError, ValueError, RPCError):
            # ValueError covers json.JSONDecodeError AND the
            # UnicodeDecodeError a non-UTF-8 payload raises; RPCError
            # covers protocol violations from _read_frame (oversized
            # frame) and the shape check above — close the offending
            # connection quietly; other clients are unaffected
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle_hello(self, conn, wlock, req: dict, codec: List[object]) -> None:
        """Codec negotiation (docs/RPC.md): ack a supported version and
        flip this connection to the binary codec; anything else gets an
        error frame and the connection stays on JSON.  The hello itself
        always travels as v1 in both directions."""
        want = req.get("params") or {}
        version = want.get("codec") if isinstance(want, dict) else None
        if version == wire.WIRE_VERSION:
            result = {"codec": wire.WIRE_VERSION}
            if self.hello_extra is not None:
                try:
                    result.update(self.hello_extra() or {})
                # distpow: ok silent-except -- the hello extra is an
                # ADVISORY advertisement (the cluster ring): a broken
                # provider must not take codec negotiation down with
                # it, and clients refresh the same payload via
                # Cluster.Ring where a failure IS surfaced
                except Exception:
                    pass
            resp = {"id": req.get("id"), "result": result, "error": None}
        else:
            resp = {"id": req.get("id"), "result": None,
                    "error": f"RPCError: unsupported wire codec {version!r}"}
        try:
            _write_frame(conn, resp, wlock, JSON_CODEC)
        except OSError:
            return
        if resp["error"] is None:
            codec[0] = BINARY_CODEC
            metrics.inc("rpc.codec.negotiated_v2")

    def _dispatch(self, conn, wlock, req: dict, peer: str = "",
                  codec: Optional[List[object]] = None) -> None:
        codec = codec or [JSON_CODEC]
        rid = req.get("id")
        try:
            service_name, _, method_name = req["method"].partition(".")
            service = self._services.get(service_name)
            if service is None:
                raise RPCError(f"unknown service {service_name!r}")
            if method_name.startswith("_"):
                raise RPCError(f"method {method_name!r} is not exported")
            method = getattr(service, method_name, None)
            if method is None or not callable(method):
                raise RPCError(f"unknown method {req['method']!r}")
            # per-method handler latency: the distribution the
            # telemetry plane exists for — a slow Mine is invisible in
            # counters alone.  Timed only once the method resolved, so
            # adversarial method strings cannot mint histogram families.
            t0 = time.monotonic()
            try:
                result = method(req.get("params") or {})
            finally:
                metrics.observe(
                    f"rpc.server.dispatch_s.{service_name}.{method_name}",
                    time.monotonic() - t0,
                )
            resp = {"id": rid, "result": result, "error": None}
        except Exception as exc:  # handler errors travel to the caller
            metrics.inc("rpc.handler_errors")
            resp = {"id": rid, "result": None, "error": f"{type(exc).__name__}: {exc}"}
            # typed backpressure: an exception carrying retry_after_s
            # (duck-typed — the runtime layer must not import sched)
            # ships the hint as a dedicated frame field so clients get
            # a machine-readable RETRY_AFTER, not a string to parse
            retry_after = getattr(exc, "retry_after_s", None)
            if retry_after is not None:
                try:
                    resp["retry_after"] = float(retry_after)
                except (TypeError, ValueError):
                    pass
            # typed NOT_OWNER redirect: an exception carrying a
            # ``ring_wire`` snapshot (duck-typed — this layer must not
            # import cluster, mirroring the retry_after discipline)
            # ships it as the response frame's dedicated ``ring``
            # field, so misrouted clients re-route in one round trip
            ring = getattr(exc, "ring_wire", None)
            if isinstance(ring, dict):
                resp["ring"] = ring
        if faults.PLAN is not None:
            hit = faults.PLAN.on_frame(
                "server", str(req.get("method") or ""), peer
            )
            if hit is not None:
                kind, delay = hit
                if kind == "delay":
                    time.sleep(delay)
                elif kind == "drop":
                    return  # response silently never sent
                elif kind == "duplicate":
                    try:
                        _write_frame(conn, resp, wlock, codec[0])
                        _write_frame(conn, resp, wlock, codec[0])
                    except OSError:
                        pass
                    return
                elif kind == "truncate":
                    # partial response, then reset: the peer's pending
                    # calls on this connection all fail fast
                    _write_truncated(conn, resp, wlock, codec[0])
                    for op in (lambda: conn.shutdown(socket.SHUT_RDWR),
                               conn.close):
                        try:
                            op()
                        except OSError:
                            pass
                    return
        try:
            _write_frame(conn, resp, wlock, codec[0])
        except OSError:
            pass

    def shutdown(self) -> None:
        self._shutdown.set()
        for ls in self._listeners:
            # close() alone does NOT interrupt a thread parked in
            # accept() on Linux — the listening description stays alive
            # and the port keeps accepting.  Wake the acceptor with a
            # throwaway connection first; it sees _shutdown and exits.
            try:
                host, port = ls.getsockname()[:2]
                if host == "0.0.0.0":
                    host = "127.0.0.1"
                elif host == "::":
                    # V6ONLY listener (create_server default): the wake
                    # connection must itself be IPv6
                    host = "::1"
                with socket.create_connection((host, port), timeout=0.5):
                    pass
            except OSError:
                pass
            try:
                ls.close()
            except OSError:
                pass
        # join the acceptors: a thread still inside accept() keeps the
        # listening description (and the PORT) alive past ls.close(), so
        # an immediate restart on the same address would hit EADDRINUSE
        for t in self._threads:
            t.join(timeout=2.0)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            # SHUT_RDWR first: close() alone neither wakes this server's
            # own reader thread blocked in recv on the fd nor (therefore)
            # sends the FIN that tells peers the server is gone — clients
            # would never see their in-flight calls fail
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


class RPCClient:
    """Connection to one RPC server: blocking ``call`` and async ``go``.

    The send path is BOUNDED (``send_timeout``): a peer that stops
    reading fills the TCP buffer and ``sendall`` would otherwise block
    forever while holding the write lock — wedging every other caller on
    this client, including the failure detector's probes, before their
    own future timeouts could apply.  The bound is
    the kernel-level ``SO_SNDTIMEO`` — NOT ``settimeout``, which flips
    the shared fd to non-blocking and would poison the reader thread's
    blocking recv.  A send that trips the bound (or fails at all) tears
    the connection down rather than reusing it, because a partially
    written frame has corrupted the stream; pending callers all fail
    fast and can re-dial.
    """

    def __init__(self, addr: str, timeout: Optional[float] = 10.0,
                 send_timeout: float = 20.0, codec: Optional[str] = None):
        self._addr = addr
        self._dial_timeout = timeout
        self._send_timeout = send_timeout
        if faults.PLAN is not None:
            faults.PLAN.on_connect(addr)  # may delay or refuse the dial
        self._sock = self._dial()
        self._wlock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._plock = threading.Lock()
        self._next_id = 0
        self._closed = False
        self._dead: Optional[RPCError] = None  # set by the reader on death
        #: extra keys a v2 server's hello ack carried beside ``codec``
        #: (the cluster ring advertisement — docs/CLUSTER.md); empty on
        #: JSON-pinned clients and against pre-extension servers
        self.hello_info: Dict[str, Any] = {}
        # wire codec (module docstring): negotiated synchronously BEFORE
        # the reader thread exists, so reader and senders always agree
        mode = codec or CLIENT_CODEC_DEFAULT
        if mode not in ("auto", "json", "binary"):
            raise ValueError(f"unknown rpc codec mode {mode!r}")
        self._codec = JSON_CODEC if mode == "json" else \
            self._negotiate_codec(mode)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _dial(self) -> socket.socket:
        sock = socket.create_connection(split_addr(self._addr),
                                        timeout=self._dial_timeout)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._send_timeout:
            sec = int(self._send_timeout)
            usec = int((self._send_timeout - sec) * 1e6)
            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                struct.pack("ll", sec, usec),
            )
        return sock

    def _negotiate_codec(self, mode: str):
        """One v1 round trip: ``rpc.hello`` → ack means wire v2; a
        pre-v2 server's unknown-method error means stay on JSON.  A
        TIMED-OUT or garbled handshake tears this socket down and
        re-dials a fresh one with no hello: a slow v2 server may still
        ack (and flip ITS side to binary) after we give up, so reusing
        the socket could split-brain the codec — or leave a
        partially-read ack desynchronizing the length-prefixed stream —
        while the fresh hello-less connection is v1 on both sides by
        construction.  Connection-level failures propagate like any
        other dial failure.  ``mode == "binary"`` turns any fallback
        into an error instead."""
        hello = {"id": 0, "method": HELLO_METHOD,
                 "params": {"codec": wire.WIRE_VERSION}}
        resp = None
        redial = False
        try:
            self._sock.settimeout(HELLO_TIMEOUT_S)
            try:
                _write_frame(self._sock, hello, self._wlock, JSON_CODEC)
                resp = _read_frame(self._sock, JSON_CODEC)
            except (TimeoutError, socket.timeout):
                redial = True  # silent peer: see docstring
            except (ValueError, RPCError):
                redial = True  # garbled/oversized reply: same hazard
        finally:
            try:
                self._sock.settimeout(None)
            except OSError:
                pass
        ok = (isinstance(resp, dict) and isinstance(resp.get("result"), dict)
              and resp["result"].get("codec") == wire.WIRE_VERSION)
        if ok:
            metrics.inc("rpc.codec.negotiated_v2")
            self.hello_info = {k: v for k, v in resp["result"].items()
                               if k != "codec"}
            return BINARY_CODEC
        metrics.inc("rpc.codec.fallback_v1")
        if mode == "binary":
            try:
                self._sock.close()
            except OSError:
                pass
            raise RPCError(f"peer {self._addr} does not speak wire v2")
        if redial:
            # one logical dial: the fault plane's @connect hook already
            # ran for it, so the replacement socket is not re-hooked
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = self._dial()
        return JSON_CODEC

    @property
    def codec_name(self) -> str:
        """"json" (wire v1) or "binary" (wire v2) for this connection."""
        return self._codec.name

    def _read_loop(self) -> None:
        try:
            while True:
                resp = _read_frame(self._sock, self._codec)
                if not isinstance(resp, dict):
                    raise RPCError(f"non-object frame: {type(resp).__name__}")
                with self._plock:
                    fut = self._pending.pop(resp.get("id"), None)
                if fut is None:
                    continue
                if resp.get("error"):
                    # a malformed hint must NOT kill the reader thread
                    # (a TypeError here would skip the fail-all
                    # teardown below and strand every pending future):
                    # degrade to a plain RPCError instead
                    try:
                        retry_after = float(resp["retry_after"])
                    except (KeyError, TypeError, ValueError):
                        retry_after = None
                    ring = resp.get("ring")
                    if isinstance(ring, dict):
                        # NOT_OWNER redirect (cluster plane): the ring
                        # snapshot outranks a retry_after hint — a
                        # misrouted key must move, not wait
                        fut.set_exception(RPCNotOwner(
                            resp["error"], ring
                        ))
                    elif retry_after is not None:
                        fut.set_exception(RPCRetryAfter(
                            resp["error"], retry_after
                        ))
                    else:
                        fut.set_exception(RPCError(resp["error"]))
                else:
                    fut.set_result(resp.get("result"))
        except (ConnectionError, OSError, ValueError, RPCError) as exc:
            # same coverage as the server reader: an
            # oversized/undecodable/non-object response must FAIL the
            # pending futures, not strand them behind a dead reader
            err = exc if self._closed is False else ConnectionError("client closed")
            with self._plock:
                pending, self._pending = self._pending, {}
                # the dead flag and the swap share one critical
                # section: a concurrent go() either registered before
                # (its future is in `pending`, failed below) or
                # registers after (it sees _dead and fails fast) — no
                # window where a future lands in the fresh dict with no
                # reader to resolve it
                self._dead = RPCTransportError(str(err))
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(RPCTransportError(str(err)))
            # and tear the CONNECTION down: on a protocol violation the
            # socket is still healthy, so without this a later go()/
            # call() would send fine and then wait forever on a reader
            # that no longer exists; closing makes the next
            # send fail fast like the ConnectionError path
            try:
                self._sock.close()
            except OSError:
                pass

    def go(self, method: str, params: Optional[dict] = None) -> Future:
        """Async call; resolves with the result (rpc.Client.Go role)."""
        fut: Future = Future()
        with self._plock:
            if self._dead is not None:
                # a FRESH instance per future: raising a shared
                # exception object from concurrent .result() callers
                # would interleave their __traceback__s
                fut.set_exception(RPCTransportError(str(self._dead)))
                return fut
            self._next_id += 1
            rid = self._next_id
            self._pending[rid] = fut
        req = {"id": rid, "method": method, "params": params or {}}
        # round-trip latency per method, observed when the reader (or a
        # teardown path) RESOLVES the future — success and error alike.
        # A frame silently lost on a healthy connection (drop fault, or
        # a peer that just never answers) has no completion to time and
        # leaves no sample here; that outage surfaces in the caller-
        # level histograms instead (powlib.mine_s spans its retries)
        t0 = time.monotonic()
        fut.add_done_callback(
            lambda _f, _m=method, _t0=t0: metrics.observe(
                f"rpc.client.call_s.{_m}", time.monotonic() - _t0
            )
        )
        duplicate = False
        if faults.PLAN is not None:
            hit = faults.PLAN.on_frame("client", method, self._addr)
            if hit is not None:
                kind, delay = hit
                if kind == "delay":
                    time.sleep(delay)
                elif kind == "drop":
                    # silently never sent; the connection stays healthy,
                    # so only the caller's own timeout observes this
                    return fut
                elif kind == "duplicate":
                    duplicate = True
                elif kind == "truncate":
                    # partial frame + teardown: the reader fails every
                    # pending future (this one included) with a
                    # transport error, like a real mid-frame reset
                    _write_truncated(self._sock, req, self._wlock,
                                     self._codec)
                    self.close()
                    return fut
        try:
            _write_frame(self._sock, req, self._wlock, self._codec)
            if duplicate:
                _write_frame(self._sock, req, self._wlock, self._codec)
        except OSError as exc:
            with self._plock:
                self._pending.pop(rid, None)
            fut.set_exception(RPCTransportError(str(exc)))
            # a failed sendall may have written a PARTIAL frame (SNDTIMEO
            # surfaces as BlockingIOError mid-write); the stream is
            # unusable — tear it down so the reader fails every pending
            # future and callers re-dial
            self.close()
        return fut

    @property
    def dead(self) -> bool:
        """True once the transport is unusable (reader died or close()
        was called).  False means the connection is healthy as far as
        anyone can tell — a frame lost to a drop fault or an unanswered
        call does NOT flip this; callers deciding whether to re-dial vs
        re-issue on the same connection use exactly that distinction
        (nodes/powlib.py _reconnect)."""
        return self._dead is not None or self._closed

    def call(
        self, method: str, params: Optional[dict] = None, timeout: Optional[float] = None
    ) -> Any:
        """Blocking call (rpc.Client.Call role)."""
        return self.go(method, params).result(timeout=timeout)

    def close(self) -> None:
        self._closed = True
        try:
            # wake the reader thread if it is blocked in recv
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
