"""Standalone tracing server (SURVEY.md section 2 component 13).

Collects trace events from every node's tracer over TCP and writes two
logs, mirroring the role of the DistributedClocks tracing server the
reference boots in cmd/tracing-server/main.go:10-17 with the output files
configured in config/tracing_server_config.json:4-5:

* ``OutputFile`` — human-readable, one line per event:
  ``[identity] TraceID=… Action field=value, …``
* ``ShivizOutputFile`` — ShiViz-compatible vector-clock log.  Parser
  regex (header written at the top of the file):
  ``(?<host>\\S*) (?<clock>{.*})\\n(?<event>.*)``

Wire protocol: framed JSON (4-byte big-endian length prefix), first frame
per connection is a hello carrying the shared secret (tracing.TCPSink);
connections with a wrong secret are dropped, mirroring the reference
tracer's shared-secret authentication (worker.go:117-121).

The port's own copy of the reference's ``runtime/trace_server.py``
(``distpow_tpu/runtime/trace_server.py``): it imports nothing of the JAX
package.
"""

from __future__ import annotations

import base64
import json
import socket
import threading
from typing import Optional

from .config import TracingServerConfig
from .rpc import _read_frame, split_bind_addr  # same framing as the RPC layer
from .tracing import format_trace_line

SHIVIZ_HEADER = "(?<host>\\S*) (?<clock>{.*})\\n(?<event>.*)\n\n"


def govector_vc_string(vc: dict) -> str:
    """Byte-compatible rendering of GoVector's ``vclock.ReturnVCString()``.

    The published GoVector clock-line shape (the format every
    DistributedClocks ShiViz log uses, and what the reference's tracing
    server emits through govec): ids sorted lexicographically,
    ``"id":count`` pairs joined by ``", "`` inside braces —
    ``{"alpha":2, "beta":1}``.  Still valid JSON, so every consumer
    (runtime/trace_check.py check_shiviz_log, ShiViz itself) parses it
    unchanged; emitting it byte-identically means a clock line from this
    server and one from a GoVector log diff clean
    (tests/test_trace_parity.py golden-shape case).

    Ids are JSON-escaped: for every id without quotes/backslashes —
    every real config — the bytes match GoVector exactly (which
    interpolates ids raw via fmt.Sprintf and would itself emit a broken
    line for such ids); for pathological ids we stay parseable instead
    of corrupting the log.
    """
    return "{" + ", ".join(
        f"{json.dumps(k)}:{int(vc[k])}" for k in sorted(vc)) + "}"


class TracingServer:
    """TCP trace collector writing human + ShiViz logs."""

    def __init__(self, config: TracingServerConfig):
        self.config = config
        self._listener: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._out = open(config.OutputFile, "a", buffering=1)
        self._shiviz = open(config.ShivizOutputFile, "a", buffering=1)
        if self._shiviz.tell() == 0:
            self._shiviz.write(SHIVIZ_HEADER)
        self._shutdown = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def open(self) -> str:
        host, port = split_bind_addr(self.config.ServerBind)
        self._listener = socket.create_server((host, port))
        bound = self._listener.getsockname()
        return f"{host or '127.0.0.1'}:{bound[1]}"

    def accept_forever(self) -> None:
        assert self._listener is not None, "open() first"
        while not self._shutdown.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            # distpow: ok unbounded-thread-spawn -- thread-per-node
            # connection like the RPC server's accept loop: the tracing
            # peers are the cluster's nodes, a small bounded set
            threading.Thread(
                target=self._conn_loop, args=(conn,), daemon=True
            ).start()

    def accept_in_background(self) -> None:
        threading.Thread(target=self.accept_forever, daemon=True).start()

    def close(self) -> None:
        self._shutdown.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            self._out.close()
            self._shiviz.close()

    # -- internals ---------------------------------------------------------
    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            hello = _read_frame(conn)
            if hello.get("type") != "hello":
                return
            secret = base64.b64decode(hello.get("secret", ""))
            if secret != bytes(self.config.Secret):
                return  # drop unauthenticated tracers
            while True:
                self._handle_event(_read_frame(conn))
        except (ConnectionError, OSError, json.JSONDecodeError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle_event(self, event: dict) -> None:
        with self._lock:
            if self._out.closed:
                return
            self._out.write(format_trace_line(event) + "\n")
            vc = govector_vc_string(event.get("vc", {}))
            if event["type"] == "action":
                desc = f"{event['action']} {json.dumps(event['body'])}"
            else:
                desc = f"{event['type']} TraceID={event.get('trace_id')}"
            self._shiviz.write(f"{event['identity']} {vc}\n{desc}\n")
