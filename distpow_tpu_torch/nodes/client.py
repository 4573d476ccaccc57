"""Client wrapper binding config + tracer + powlib into a node object
(SURVEY.md section 2 component 2; reference: client.go).

``ChCapacity`` defaults to 10 (client.go:9).  ``initialize`` may only run
once per instance (client.go:44-46); ``mine`` delegates to powlib with
this client's tracer; ``close`` tears down tracer then powlib
(client.go:61-68).

The port's own copy of the reference's ``nodes/client.py``
(``distpow_tpu/nodes/client.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import queue
from typing import Optional

from ..runtime.config import ClientConfig
from ..runtime.tracing import make_tracer
from .powlib import POW, MineResult


class Client:
    def __init__(self, config: ClientConfig, pow_: Optional[POW] = None, sink=None):
        self.config = config
        self.pow = pow_ or POW()
        self.tracer = None
        self._sink = sink
        self.notify_queue: Optional["queue.Queue[MineResult]"] = None
        self._initialized = False

    def initialize(self) -> "queue.Queue[MineResult]":
        if self._initialized:
            raise RuntimeError("client has been initialized before")
        # coordinator-outage resilience knobs ride the config
        # (nodes/powlib.py module docstring; defaults in ClientConfig).
        # CoordAddrs (>= 2 entries) flips powlib into cluster mode —
        # consistent-hash routing over the coordinator pool
        # (docs/CLUSTER.md); otherwise the single CoordAddr keeps the
        # historical behavior byte-identical.
        # a one-entry pool still names a valid coordinator (powlib
        # collapses it to plain single mode) — falling through to a
        # possibly-empty CoordAddr would discard it
        pool = list(getattr(self.config, "CoordAddrs", []) or [])
        self.notify_queue = self.pow.initialize(
            pool if pool else self.config.CoordAddr,
            self.config.ChCapacity,
            retries=getattr(self.config, "MineRetries", None),
            backoff_s=getattr(self.config, "MineBackoffS", None),
            backoff_max_s=getattr(self.config, "MineBackoffMaxS", None),
            attempt_timeout_s=getattr(self.config, "MineAttemptTimeoutS", None),
        )
        self.tracer = make_tracer(
            self.config.ClientID,
            self.config.TracerServerAddr,
            self.config.TracerSecret,
            sink=self._sink,
        )
        self._initialized = True
        return self.notify_queue

    def mine(self, nonce: bytes, num_trailing_zeros: int,
             hash_model: Optional[str] = None) -> None:
        """``hash_model`` (optional, docs/SERVING.md): request an
        off-default hash model end to end — powlib tags the Mine, the
        coordinator routes it cache-skipped to model-capable workers.
        None keeps the request wire-identical to every earlier
        version."""
        if not self._initialized:
            raise RuntimeError("client not initialized")
        self.pow.mine(self.tracer, nonce, num_trailing_zeros,
                      hash_model=hash_model)

    def close(self) -> None:
        # powlib first: it joins in-flight mine threads, which may still
        # record actions — the tracer's sink must outlive them
        self.pow.close()
        if self.tracer is not None:
            self.tracer.close()
        self._initialized = False
