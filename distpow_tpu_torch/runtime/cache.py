"""Nonce-keyed dominance result cache with trace emission.

One implementation serving both the coordinator and worker roles.  The
reference duplicates this logic verbatim in both nodes
(coordinator.go:390-473 vs worker.go:423-506); per SURVEY.md section 7
item 2 we deliberately de-duplicate — semantics are identical:

* key: the raw nonce bytes (coordinator.go:479-481, worker.go:512-514);
  one entry per nonce.
* ``get`` hits iff the entry's difficulty >= the requested difficulty
  (coordinator.go:403); every lookup records ``CacheHit`` (with the stored
  secret) or ``CacheMiss``.
* ``add`` installs when no entry exists; replaces when the new entry has
  strictly more trailing zeros (coordinator.go:436) or equal zeros and a
  lexicographically greater secret (``bytes.Compare > 0``,
  coordinator.go:454) — the "dominance" order that keeps all replicas
  convergent regardless of result arrival order.  Replacement records
  ``CacheRemove`` then ``CacheAdd``; a dominated insert records nothing.

Checkpoint/resume (a capability the reference lacks — its caches are
in-memory only and a restarted node starts cold, coordinator.go:105-108,
worker.go:98-101): pass ``persist_path`` and every accepted add is
appended to a JSONL journal; on construction the journal is replayed
through the same dominance order, so a restarted node resumes with the
converged cache state.  Replay tolerates a truncated final line (torn
write on crash) and compacts the journal when it has accumulated
superseded entries.  Compaction is crash-consistent: the replacement
journal is written to a temp file, fsynced, atomically renamed over
the original, and the directory entry is fsynced — a crash at ANY
point mid-compaction leaves either the complete old journal or the
complete new one, never a truncated mix (tests/test_runtime.py kills
compaction mid-write and asserts full replay).  This journal plus the
restart-epoch file is the coordinator pool's per-member durability
story (docs/CLUSTER.md "Replication & HA"): a restarted member replays
its journal, then anti-entropy backfills what it missed while dead.

The port's own copy of the reference's ``runtime/cache.py``
(``distpow_tpu/runtime/cache.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional

from .actions import CacheAdd, CacheHit, CacheMiss, CacheRemove
from .metrics import REGISTRY as metrics
from .tracing import Trace

log = logging.getLogger("distpow.cache")


@dataclass
class CacheEntry:
    num_trailing_zeros: int
    secret: bytes


class ResultCache:
    def __init__(self, persist_path: Optional[str] = None):
        self._entries: Dict[bytes, CacheEntry] = {}
        self._lock = threading.Lock()
        self._journal = None
        self._replaying = False
        if persist_path:
            # journal replay must not count as protocol cache traffic —
            # a restart would otherwise report thousands of cache.add at
            # uptime ~0
            self._replaying = True
            try:
                lines, torn = self._replay(persist_path)
            finally:
                self._replaying = False
            if torn or lines > 2 * len(self._entries):
                # a torn tail MUST be rewritten before appending: a new
                # record appended after a partial line would merge into
                # one corrupt line and poison the next replay
                self._compact(persist_path)
            self._journal = open(persist_path, "a", encoding="ascii")

    # -- persistence -------------------------------------------------------
    def _replay(self, path: str):
        """Load journal lines through the dominance order; returns
        (lines_seen, torn) for the compaction decision."""
        if not os.path.exists(path):
            return 0, False
        lines, torn = 0, False
        with open(path, "r", encoding="ascii") as fh:
            for raw in fh:
                raw = raw.strip()
                if not raw:
                    continue
                lines += 1
                try:
                    rec = json.loads(raw)
                    self.add(
                        bytes.fromhex(rec["nonce"]),
                        int(rec["ntz"]),
                        bytes.fromhex(rec["secret"]),
                        trace=None,
                    )
                except (ValueError, KeyError, TypeError) as exc:
                    # torn tail write from a crash mid-append: stop here
                    log.warning("cache journal %s: stopping replay at "
                                "corrupt line %d (%s)", path, lines, exc)
                    torn = True
                    break
        log.info("cache journal %s: %d entries resumed from %d lines",
                 path, len(self._entries), lines)
        return lines, torn

    def _compact(self, path: str) -> None:
        """Rewrite the journal to the converged entry set, crash-
        consistently (module docstring): temp file + fsync + atomic
        rename + directory fsync.  A crash mid-write leaves the
        original journal untouched; a crash after the rename leaves
        the complete replacement — no interleaving can shorten the
        next replay."""
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="ascii") as fh:
            for nonce, e in self._entries.items():
                fh.write(json.dumps({
                    "nonce": nonce.hex(),
                    "ntz": e.num_trailing_zeros,
                    "secret": e.secret.hex(),
                }) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        try:
            # the rename itself must reach disk, or a crash can resurrect
            # the superseded journal the replay decision was made against
            dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                          os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:  # platforms without directory fsync: best effort
            pass

    def _append(self, nonce: bytes, ntz: int, secret: bytes) -> None:
        if self._journal is None:
            return
        self._journal.write(json.dumps({
            "nonce": nonce.hex(), "ntz": ntz, "secret": secret.hex(),
        }) + "\n")
        self._journal.flush()

    def close(self) -> None:
        with self._lock:
            if self._journal is not None:
                self._journal.close()
                self._journal = None

    def get(
        self, nonce: bytes, num_trailing_zeros: int, trace: Optional[Trace]
    ) -> Optional[bytes]:
        nonce = bytes(nonce)
        with self._lock:
            entry = self._entries.get(nonce)
            if entry is not None and entry.num_trailing_zeros >= num_trailing_zeros:
                metrics.inc("cache.hit")
                if trace:
                    # distpow: ok no-blocking-under-lock -- trace emission
                    # order must match cache state order (the reference
                    # records from inside its cache mutex,
                    # coordinator.go:403); emitting after release lets a
                    # concurrent add interleave a contradictory event
                    trace.record_action(
                        CacheHit(
                            nonce=nonce,
                            num_trailing_zeros=num_trailing_zeros,
                            secret=entry.secret,
                        )
                    )
                return entry.secret
            metrics.inc("cache.miss")
            if trace:
                # distpow: ok no-blocking-under-lock -- same mutex-order
                # invariant as the hit path above
                trace.record_action(
                    CacheMiss(nonce=nonce, num_trailing_zeros=num_trailing_zeros)
                )
            return None

    def add(
        self,
        nonce: bytes,
        num_trailing_zeros: int,
        secret: bytes,
        trace: Optional[Trace],
    ) -> bool:
        """Install/replace per the dominance order; True if the cache changed."""
        nonce, secret = bytes(nonce), bytes(secret)
        with self._lock:
            entry = self._entries.get(nonce)
            if entry is None:
                if not self._replaying:
                    metrics.inc("cache.add")
                self._entries[nonce] = CacheEntry(num_trailing_zeros, secret)
                self._append(nonce, num_trailing_zeros, secret)
                if trace:
                    # distpow: ok no-blocking-under-lock -- CacheAdd must
                    # be emitted in cache-mutation order (reference emits
                    # inside the cache mutex, coordinator.go:436)
                    trace.record_action(
                        CacheAdd(
                            nonce=nonce,
                            num_trailing_zeros=num_trailing_zeros,
                            secret=secret,
                        )
                    )
                return True
            dominates = num_trailing_zeros > entry.num_trailing_zeros or (
                num_trailing_zeros == entry.num_trailing_zeros
                and secret > entry.secret
            )
            if not dominates:
                return False
            if trace:
                # one tracer-lock critical section: the Remove/Add pair is
                # adjacent in the reference trace (emitted from inside the
                # cache mutex, coordinator.go:436-454) and trace_check.py
                # asserts that adjacency — per-action locking would let a
                # concurrent handler interleave an event between them
                # distpow: ok no-blocking-under-lock -- the adjacency
                # invariant above requires emitting under the cache mutex
                trace.record_actions(
                    CacheRemove(
                        nonce=nonce,
                        num_trailing_zeros=entry.num_trailing_zeros,
                        secret=entry.secret,
                    ),
                    CacheAdd(
                        nonce=nonce,
                        num_trailing_zeros=num_trailing_zeros,
                        secret=secret,
                    ),
                )
            if not self._replaying:
                metrics.inc("cache.evict")
                metrics.inc("cache.add")
            self._entries[nonce] = CacheEntry(num_trailing_zeros, secret)
            self._append(nonce, num_trailing_zeros, secret)
            return True

    def peek(self, nonce: bytes) -> Optional[CacheEntry]:
        """Inspect without tracing (tests/diagnostics)."""
        with self._lock:
            return self._entries.get(bytes(nonce))

    def entries_snapshot(self):
        """Point-in-time ``[(nonce, ntz, secret), ...]`` copy — the
        replication plane's iteration surface (cluster/replication.py:
        handoff range computation, anti-entropy digests).  A snapshot,
        not a live view: the caller walks it outside the cache lock, so
        a concurrent add during a handoff costs at most one entry the
        anti-entropy loop heals later."""
        with self._lock:
            return [(n, e.num_trailing_zeros, e.secret)
                    for n, e in self._entries.items()]

    def satisfies(self, nonce: bytes, num_trailing_zeros: int) -> Optional[bytes]:
        """Unmetered, untraced dominance lookup for hot polling paths
        (the miner's between-batch cancel check) — ``get`` would swamp the
        cache.hit/cache.miss counters with polling noise and is reserved
        for protocol cache traffic."""
        with self._lock:
            entry = self._entries.get(bytes(nonce))
            if entry is not None and entry.num_trailing_zeros >= num_trailing_zeros:
                return entry.secret
            return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
