"""powlib — the asynchronous client mining library
(SURVEY.md section 2 component 1; reference: powlib/powlib.go).

API parity:

* ``initialize(coord_addr, ch_capacity)`` connects to the coordinator and
  returns the bounded notify queue solutions are delivered on
  (powlib.go:76-93).
* ``mine(tracer, nonce, num_trailing_zeros)`` is non-blocking
  (powlib.go:102-113): it creates a fresh trace, records
  ``PowlibMiningBegin``, and hands off to a request thread which records
  ``PowlibMine``, embeds a token in the RPC args, and issues the async
  ``CoordRPCHandler.Mine`` call (powlib.go:137-156).
* On completion the response token is received back into the tracer and
  ``PowlibSuccess`` + ``PowlibMiningComplete`` are recorded before the
  result lands on the notify queue (powlib.go:164-176).
* ``close()`` stops delivery: in-flight request threads abandon their
  calls (powlib.go:119-135, 179-182) and the connection closes.

Documented divergences from the reference:

* **Coordinator outages are retried, then surfaced — never fatal.**
  The reference ``log.Fatal``s the whole client process on a mine-RPC
  error (powlib.go:161-162).  Here a *transport* failure (connection
  reset/refused, truncated frame, attempt timeout —
  ``rpc.RPCTransportError``) triggers automatic recovery: exponential
  backoff with jitter (``backoff_delay``), a shared re-dial of the
  coordinator connection, and a re-issue of the Mine call — safe
  because Mine is idempotent (the coordinator's dominance cache and
  per-key mutex absorb repeats).  A connection that is still healthy
  (the failure was an attempt timeout or a silently dropped frame) is
  kept and re-issued on; only a dead transport is re-dialed — one slow
  mine hitting its attempt timeout never tears the shared connection
  out from under sibling in-flight mines.  The retry budget is bounded
  (``ClientConfig.MineRetries``); each failed attempt consumes one
  unit, and a *successful* re-dial restores the full budget (an outage
  is charged for its reconnect, not forever) — under an overall
  attempts ceiling (10x the budget, min 8) so a flapping coordinator
  still terminates.  Only when the budget or ceiling is
  exhausted does the notify queue deliver a terminal ``MineResult``
  with ``secret=None`` and ``error="degraded: ..."`` — a caller
  blocked on ``get()`` observes the failure and can escalate; it
  neither crashes nor hangs forever.  An error
  *returned by* the coordinator's handler (plain ``RPCError``) is not
  retried — re-issuing would just re-earn it — and surfaces as an
  error result immediately.  Counters: ``powlib.retries``,
  ``powlib.reconnects``, ``powlib.degraded`` (runtime/metrics.py).
* **Server-paced backpressure is retried without burning budget.**
  A typed RETRY_AFTER rejection (``rpc.RPCRetryAfter``, minted by the
  coordinator's admission control — sched/admission.py) waits the
  server's own hint and re-issues as a NON-COUNTING attempt: load
  shedding is the server working as designed, so it never consumes the
  transport retry budget nor interacts with the reconnect machinery
  (the connection is healthy).  Only the overall attempts ceiling
  bounds it, so a permanently saturated coordinator still terminates
  in a ``degraded:`` error instead of a hang.  Counter:
  ``powlib.retry_after``.
* **Close handshake.**  The reference re-sends the close token so
  ``Close()`` rendezvouses with every in-flight goroutine
  (powlib.go:179-182) — a mechanism its tracing library needs to keep
  the token chain linear.  This tracer's tokens are self-contained
  (runtime/tracing.py), so ``close()`` instead sets an event that makes
  in-flight threads abandon their calls, then joins them with a bounded
  timeout.  Observable behavior matches: after close, no further
  results are delivered and the process can exit.

The port's own copy of the reference's ``nodes/powlib.py``
(``distpow_tpu/nodes/powlib.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass
from typing import Optional

from ..cluster.ring import HashRing, ring_from_peers
from ..runtime import actions as act
from ..runtime.metrics import REGISTRY as metrics
from ..runtime.rpc import (
    RPCClient,
    RPCError,
    RPCNotOwner,
    RPCRetryAfter,
    RPCTransportError,
)
from ..runtime.spans import SPANS
from ..runtime.telemetry import RECORDER
from ..runtime.tracing import Tracer, decode_token, wire_token

log = logging.getLogger("distpow.powlib")

# Retry defaults (ClientConfig.Mine* fields override per client).
DEFAULT_RETRIES = 4
DEFAULT_BACKOFF_S = 0.2
DEFAULT_BACKOFF_MAX_S = 2.0
# Bounds on the server's RETRY_AFTER hint (sched/admission.py): the
# floor keeps a zero/garbage hint from spinning; the cap keeps a
# misconfigured server from parking a mine for minutes per attempt.
RETRY_AFTER_MIN_S = 0.01
RETRY_AFTER_MAX_S = 30.0


def backoff_delay(attempt: int, base: float, cap: float,
                  rng: random.Random) -> float:
    """Jittered exponential backoff: uniform in ``[u/2, u]`` where
    ``u = min(cap, base * 2**attempt)`` — so every delay is positive,
    never exceeds ``cap``, and the halved floor keeps reconnect storms
    from synchronizing without ever collapsing the wait to zero."""
    upper = min(cap, base * (2.0 ** attempt))
    return upper * (0.5 + 0.5 * rng.random())


class _CoordLink:
    """One pool member's connection state (cluster mode,
    docs/CLUSTER.md): the reconnect/generation machinery, per
    shard.  Dials LAZILY — a dead shard at ``initialize`` time must
    not fail the whole pool — and mirrors ``POW._reconnect``'s
    discipline exactly: one dialer at a time, backoff under the lock so
    concurrent failed attempts queue instead of dial-storming, healthy
    transports kept, budget-restoring True only for a genuinely fresh
    connection."""

    def __init__(self, member_id: str, addr: str):
        self.member_id = member_id
        self.addr = addr
        self._lock = threading.Lock()
        self._client: Optional[RPCClient] = None
        self._gen = 0
        self._hello: dict = {}

    def conn(self):
        """``(client, gen)``, dialing if needed; a failed dial raises
        ``RPCTransportError`` so callers treat 'never dialed' exactly
        like 'send failed'."""
        with self._lock:
            if self._client is None:
                try:
                    # distpow: ok no-blocking-under-lock -- exactly-one-
                    # dialer per shard, like POW._reconnect: the lock
                    # exists to make the dial exclusive; RPCClient has
                    # its default bounded dial timeout
                    self._client = RPCClient(self.addr)
                except OSError as exc:
                    raise RPCTransportError(
                        f"shard {self.member_id} ({self.addr}): {exc}"
                    ) from exc
                self._gen += 1
                self._hello = dict(
                    getattr(self._client, "hello_info", {}) or {})
            return self._client, self._gen

    def reconnect(self, stale_gen: Optional[int], attempt: int,
                  pow_: "POW") -> bool:
        """Replace this shard's connection after a transport failure on
        generation ``stale_gen`` (None = the dial itself failed).
        Returns True when the connection is fresh — the caller's cue to
        restore its retry budget (POW._reconnect semantics)."""
        with self._lock:
            if stale_gen is not None and self._gen != stale_gen:
                return True  # a sibling attempt already replaced it
            delay = backoff_delay(
                attempt, pow_.backoff_s, pow_.backoff_max_s, pow_._rng
            )
            # distpow: ok no-blocking-under-lock -- same single-dialer
            # design as POW._reconnect: failed attempts queue behind
            # the one re-dialer; the wait is close()-interruptible
            if pow_._close_ev.wait(delay):
                return False
            if self._client is not None and \
                    not getattr(self._client, "dead", True):
                return False  # healthy transport: re-issue on it
            try:
                # distpow: ok no-blocking-under-lock -- exactly-one-
                # dialer (see above); bounded by the default dial timeout
                fresh = RPCClient(self.addr)
            except OSError as exc:
                log.warning("shard %s re-dial failed: %s",
                            self.member_id, exc)
                return False
            old, self._client = self._client, fresh
            self._gen += 1
            self._hello = dict(getattr(fresh, "hello_info", {}) or {})
            metrics.inc("powlib.reconnects")
            RECORDER.record("powlib.reconnect", addr=self.addr,
                            shard=self.member_id, gen=self._gen)
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        return True

    def alive(self) -> bool:
        """True while this shard's transport looks healthy — the
        failure the caller just saw was an attempt timeout or a
        dropped frame, not a dead connection, so the right move is
        re-issuing on it (the single-coordinator semantics), never a
        failover."""
        with self._lock:
            return self._client is not None and \
                not getattr(self._client, "dead", True)

    def take_hello(self) -> dict:
        """The hello-ack extras of the most recent FRESH dial, consumed
        once: the ring a pooled coordinator advertises in exchange zero
        (docs/CLUSTER.md) reaches ``POW._adopt_ring`` through this."""
        with self._lock:
            info, self._hello = self._hello, {}
            return info

    def close(self) -> None:
        with self._lock:
            client, self._client = self._client, None
        if client is not None:
            try:
                client.close()
            except OSError:
                pass


class _Closed(Exception):
    """Internal: close() was called while an attempt was in flight."""


class _MineFailed(Exception):
    """Internal: the attempt loop concluded with a client-visible error."""


@dataclass
class MineResult:
    nonce: bytes
    num_trailing_zeros: int
    secret: Optional[bytes]
    token: Optional[bytes] = None
    # set (with secret=None) when the mine RPC failed terminally — a
    # coordinator handler error, or a coordinator outage that outlived
    # the retry budget ("degraded: ..."); see module docstring
    error: Optional[str] = None


class POW:
    def __init__(self):
        self.coordinator: Optional[RPCClient] = None
        self.notify_queue: Optional["queue.Queue[MineResult]"] = None
        self.coord_addr: Optional[str] = None
        self.retries = DEFAULT_RETRIES
        self.backoff_s = DEFAULT_BACKOFF_S
        self.backoff_max_s = DEFAULT_BACKOFF_MAX_S
        # per-attempt bound on waiting for the Mine response; None waits
        # forever (a legitimate mine can run arbitrarily long, so only
        # chaos/ops configs should set this)
        self.attempt_timeout_s: Optional[float] = None
        self._close_ev = threading.Event()
        self._inflight: set = set()
        self._inflight_lock = threading.Lock()
        # connection generation: in-flight threads that all hit the same
        # outage coordinate through this so exactly one re-dials and the
        # rest reuse the fresh connection
        self._conn_lock = threading.Lock()
        self._conn_gen = 0
        self._rng = random.Random()  # jitter only — never correctness
        # cluster mode (docs/CLUSTER.md): a cached consistent-hash ring
        # + one _CoordLink per pool member.  None/_links empty in
        # single-coordinator mode, where every code path above stays
        # byte-identical to earlier versions.
        self._ring: Optional[HashRing] = None
        self._ring_lock = threading.Lock()
        self._links: dict = {}

    def initialize(self, coord_addr, ch_capacity: int, *,
                   retries: Optional[int] = None,
                   backoff_s: Optional[float] = None,
                   backoff_max_s: Optional[float] = None,
                   attempt_timeout_s: Optional[float] = None,
                   ) -> "queue.Queue[MineResult]":
        """``coord_addr``: one address (the historical single-
        coordinator mode, behavior byte-identical to every earlier
        version) — or a list/comma-joined string of the POOL's
        client-facing addresses in shard order, which flips this client
        into cluster mode (docs/CLUSTER.md): consistent-hash owner
        routing, hedged sibling retry on RETRY_AFTER, NOT_OWNER ring
        adoption, and ring-guided failover when a shard dies."""
        addrs = (list(coord_addr)
                 if isinstance(coord_addr, (list, tuple))
                 else [a.strip() for a in str(coord_addr).split(",")
                       if a.strip()])
        if len(addrs) > 1:
            return self._initialize_cluster(
                addrs, ch_capacity, retries=retries, backoff_s=backoff_s,
                backoff_max_s=backoff_max_s,
                attempt_timeout_s=attempt_timeout_s,
            )
        coord_addr = addrs[0]
        log.info("dialing coordinator at %s", coord_addr)
        self.coord_addr = coord_addr
        if retries is not None:
            self.retries = int(retries)
        if backoff_s is not None:
            self.backoff_s = float(backoff_s)
        if backoff_max_s is not None:
            self.backoff_max_s = float(backoff_max_s)
        if attempt_timeout_s:  # 0/None both mean "wait forever"
            self.attempt_timeout_s = float(attempt_timeout_s)
        # distpow: ok unguarded-shared-write -- write-once before any
        # reader thread exists: initialize() runs before the notify
        # pump starts, so no thread can observe the handoff; later
        # swaps (in _reconnect) do take _conn_lock
        self.coordinator = RPCClient(coord_addr)
        self.notify_queue = queue.Queue(maxsize=ch_capacity)
        self._close_ev.clear()
        return self.notify_queue

    def _initialize_cluster(self, addrs, ch_capacity: int, *,
                            retries=None, backoff_s=None,
                            backoff_max_s=None, attempt_timeout_s=None,
                            ) -> "queue.Queue[MineResult]":
        """Cluster mode: the seed list IS the pool, so the canonical
        ring (cluster/ring.py ring_from_peers) is computed locally —
        the same pure function every coordinator runs over its
        ClusterPeers — and refreshed thereafter from NOT_OWNER
        redirects and every fresh dial's hello ack (``Cluster.Ring``
        serves CLIs and ops tooling the same snapshot on demand).  No
        connection is dialed here: links dial lazily per shard, so a
        dead seed cannot fail client boot (the chaos contract: clients
        ride out a shard death)."""
        log.info("powlib cluster mode: %d-coordinator pool %s",
                 len(addrs), addrs)
        self.coord_addr = addrs[0]
        if retries is not None:
            self.retries = int(retries)
        if backoff_s is not None:
            self.backoff_s = float(backoff_s)
        if backoff_max_s is not None:
            self.backoff_max_s = float(backoff_max_s)
        if attempt_timeout_s:
            self.attempt_timeout_s = float(attempt_timeout_s)
        with self._ring_lock:
            self._ring = ring_from_peers(addrs)
            self._links = {}
        self.notify_queue = queue.Queue(maxsize=ch_capacity)
        self._close_ev.clear()
        return self.notify_queue

    def mine(self, tracer: Tracer, nonce: bytes, num_trailing_zeros: int,
             hash_model: Optional[str] = None) -> None:
        if self.coordinator is None and self._ring is None:
            raise RuntimeError("powlib not initialized")
        nonce = bytes(nonce)
        trace = tracer.create_trace()
        trace.record_action(
            act.PowlibMiningBegin(nonce=nonce, num_trailing_zeros=num_trailing_zeros)
        )
        t = threading.Thread(
            target=self._call_mine,
            args=(tracer, nonce, num_trailing_zeros, trace,
                  hash_model or None),
            daemon=True,
        )
        with self._inflight_lock:
            self._inflight.add(t)
        t.start()

    # -- the retry machinery ------------------------------------------------
    def _conn(self):
        with self._conn_lock:
            return self.coordinator, self._conn_gen

    def _await_attempt(self, fut):
        """Poll the future, honoring close() and the per-attempt bound."""
        deadline = (
            time.monotonic() + self.attempt_timeout_s
            if self.attempt_timeout_s else None
        )
        while True:
            if self._close_ev.is_set():
                raise _Closed
            try:
                return fut.result(timeout=0.05)
            except (TimeoutError, FutureTimeoutError):
                # both spellings: concurrent.futures.TimeoutError is
                # only an alias of the builtin since Python 3.11
                if deadline is not None and time.monotonic() > deadline:
                    # the frame (or its response) vanished on a healthy
                    # connection — retryable like any transport fault;
                    # the abandoned future is simply never read again
                    raise RPCTransportError(
                        f"mine attempt timed out after "
                        f"{self.attempt_timeout_s:.1f}s"
                    )
                continue
            except CancelledError:
                raise _Closed

    def _issue_attempt(self, client, trace, nonce: bytes, ntz: int,
                       hash_model: Optional[str] = None,
                       no_redirect: bool = False) -> dict:
        """One Mine RPC attempt on ``client`` (fresh token per attempt).
        ``hash_model`` rides as an extra param only when set, keeping
        default-model frames wire-identical to every earlier version.
        ``no_redirect`` (cluster mode, docs/CLUSTER.md) marks a
        deliberate off-owner send — a hedged sibling retry or a
        failover — so the receiving coordinator serves the foreign key
        instead of answering NOT_OWNER."""
        params = {
            "nonce": bytes(nonce),
            "num_trailing_zeros": ntz,
            "token": wire_token(trace.generate_token()),
        }
        if hash_model:
            params["hash_model"] = hash_model
        if no_redirect:
            params["no_redirect"] = True
        fut = client.go("CoordRPCHandler.Mine", params)
        return self._await_attempt(fut)

    def _reconnect(self, stale_gen: int, attempt: int) -> bool:
        """Replace the shared coordinator connection after a transport
        failure observed on generation ``stale_gen``.  Returns True when
        the connection is fresh (this thread re-dialed successfully, or
        a sibling already had) — the caller's cue to restore its retry
        budget.  A connection that is still HEALTHY (``RPCClient.dead``
        false — the failure was an attempt timeout or a dropped frame,
        not a dead transport) is kept: tearing it down would fail every
        sibling mine's pending future mid-flight; the caller simply
        re-issues on it after the backoff.  Holding the lock across the
        backoff sleep is deliberate: concurrent failed attempts queue up
        behind the one re-dialer instead of hammering the coordinator
        with parallel dials."""
        with self._conn_lock:
            if self.coordinator is None:
                return False  # closing
            if self._conn_gen != stale_gen:
                return True  # a sibling attempt already replaced it
            delay = backoff_delay(
                attempt, self.backoff_s, self.backoff_max_s, self._rng
            )
            # distpow: ok no-blocking-under-lock -- holding _conn_lock
            # across the backoff is the design (docstring above): failed
            # attempts queue behind the one re-dialer instead of dial-
            # storming the coordinator; the wait is close()-interruptible
            if self._close_ev.wait(delay):
                return False
            if not getattr(self.coordinator, "dead", True):
                return False  # healthy transport: re-issue on it
            try:
                # distpow: ok no-blocking-under-lock -- exactly-one-dialer:
                # the lock exists to make this dial exclusive (see above);
                # the connect has the RPCClient default dial timeout
                fresh = RPCClient(self.coord_addr)
            except OSError as exc:
                log.warning("coordinator re-dial failed: %s", exc)
                return False
            old, self.coordinator = self.coordinator, fresh
            self._conn_gen += 1
            metrics.inc("powlib.reconnects")
            RECORDER.record("powlib.reconnect", addr=self.coord_addr,
                            gen=self._conn_gen)
            log.info("reconnected to coordinator at %s (gen %d)",
                     self.coord_addr, self._conn_gen)
        try:
            old.close()
        except OSError:
            pass
        return True

    def _mine_with_retry(self, trace, nonce: bytes, ntz: int,
                         hash_model: Optional[str] = None) -> Optional[dict]:
        """Issue Mine until success, terminal failure (_MineFailed), or
        close (returns None).  See the module docstring for semantics.

        Liveness bound: budget resets on a successful re-dial mean a
        FLAPPING coordinator (dial accepts, call dies, repeat) would
        otherwise loop forever — the overall attempts ceiling keeps the
        "terminal error, never a hang" contract true regardless of how
        the outage flaps."""
        if self._ring is not None:
            # cluster mode routes per key (docs/CLUSTER.md); the single-
            # coordinator loop below stays byte-identical to before
            return self._mine_cluster(trace, nonce, ntz, hash_model)
        budget = self.retries
        attempt = 0
        attempts_cap = max(8, self.retries * 10)
        while True:
            client, gen = self._conn()
            if client is None:
                return None
            try:
                # default-model mines keep the historical 4-arg call
                # shape (chaos tests stub _issue_attempt with it)
                if hash_model:
                    return self._issue_attempt(client, trace, nonce, ntz,
                                               hash_model)
                return self._issue_attempt(client, trace, nonce, ntz)
            except _Closed:
                log.info("mine call abandoned on close")
                return None
            except RPCTransportError as exc:
                attempt += 1
                if budget <= 0 or attempt >= attempts_cap:
                    metrics.inc("powlib.degraded")
                    RECORDER.record("powlib.degraded", nonce=nonce.hex(),
                                    ntz=ntz, attempts=attempt,
                                    error=str(exc))
                    raise _MineFailed(
                        f"degraded: mine RPC failed after {attempt} "
                        f"attempt(s) ({self.retries}-retry budget): {exc}"
                    )
                budget -= 1
                metrics.inc("powlib.retries")
                log.warning(
                    "mine RPC transport failure (%s); %d/%d retries left",
                    exc, budget, self.retries,
                )
                if self._reconnect(gen, attempt - 1):
                    budget = self.retries
            except RPCRetryAfter as exc:
                # server-paced backpressure (the coordinator's bounded
                # run queue, sched/admission.py): wait exactly as long
                # as the server asked and re-issue.  NON-COUNTING: the
                # transport-failure budget stays untouched — shedding
                # load is the server working as designed, not an
                # outage, so it must never walk a client toward the
                # terminal "degraded:" error.  The overall attempts
                # ceiling still applies, keeping the never-hangs
                # contract true against a permanently saturated server.
                attempt += 1
                if attempt >= attempts_cap:
                    metrics.inc("powlib.degraded")
                    RECORDER.record("powlib.degraded", nonce=nonce.hex(),
                                    ntz=ntz, attempts=attempt,
                                    error=str(exc))
                    raise _MineFailed(
                        f"degraded: mine RPC backpressured after "
                        f"{attempt} attempt(s): {exc}"
                    )
                metrics.inc("powlib.retry_after")
                delay = min(max(exc.delay_s, RETRY_AFTER_MIN_S),
                            RETRY_AFTER_MAX_S)
                log.info("mine backpressured (%s); retrying in %.3fs "
                         "(server-paced, budget untouched)", exc, delay)
                if self._close_ev.wait(delay):
                    return None
            except RPCError as exc:
                # the coordinator's handler returned an error: re-issuing
                # would re-earn it — surface immediately (module docstring)
                raise _MineFailed(str(exc))

    # -- cluster routing (docs/CLUSTER.md) ----------------------------------
    def _link_for(self, member_id: str) -> Optional[_CoordLink]:
        with self._ring_lock:
            link = self._links.get(member_id)
            if link is None and self._ring is not None:
                addr = self._ring.addr_of(member_id)
                if addr is None:
                    return None  # stale member id: ring moved under us
                link = self._links[member_id] = _CoordLink(member_id, addr)
            return link

    def _adopt_ring(self, wire_dict: dict) -> None:
        """Adopt a ring snapshot (a NOT_OWNER redirect's payload, or a
        hello/Cluster.Ring reply).  Versions order snapshots; equal
        versions adopt too — the redirecting coordinator is
        authoritative about its own membership."""
        try:
            fresh = HashRing.from_wire(wire_dict)
        except (TypeError, ValueError) as exc:
            log.warning("ignoring malformed ring snapshot: %s", exc)
            return
        stale = []
        with self._ring_lock:
            if self._ring is not None and fresh.version < self._ring.version:
                return
            self._ring = fresh
            # a link whose member id now resolves to a DIFFERENT
            # address must leave the table, or every future route to
            # that member would keep hitting the old address and
            # redirect-loop; it is not closed here — in-flight mines
            # on it drain naturally and re-resolve on their next error
            for member_id, link in list(self._links.items()):
                if fresh.addr_of(member_id) != link.addr:
                    stale.append(self._links.pop(member_id))
        if stale:
            log.info("ring adoption invalidated %d link(s): %s",
                     len(stale), [link.member_id for link in stale])

    def _degraded(self, nonce: bytes, ntz: int, attempt: int,
                  exc: BaseException, what: str) -> "_MineFailed":
        metrics.inc("powlib.degraded")
        RECORDER.record("powlib.degraded", nonce=nonce.hex(), ntz=ntz,
                        attempts=attempt, error=str(exc))
        return _MineFailed(
            f"degraded: mine RPC {what} after {attempt} attempt(s) "
            f"({self.retries}-retry budget): {exc}"
        )

    def _mine_cluster(self, trace, nonce: bytes, ntz: int,
                      hash_model: Optional[str] = None) -> Optional[dict]:
        """Cluster-mode Mine: route to the ring owner of the NONCE and
        ride out everything the pool can throw back (docs/CLUSTER.md):

        * ``NOT_OWNER`` — stale client ring: adopt the carried
          snapshot, re-route.  Non-counting (the server did its job);
          only the attempts ceiling bounds a pathological ping-pong.
        * ``RETRY_AFTER`` from the owner — hedged sibling retry: the
          next distinct member on the key's ring walk absorbs the mine
          (``no_redirect``) instead of the client parking on the
          owner's hint.  NON-COUNTING, budget untouched — identical
          semantics to the single-coordinator server-paced retry, the
          wait just becomes useful work on a sibling.  If the sibling
          is saturated too, honor the pacing hint and return to the
          owner.
        * transport failure — the reconnect machinery per shard: backoff +
          re-dial under the link's generation lock (budget-counting,
          budget restored on a successful re-dial).  When the re-dial
          fails the shard is presumed dead and the mine FAILS OVER
          along the ring walk — the sibling serves the foreign key
          over the shared worker fleet; ``cluster.failover_s`` records
          what the death cost this request.  With cache replication on
          (cluster/replication.py, docs/CLUSTER.md "Replication & HA")
          the sibling IS the dead owner's ring successor, so a repeat
          key lands as a dominance-cache hit there — failover serves
          warm, not a re-mine (scripts/ha_smoke.py pins the trace
          shape).
        """
        budget = self.retries
        attempt = 0
        attempts_cap = max(8, self.retries * 10)
        target: Optional[str] = None  # explicit off-owner routing
        dead: set = set()  # members whose re-dial failed this mine
        failover_t0: Optional[float] = None
        while True:
            if self._close_ev.is_set():
                return None
            with self._ring_lock:
                ring = self._ring
            if ring is None:
                return None  # closed
            owner = ring.owner(nonce)
            member = target if target is not None else owner
            foreign = member != owner
            link = self._link_for(member)
            if link is None:
                target = None  # stale target after a ring refresh
                continue
            gen: Optional[int] = None
            try:
                client, gen = link.conn()
                hello = link.take_hello()
                if isinstance(hello.get("ring"), dict):
                    # a FRESH dial's hello ack advertised the pool's
                    # ring (docs/CLUSTER.md): adopt it, and when it
                    # re-routes this key — or moved this member's
                    # address, invalidating the link — re-resolve
                    # BEFORE issuing instead of paying a NOT_OWNER
                    # round trip.  At most one re-resolve per dial
                    # (the hello is consumed), so this cannot spin.
                    self._adopt_ring(hello["ring"])
                    with self._ring_lock:
                        moved = (self._links.get(member) is not link
                                 or (target is None and self._ring
                                     is not None
                                     and self._ring.owner(nonce)
                                     != member))
                    if moved:
                        target = None
                        continue
                result = self._issue_attempt(client, trace, nonce, ntz,
                                             hash_model,
                                             no_redirect=foreign)
                if failover_t0 is not None and foreign:
                    # the observable cost of riding out a shard death:
                    # first owner failure -> successful foreign reply
                    metrics.observe("cluster.failover_s",
                                    time.monotonic() - failover_t0,
                                    trace_id=trace.trace_id)
                    # whether the sibling served from its replicated
                    # cache (warm, the replication plane's promise) or
                    # re-mined is visible one hop down in the trace;
                    # mark the serve so ha_smoke/forensics can join on it
                    RECORDER.record("cluster.failover_served",
                                    member=member,
                                    trace_id=trace.trace_id)
                return result
            except _Closed:
                log.info("mine call abandoned on close")
                return None
            except RPCNotOwner as exc:
                attempt += 1
                if attempt >= attempts_cap:
                    raise self._degraded(nonce, ntz, attempt, exc,
                                         "redirect-looped")
                metrics.inc("cluster.reroutes")
                log.info("mine for %s misrouted to shard %s: adopting "
                         "ring and re-routing", nonce.hex(), member)
                self._adopt_ring(exc.ring)
                target = None
            except RPCTransportError as exc:
                attempt += 1
                if budget <= 0 or attempt >= attempts_cap:
                    raise self._degraded(nonce, ntz, attempt, exc, "failed")
                budget -= 1
                metrics.inc("powlib.retries")
                if failover_t0 is None:
                    failover_t0 = time.monotonic()
                log.warning(
                    "mine RPC transport failure on shard %s (%s); "
                    "%d/%d retries left", member, exc, budget, self.retries,
                )
                if link.reconnect(gen, attempt - 1, self):
                    budget = self.retries
                    dead.discard(member)
                elif link.alive():
                    # the transport is HEALTHY — the failure was an
                    # attempt timeout or a dropped frame, exactly the
                    # case single-coordinator mode re-issues on the
                    # same connection.  No failover: marking a live
                    # owner dead would mis-report a shard death and
                    # sacrifice its dominance-cache locality for the
                    # rest of this mine.
                    dead.discard(member)
                else:
                    # the shard stays unreachable: fail over along the
                    # key's ring walk to the first member not already
                    # found dead this mine (all dead -> start the walk
                    # over; the budget/ceiling still terminate)
                    dead.add(member)
                    nxt = next((m for m in ring.ordered(nonce)
                                if m not in dead), None)
                    if nxt is None:
                        dead = {member}
                        nxt = next((m for m in ring.ordered(nonce)
                                    if m not in dead), None)
                    if nxt is not None and nxt != member:
                        metrics.inc("cluster.failovers")
                        RECORDER.record("cluster.failover",
                                        nonce=nonce.hex(), ntz=ntz,
                                        from_shard=member, to_shard=nxt)
                        log.warning("failing over mine for %s: shard %s "
                                    "-> %s", nonce.hex(), member, nxt)
                    target = nxt
            except RPCRetryAfter as exc:
                attempt += 1
                if attempt >= attempts_cap:
                    raise self._degraded(nonce, ntz, attempt, exc,
                                         "backpressured")
                metrics.inc("powlib.retry_after")
                sibling = next((m for m in ring.ordered(nonce)
                                if m != member), None)
                if not foreign and sibling is not None:
                    # hedged sibling retry: the owner is shedding load,
                    # a sibling may have headroom RIGHT NOW — budget
                    # untouched, no wait (docs/CLUSTER.md)
                    metrics.inc("cluster.sibling_hedges")
                    log.info("mine backpressured by owner %s; hedging "
                             "to sibling %s (non-counting)",
                             member, sibling)
                    target = sibling
                else:
                    # the sibling is saturated too (or the pool is one
                    # shard wide): server-paced wait, then back to the
                    # owner — UNLESS the owner is the member whose
                    # re-dial already failed this mine, in which case
                    # the retry stays on the current (live, merely
                    # busy) member: bouncing to a known-dead owner
                    # would burn one transport-budget unit per pacing
                    # hint and walk a chaos-under-load client into the
                    # terminal degraded error
                    delay = min(max(exc.delay_s, RETRY_AFTER_MIN_S),
                                RETRY_AFTER_MAX_S)
                    log.info("mine backpressured (%s); retrying in "
                             "%.3fs (server-paced, budget untouched)",
                             exc, delay)
                    if self._close_ev.wait(delay):
                        return None
                    target = member if owner in dead else None
            except RPCError as exc:
                # a handler error from whichever shard served the key:
                # re-issuing would re-earn it (module docstring)
                raise _MineFailed(str(exc))

    def _call_mine(self, tracer, nonce, num_trailing_zeros, trace,
                   hash_model=None) -> None:
        t0 = time.monotonic()
        ts0 = time.time()
        try:
            trace.record_action(
                act.PowlibMine(nonce=nonce, num_trailing_zeros=num_trailing_zeros)
            )
            try:
                result = self._mine_with_retry(trace, nonce,
                                               num_trailing_zeros, hash_model)
            except _MineFailed as exc:
                log.error("mine RPC failed: %s", exc)
                # the client half of the request timeline records its
                # failures too — a degraded mine is forensics evidence,
                # not just a log line (docs/FORENSICS.md)
                SPANS.record("powlib.mine", ts0, time.monotonic() - t0,
                             trace_id=trace.trace_id,
                             node=tracer.identity, ntz=num_trailing_zeros,
                             outcome="error")
                if not self._close_ev.is_set():
                    # deliver the failure: a silent drop would leave
                    # the client blocked on the notify queue forever
                    self.notify_queue.put(MineResult(
                        nonce=nonce,
                        num_trailing_zeros=num_trailing_zeros,
                        secret=None,
                        error=str(exc),
                    ))
                return
            if result is None:  # closed mid-call
                return
            # client-observed mine round-trip, retries and backoff
            # included — the end-to-end latency a caller actually waits.
            # The trace id rides as the histogram's bucket exemplar and
            # keys the client-side span of the request timeline.
            mine_s = time.monotonic() - t0
            metrics.observe("powlib.mine_s", mine_s,
                            trace_id=trace.trace_id)
            SPANS.record("powlib.mine", ts0, mine_s,
                         trace_id=trace.trace_id, node=tracer.identity,
                         ntz=num_trailing_zeros, outcome="ok")
            token = decode_token(result["token"])
            result_trace = tracer.receive_token(token)
            mr = MineResult(
                nonce=bytes(result["nonce"]),
                num_trailing_zeros=int(result["num_trailing_zeros"]),
                secret=bytes(result["secret"]),
                token=token,
            )
            result_trace.record_action(
                act.PowlibSuccess(
                    nonce=mr.nonce,
                    num_trailing_zeros=mr.num_trailing_zeros,
                    secret=mr.secret,
                )
            )
            result_trace.record_action(
                act.PowlibMiningComplete(
                    nonce=mr.nonce,
                    num_trailing_zeros=mr.num_trailing_zeros,
                    secret=mr.secret,
                )
            )
            if not self._close_ev.is_set():
                self.notify_queue.put(mr)
        finally:
            with self._inflight_lock:
                self._inflight.discard(threading.current_thread())

    def close(self) -> None:
        self._close_ev.set()
        with self._inflight_lock:
            threads = list(self._inflight)
        for t in threads:
            t.join(timeout=5)
        with self._conn_lock:
            client, self.coordinator = self.coordinator, None
        if client is not None:
            client.close()
        with self._ring_lock:
            links, self._links = list(self._links.values()), {}
            self._ring = None
        for link in links:
            link.close()
        log.info("powlib closed")
