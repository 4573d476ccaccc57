"""Deterministic network fault-injection plane for the RPC runtime.

The reference system's resilience story (first-result-wins cancellation,
worker reassignment) was only ever chaos-tested with one fault: SIGKILL
a worker process (tests/test_stress.py).  Real networks produce a richer
menagerie — refused connections, delayed/duplicated/truncated/dropped
frames — and production-scale serving (ROADMAP north star) has to ride
all of them out.  This module injects exactly those faults at the two
chokepoints every byte of control-plane traffic passes through
(``runtime/rpc.py``: the client's frame send and the server's response
send), **deterministically**, so a chaos run that finds a bug is a
repro, not an anecdote.

Usage — a plan is a seed plus an ordered rule list::

    {"seed": 1234, "rules": [
      {"kind": "delay",    "method": "WorkerRPCHandler.*", "side": "client",
       "prob": 0.3, "delay_s": 0.05},
      {"kind": "truncate", "method": "CoordRPCHandler.Mine", "calls": "0:2"},
      {"kind": "refuse",   "peer": "*:20001", "max": 1}
    ]}

Installed process-globally via :func:`install` (tests), the
``DISTPOW_FAULTS`` environment variable (inline JSON or a file path),
the per-node ``FaultPlanFile`` config field, or the ``--faults`` CLI
flag.  When no plan is installed the production RPC paths pay exactly
one ``PLAN is None`` branch per frame.

Fault kinds and their injection sites:

* ``refuse``    — dial time (``RPCClient`` connect): the connection is
  refused before any byte moves.  ``method`` is matched against the
  pseudo-method ``"@connect"`` (so the default ``"*"`` matches).
* ``delay``     — sleep ``delay_s`` (or a seeded pick from
  ``delay_range``) before the frame is written; also applies at dial
  time.
* ``truncate``  — write a partial frame, then tear the connection down:
  the peer observes a mid-frame reset and every pending call on the
  connection fails with a transport error.
* ``duplicate`` — write the frame twice.  A duplicated request is
  dispatched twice by the server (exercising handler idempotence); a
  duplicated response is dropped by the client's id-keyed reader.
* ``drop``      — silently never write the frame.  The connection stays
  healthy, so only caller-side timeouts (the coordinator's bounded
  reassign-mode calls, powlib's ``MineAttemptTimeoutS``) can observe it.

Determinism contract: every decision is a pure function of
``(seed, rule_index, k)`` where ``k`` is the index of the call among
those MATCHING that rule (rules are evaluated in order; the first rule
that fires consumes the frame).  The PRNG is a hash, not a shared
stream, so concurrent callers cannot steal each other's draws — the
same seed replays the same fault for the k-th matching call no matter
how threads interleave.  (The *global* interleaving of injections
across different rules is only reproducible when the traffic itself is
sequential, as the determinism tests arrange.)

Observability: every injection increments ``faults.injected.<kind>``
(runtime/metrics.py, shipped by the Stats RPC) and appends a tuple to
``FaultPlan.injected`` for test assertions.  See docs/FAULTS.md.

Wire codecs: the per-frame hooks operate on the ENCODED frame, so every
kind behaves identically on wire v1 (JSON) and wire v2 (binary,
runtime/wire.py) — a truncated binary frame is a mid-frame reset, a
duplicated one re-dispatches, exactly as on JSON (tests/test_wire.py
chaos-on-binary).  The ``rpc.hello`` negotiation exchange itself is NOT
passed through ``on_frame`` — dial-window faults are modeled by the
``@connect`` pseudo-method, and a faulted hello would only ever degrade
to the JSON floor anyway (docs/RPC.md).

The port's own copy of the reference's ``runtime/faults.py``
(``distpow_tpu/runtime/faults.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .metrics import REGISTRY as metrics
from .telemetry import RECORDER

log = logging.getLogger("distpow.faults")

KINDS = ("refuse", "delay", "truncate", "duplicate", "drop")

#: pseudo-method rules are matched against at dial time
CONNECT = "@connect"


@dataclass
class FaultRule:
    """One match-and-inject rule; see the module docstring grammar."""

    kind: str
    method: str = "*"          # fnmatch glob over "Service.Method"
    side: str = "*"            # "client" | "server" | "*"
    peer: str = "*"            # fnmatch glob over "host:port"
    prob: float = 1.0          # injection probability per matching call
    calls: object = None       # None | "lo:hi" half-open | [indexes]
    max: Optional[int] = None  # cap on total injections by this rule
    delay_s: float = 0.05      # fixed delay (kind == "delay")
    delay_range: Optional[Sequence[float]] = None  # seeded uniform pick

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.side not in ("client", "server", "*"):
            raise ValueError(f"unknown side {self.side!r}")
        if not 0.0 <= float(self.prob) <= 1.0:
            raise ValueError(f"prob {self.prob!r} outside [0, 1]")

    def matches(self, side: str, method: str, peer: str) -> bool:
        return (
            (self.side == "*" or self.side == side)
            and fnmatch.fnmatchcase(method, self.method)
            and fnmatch.fnmatchcase(peer or "", self.peer)
        )

    def in_window(self, idx: int) -> bool:
        c = self.calls
        if c is None:
            return True
        if isinstance(c, str):
            lo, _, hi = c.partition(":")
            return int(lo or 0) <= idx and (not hi or idx < int(hi))
        return idx in c


class FaultPlan:
    """A seeded, ordered rule list consulted by the RPC runtime hooks."""

    def __init__(self, seed: int = 0, rules: Sequence = ()):
        self.seed = int(seed)
        self.rules = [
            r if isinstance(r, FaultRule) else FaultRule(**r) for r in rules
        ]
        self._counts = [0] * len(self.rules)  # matching calls seen, per rule
        self._fired = [0] * len(self.rules)   # injections done, per rule
        #: (rule_index, kind, side, method, matching_call_index) per
        #: injection, in injection order — the chaos tests' repro log
        self.injected: List[Tuple[int, str, str, str, int]] = []
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec) -> "FaultPlan":
        """Build from a dict, inline-JSON string, or JSON file path."""
        if isinstance(spec, str):
            s = spec.strip()
            if s.startswith("{"):
                spec = json.loads(s)
            else:
                with open(s) as fh:
                    spec = json.load(fh)
        return cls(seed=spec.get("seed", 0), rules=spec.get("rules", ()))

    # -- seeded decisions ---------------------------------------------------
    def _unit(self, rule_idx: int, call_idx: int, salt: str = "") -> float:
        """Uniform [0, 1) as a pure function of (seed, rule, call)."""
        h = hashlib.sha256(
            f"{self.seed}:{rule_idx}:{call_idx}:{salt}".encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    def _delay_of(self, rule: FaultRule, rule_idx: int, call_idx: int) -> float:
        if rule.delay_range:
            lo, hi = rule.delay_range
            return lo + (hi - lo) * self._unit(rule_idx, call_idx, "delay")
        return rule.delay_s

    def _decide(self, kinds, side: str, method: str,
                peer: str) -> Optional[Tuple[str, float]]:
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind not in kinds or not rule.matches(side, method, peer):
                    continue
                idx = self._counts[ri]
                self._counts[ri] += 1
                if not rule.in_window(idx):
                    continue
                if rule.max is not None and self._fired[ri] >= rule.max:
                    continue
                if rule.prob < 1.0 and self._unit(ri, idx) >= rule.prob:
                    continue
                self._fired[ri] += 1
                self.injected.append((ri, rule.kind, side, method, idx))
                metrics.inc(f"faults.injected.{rule.kind}")
                # the flight recorder is the chaos run's evidence trail:
                # a post-mortem dump carries exactly which faults hit
                # which frames, in order (runtime/telemetry.py)
                RECORDER.record("fault.injected", fault=rule.kind,
                                side=side, method=method, peer=peer,
                                rule=ri, call=idx)
                log.info("fault injected: %s %s %s peer=%s (rule %d, call %d)",
                         rule.kind, side, method, peer, ri, idx)
                return rule.kind, self._delay_of(rule, ri, idx)
        return None

    # -- runtime hooks (rpc.py) ---------------------------------------------
    def on_connect(self, peer: str) -> None:
        """Dial-time hook: may sleep (delay) or raise (refuse)."""
        hit = self._decide(("refuse", "delay"), "client", CONNECT, peer)
        if hit is None:
            return
        kind, delay = hit
        if kind == "delay":
            time.sleep(delay)
            return
        raise ConnectionRefusedError(
            f"fault injected: connection to {peer} refused"
        )

    def on_frame(self, side: str, method: str,
                 peer: str) -> Optional[Tuple[str, float]]:
        """Per-frame hook: returns ``(kind, delay)`` or None.  The caller
        (rpc.py) implements the frame-level mechanics for each kind."""
        return self._decide(
            ("delay", "truncate", "duplicate", "drop"), side, method, peer
        )


#: the process-global plan; None (production default) keeps the RPC hot
#: paths to a single branch
PLAN: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    global PLAN
    PLAN = plan
    if plan is not None:
        log.warning("fault-injection plan installed: seed=%d, %d rules",
                    plan.seed, len(plan.rules))
    return plan


def uninstall() -> None:
    install(None)


def install_from_spec(spec) -> FaultPlan:
    """Install a plan from a dict, inline JSON, or JSON file path."""
    return install(FaultPlan.from_spec(spec))


def _env_install() -> None:
    spec = os.environ.get("DISTPOW_FAULTS")
    if not spec:
        return
    try:
        install_from_spec(spec)
    except Exception as exc:  # a bad plan must not take the process down
        log.error("ignoring unusable DISTPOW_FAULTS plan: %s", exc)


_env_install()
