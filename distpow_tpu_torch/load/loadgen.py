"""Seeded Poisson open-loop generator (package docstring; docs/SLO.md).

Two halves, split so tests can pin determinism without wall clocks:

* :func:`build_schedule` — pure: ``LoadMix`` -> the full arrival list
  (offsets, keys, nonces, difficulties, hash models), derived entirely
  from the mix's seed.  Same mix, same schedule, byte for byte.
* :class:`OpenLoopRunner` — executes a schedule against a submit
  callable on the wall clock WITHOUT waiting for completions: an
  arrival whose predecessors are still in flight fires anyway (that is
  what "open loop" means — a server falling behind faces the full
  offered rate, not a politely self-throttling client).  The runner
  never skips arrivals; when the submit path itself lags it fires late
  and records the lag, so a wedged cluster shows up as lag + missing
  completions, never as silently reduced load.

Key skew is Zipf (``P(key=k) ∝ 1/(k+1)^s``) over a bounded key
universe: with s ≈ 1 a handful of hot keys dominate — repeat Mines for
a hot key coalesce while in flight and hit the dominance cache after —
which is exactly the cache/coalesce regime heavy traffic depends on.
``zipf_s=0`` degrades to uniform.

The port's own copy of the reference's ``load/loadgen.py``: one seed
gives the reference's schedule, arrival for arrival.
"""

from __future__ import annotations

import hashlib
import random
import threading
import time
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from ..runtime.metrics import REGISTRY as metrics


@dataclass(frozen=True)
class LoadMix:
    """One traffic mix: rate, duration, skew, and blends.

    ``difficulties`` / ``hash_models`` are ``(value, weight)`` blends;
    weights need not sum to 1.  ``hash_model=None`` entries mean the
    cluster default model (requests then carry no ``hash_model`` param
    and stay wire-identical to plain traffic)."""

    rate_hz: float
    duration_s: float
    seed: int = 1
    n_keys: int = 64
    zipf_s: float = 1.1
    nonce_len: int = 4
    difficulties: Tuple[Tuple[int, float], ...] = ((2, 1.0),)
    hash_models: Tuple[Tuple[Optional[str], float], ...] = ((None, 1.0),)

    def __post_init__(self) -> None:
        if self.rate_hz <= 0 or self.duration_s <= 0:
            raise ValueError("rate_hz and duration_s must be positive")
        if self.n_keys < 1 or self.nonce_len < 1:
            raise ValueError("n_keys and nonce_len must be >= 1")
        for blend, what in ((self.difficulties, "difficulties"),
                            (self.hash_models, "hash_models")):
            if not blend or any(w <= 0 for _, w in blend):
                raise ValueError(f"{what} needs positive-weight entries")


@dataclass(frozen=True)
class Arrival:
    """One scheduled request."""

    t: float  # offset from schedule start, seconds
    key: int  # key-universe index (before skew, for diagnostics)
    nonce: bytes
    ntz: int
    hash_model: Optional[str] = None


def _cum_weights(blend: Sequence[Tuple[object, float]]) -> List[float]:
    total = 0.0
    out = []
    for _, w in blend:
        total += float(w)
        out.append(total)
    return out


def _zipf_cdf(n_keys: int, s: float) -> List[float]:
    total = 0.0
    out = []
    for k in range(n_keys):
        total += 1.0 / ((k + 1) ** s) if s > 0 else 1.0
        out.append(total)
    return out


def _pick(cdf: List[float], rng: random.Random) -> int:
    return bisect_left(cdf, rng.random() * cdf[-1])


def key_nonce(seed: int, key: int, nonce_len: int) -> bytes:
    """Deterministic per-key nonce: stable across runs of one seed (so
    repeat keys genuinely repeat — the cache/coalesce point) and
    disjoint across seeds (so two mixes cannot cross-hit each other's
    dominance-cache entries)."""
    digest = hashlib.sha256(f"loadgen:{seed}:{key}".encode()).digest()
    return digest[:nonce_len]


def build_schedule(mix: LoadMix) -> List[Arrival]:
    """The full, deterministic arrival list for ``mix`` (module
    docstring).  Inter-arrival gaps are exponential(rate) — a Poisson
    process — starting from the first gap, so the schedule models a
    steady stream joined mid-flow, not a thundering herd at t=0."""
    rng = random.Random(mix.seed)
    zipf = _zipf_cdf(mix.n_keys, mix.zipf_s)
    diff_cum = _cum_weights(mix.difficulties)
    model_cum = _cum_weights(mix.hash_models)
    out: List[Arrival] = []
    t = rng.expovariate(mix.rate_hz)
    while t < mix.duration_s:
        key = _pick(zipf, rng)
        ntz = mix.difficulties[_pick(diff_cum, rng)][0]
        model = mix.hash_models[_pick(model_cum, rng)][0]
        out.append(Arrival(
            t=round(t, 9), key=key,
            nonce=key_nonce(mix.seed, key, mix.nonce_len),
            ntz=int(ntz), hash_model=model,
        ))
        t += rng.expovariate(mix.rate_hz)
    return out


@dataclass
class LoadReport:
    """What the runner observed about its own dispatch (completions are
    the harness's side — see load/harness.py)."""

    issued: int = 0
    submit_errors: int = 0
    wall_s: float = 0.0
    offered_rate_hz: float = 0.0
    max_lag_s: float = 0.0  # worst (fire time - scheduled time)
    lag_sum_s: float = 0.0
    issued_by_key: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "issued": self.issued,
            "submit_errors": self.submit_errors,
            "wall_s": round(self.wall_s, 3),
            "offered_rate_hz": round(self.offered_rate_hz, 3),
            "max_lag_s": round(self.max_lag_s, 4),
            "mean_lag_s": round(
                self.lag_sum_s / max(1, self.issued), 4),
            "hot_key_share": round(
                max(self.issued_by_key.values(), default=0)
                / max(1, self.issued), 4),
        }


class OpenLoopRunner:
    """Fire a schedule at the wall clock, open-loop (module docstring).

    ``submit(arrival)`` must be non-blocking-cheap (powlib's
    ``client.mine`` enqueues and returns); a submit that raises is
    counted, logged into the report, and the schedule continues — load
    generation never dies mid-mix, or the SLO assertion would judge a
    cluster that only saw half the offered traffic."""

    def __init__(self, submit: Callable[[Arrival], None]):
        self._submit = submit
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self, schedule: Sequence[Arrival]) -> LoadReport:
        rep = LoadReport()
        t0 = time.monotonic()
        for arr in schedule:
            if self._stop.is_set():
                break
            delay = arr.t - (time.monotonic() - t0)
            if delay > 0 and self._stop.wait(delay):
                break
            lag = (time.monotonic() - t0) - arr.t
            try:
                self._submit(arr)
            except Exception:
                rep.submit_errors += 1
            rep.issued += 1
            rep.issued_by_key[arr.key] = rep.issued_by_key.get(arr.key, 0) + 1
            if lag > rep.max_lag_s:
                rep.max_lag_s = lag
            rep.lag_sum_s += max(0.0, lag)
            # declared histogram, not just the report: a
            # lagging generator silently converts open-loop into
            # closed-loop, so the lag distribution must be visible to
            # the scraper/soak verdict like any other series
            metrics.observe("load.lag_s", max(0.0, lag))
        rep.wall_s = time.monotonic() - t0
        rep.offered_rate_hz = rep.issued / rep.wall_s if rep.wall_s else 0.0
        return rep
