"""Seeded, pure time-varying rate schedules for the Poisson generator
(docs/SOAK.md "Shape catalog").

The constant-rate generator speaks one dialect: constant-rate Poisson.
Real fleets don't — the failure modes a soak must surface (queue growth
under a diurnal peak, cache-warmth collapse after a flash crowd, leak
slopes that only matter over hours) are properties of the rate's SHAPE
over time.  This module adds shapes without touching the generator's
contract:

* a :class:`RateShape` is a PURE function ``rate_hz(t) -> float`` over
  schedule-relative time, plus ``phases(duration_s)`` naming the
  windows a soak verdict judges separately;
* :func:`build_shaped_schedule` turns (shape, mix) into the same
  ``List[Arrival]`` the :class:`~.loadgen.OpenLoopRunner` already
  replays, via Lewis–Shedler thinning of a homogeneous Poisson process
  at the shape's peak rate — seeded through the mix's ``random.Random``
  exactly like :func:`~.loadgen.build_schedule`, so one seed gives one
  schedule byte for byte, and key/difficulty/model sampling reuses the
  generator's own helpers;
* :func:`compress` is the wall-clock knob: ``compress(shape, 320)``
  squeezes an 8-hour diurnal into 90 s by scaling time down and rate up
  by the same factor — expected arrivals per phase are preserved, so a
  CI soak exercises the same cache/coalesce regimes as the real thing,
  just faster.

Shapes compose by :class:`Sum` (diurnal + flash crowd is the canonical
soak), and every shape is immutable and stateless — determinism lives
entirely in the thinning RNG.

The port's own copy of the reference's ``load/shapes.py``.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .loadgen import (
    Arrival,
    LoadMix,
    _cum_weights,
    _pick,
    _zipf_cdf,
    key_nonce,
)

#: one named judgment window: (name, start_s, end_s)
Phase = Tuple[str, float, float]


class RateShape:
    """Base: a pure instantaneous-rate function over schedule time."""

    #: duration the shape naturally describes (seconds); schedules and
    #: phase lists default to it
    duration_s: float = 0.0

    def rate_hz(self, t: float) -> float:
        raise NotImplementedError

    def peak_hz(self) -> float:
        """A tight upper bound on ``rate_hz`` over the duration — the
        thinning envelope.  Subclasses with closed forms override;
        this fallback samples."""
        n = 1024
        return max(self.rate_hz(i * self.duration_s / n)
                   for i in range(n + 1))

    def phases(self, duration_s: Optional[float] = None) -> List[Phase]:
        """Named windows the soak verdict judges separately.  Default:
        the whole run as one phase."""
        d = self.duration_s if duration_s is None else duration_s
        return [("all", 0.0, d)]


@dataclass(frozen=True)
class Constant(RateShape):
    """The constant-rate generator's regime, as a shape."""

    rate: float
    duration_s: float = 60.0

    def rate_hz(self, t: float) -> float:
        return self.rate if 0.0 <= t < self.duration_s else 0.0

    def peak_hz(self) -> float:
        return self.rate


@dataclass(frozen=True)
class Diurnal(RateShape):
    """Sinusoidal day: ``base + amplitude * sin(2*pi*t/period)``,
    clamped at zero.  One period is one "day"; the default phases
    split it into rise / peak / fall / trough quarters."""

    base: float
    amplitude: float
    period_s: float
    duration_s: float = 0.0

    def __post_init__(self) -> None:
        if self.duration_s <= 0:
            object.__setattr__(self, "duration_s", self.period_s)

    def rate_hz(self, t: float) -> float:
        if not 0.0 <= t < self.duration_s:
            return 0.0
        return max(0.0, self.base + self.amplitude
                   * math.sin(2.0 * math.pi * t / self.period_s))

    def peak_hz(self) -> float:
        return max(0.0, self.base + max(0.0, self.amplitude))

    def phases(self, duration_s: Optional[float] = None) -> List[Phase]:
        d = self.duration_s if duration_s is None else duration_s
        names = ("rise", "peak", "fall", "trough")
        out: List[Phase] = []
        q = self.period_s / 4.0
        start, i = 0.0, 0
        while start < d:
            end = min(d, start + q)
            day, quarter = divmod(i, 4)
            tag = names[quarter] if d <= self.period_s else \
                f"day{day + 1}.{names[quarter]}"
            out.append((tag, start, end))
            start, i = end, i + 1
        return out


@dataclass(frozen=True)
class FlashCrowd(RateShape):
    """A spike: ``extra_hz`` added over ``[at_s, at_s + width_s)`` —
    zero elsewhere (sum it onto a baseline shape)."""

    extra_hz: float
    at_s: float
    width_s: float
    duration_s: float = 0.0

    def __post_init__(self) -> None:
        if self.duration_s <= 0:
            object.__setattr__(self, "duration_s", self.at_s + self.width_s)

    def rate_hz(self, t: float) -> float:
        return self.extra_hz if self.at_s <= t < self.at_s + self.width_s \
            else 0.0

    def peak_hz(self) -> float:
        return self.extra_hz

    def phases(self, duration_s: Optional[float] = None) -> List[Phase]:
        d = self.duration_s if duration_s is None else duration_s
        out: List[Phase] = []
        if self.at_s > 0:
            out.append(("before", 0.0, min(d, self.at_s)))
        if self.at_s < d:
            out.append(("spike", self.at_s, min(d, self.at_s + self.width_s)))
        if self.at_s + self.width_s < d:
            out.append(("after", self.at_s + self.width_s, d))
        return out


@dataclass(frozen=True)
class Ramp(RateShape):
    """Linear sweep from ``start_hz`` to ``end_hz`` across the
    duration — the capacity-probe shape."""

    start_hz: float
    end_hz: float
    duration_s: float

    def rate_hz(self, t: float) -> float:
        if not 0.0 <= t < self.duration_s:
            return 0.0
        frac = t / self.duration_s
        return max(0.0, self.start_hz + (self.end_hz - self.start_hz) * frac)

    def peak_hz(self) -> float:
        return max(self.start_hz, self.end_hz, 0.0)


@dataclass(frozen=True)
class Sum(RateShape):
    """Pointwise sum of shapes (superposed Poisson processes sum rates
    exactly).  Phases: the union of the parts' phase boundaries, so a
    flash crowd riding a diurnal is judged before/during/after the
    spike within each diurnal quarter it touches."""

    parts: Tuple[RateShape, ...]

    def __post_init__(self) -> None:
        if not self.parts:
            raise ValueError("Sum needs at least one part")
        object.__setattr__(self, "duration_s",
                           max(p.duration_s for p in self.parts))

    def rate_hz(self, t: float) -> float:
        return sum(p.rate_hz(t) for p in self.parts)

    def peak_hz(self) -> float:
        # conservative (rates are non-negative): a valid envelope even
        # when the parts peak at different instants
        return sum(p.peak_hz() for p in self.parts)

    def phases(self, duration_s: Optional[float] = None) -> List[Phase]:
        d = self.duration_s if duration_s is None else duration_s
        cuts = {0.0, d}
        for p in self.parts:
            for _, s, e in p.phases(d):
                cuts.update((min(s, d), min(e, d)))
        edges = sorted(cuts)
        out: List[Phase] = []
        for s, e in zip(edges, edges[1:]):
            if e <= s:
                continue
            mid = (s + e) / 2.0
            names = []
            for p in self.parts:
                for tag, ps, pe in p.phases(d):
                    if ps <= mid < pe:
                        names.append(tag)
                        break
            out.append(("+".join(names) or "all", s, e))
        return out


@dataclass(frozen=True)
class Compressed(RateShape):
    """The wall-clock knob: replay ``inner`` ``factor``-times faster.
    Time scales down, rate scales up by the same factor, so the
    EXPECTED ARRIVAL COUNT of every phase is preserved — an 8-hour
    diurnal compressed 320x runs in 90 s and still pushes the same
    number of requests through each quarter."""

    inner: RateShape
    factor: float

    def __post_init__(self) -> None:
        if self.factor <= 0:
            raise ValueError("compression factor must be positive")
        object.__setattr__(self, "duration_s",
                           self.inner.duration_s / self.factor)

    def rate_hz(self, t: float) -> float:
        return self.inner.rate_hz(t * self.factor) * self.factor

    def peak_hz(self) -> float:
        return self.inner.peak_hz() * self.factor

    def phases(self, duration_s: Optional[float] = None) -> List[Phase]:
        d = (self.inner.duration_s if duration_s is None
             else duration_s * self.factor)
        return [(name, s / self.factor, e / self.factor)
                for name, s, e in self.inner.phases(d)]


def compress(shape: RateShape, factor: float) -> RateShape:
    return Compressed(inner=shape, factor=factor)


def build_shaped_schedule(shape: RateShape, mix: LoadMix) -> List[Arrival]:
    """Arrivals for a time-varying rate, by Lewis–Shedler thinning:
    draw a homogeneous Poisson stream at the envelope ``peak_hz`` and
    keep each candidate ``t`` with probability ``rate_hz(t)/peak``.
    Pure and seeded — the mix's ``seed`` drives candidate times,
    thinning, and the key/difficulty/model draws (the generator's own
    samplers), so one (shape, mix) pair yields one schedule byte for
    byte.  The mix's ``rate_hz``/``duration_s`` are ignored in favor of
    the shape (the LoadMix validator requires them positive; pass any
    placeholder)."""
    peak = shape.peak_hz()
    if peak <= 0:
        return []
    rng = random.Random(mix.seed)
    zipf = _zipf_cdf(mix.n_keys, mix.zipf_s)
    diff_cum = _cum_weights(mix.difficulties)
    model_cum = _cum_weights(mix.hash_models)
    out: List[Arrival] = []
    t = rng.expovariate(peak)
    while t < shape.duration_s:
        if rng.random() * peak < shape.rate_hz(t):
            key = _pick(zipf, rng)
            ntz = mix.difficulties[_pick(diff_cum, rng)][0]
            model = mix.hash_models[_pick(model_cum, rng)][0]
            out.append(Arrival(
                t=round(t, 9), key=key,
                nonce=key_nonce(mix.seed, key, mix.nonce_len),
                ntz=int(ntz), hash_model=model,
            ))
        t += rng.expovariate(peak)
    return out
