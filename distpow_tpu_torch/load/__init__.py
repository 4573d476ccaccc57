"""Open-loop load harness (docs/SLO.md, docs/SOAK.md).

A traffic source that behaves like users, not like a benchmark loop:
OPEN-LOOP arrivals (requests fire on a seeded Poisson schedule
regardless of how many are still in flight — a slow server faces a
growing backlog, exactly like production) with Zipf-skewed keys (so the
dominance cache and the coalescer see the repeat traffic they were
built for), blended difficulties, and optional fault-plane chaos.

* :mod:`.loadgen`  — the seeded schedule builder + open-loop runner
  (deterministic: one seed, one schedule — replayable in CI);
* :mod:`.harness`  — an in-process cluster wired to the fleet scraper
  and SLO engine (``obs/``): run a mix, scrape the nodes, assert the
  objectives.  Its workers serve on the card unless the caller asks for
  the CPU;
* :mod:`.shapes`   — seeded, pure time-varying rate schedules
  (docs/SOAK.md): diurnal sinusoid, flash crowd, linear ramp,
  composable sums, and a wall-clock compression knob so an 8-hour
  diurnal replays in CI minutes;
* :mod:`.soak`     — the long-haul soak harness: shaped load + chaos +
  time-series retention + leak sentinels, ending in a typed
  :class:`~.soak.SoakVerdict` with the 0/1/2 exit-code contract.
  ``python -m distpow_tpu_torch.cli.soak`` is a thin wrapper over this.

The port's own copy of the reference's ``load/`` package.  Importing it
imports no ``torch``: the in-process cluster loads the worker when it
boots one.
"""

from .loadgen import Arrival, LoadMix, OpenLoopRunner, build_schedule
from .harness import (
    InProcCluster,
    exact_percentile,
    percentile_within_one_bucket,
    run_load_slo,
)
from .shapes import (
    Compressed,
    Constant,
    Diurnal,
    FlashCrowd,
    Ramp,
    RateShape,
    Sum,
    build_shaped_schedule,
    compress,
)
from .soak import PhaseVerdict, SoakVerdict, run_soak

__all__ = [
    "Arrival",
    "LoadMix",
    "OpenLoopRunner",
    "build_schedule",
    "InProcCluster",
    "exact_percentile",
    "percentile_within_one_bucket",
    "run_load_slo",
    "RateShape",
    "Constant",
    "Diurnal",
    "FlashCrowd",
    "Ramp",
    "Sum",
    "Compressed",
    "compress",
    "build_shaped_schedule",
    "PhaseVerdict",
    "SoakVerdict",
    "run_soak",
]
