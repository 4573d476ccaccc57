"""Long-haul soak harness: shaped load + chaos + retention + a typed
verdict (docs/SOAK.md).

``run_load_slo`` (harness.py) answers "does a 60-second constant-rate
burst meet the SLO?".  A soak answers *does the system hold for hours
without an operator watching?* — which needs four things the short
harness lacks, all built in this plane and assembled here:

1. **shaped load** — a :class:`~.shapes.RateShape` replayed through
   the open-loop runner (compressed diurnal + flash crowd is the
   canonical CI soak);
2. **retention** — every fleet sweep lands in a
   :class:`~..obs.timeseries.TimeSeriesStore` (optionally spooled to
   rotated JSONL for post-mortem replay), shared with the SLO engine so
   burn windows and phase judgments read the same points;
3. **sentinels** — the ``proc.*`` gauges the node Stats handlers
   export are trended by a :class:`~..runtime.health.LeakSentinel`
   over the whole run;
4. **a typed verdict** — :class:`SoakVerdict` fails when ANY of: some
   shape phase breaches its windowed SLO judgment, a leak suspect is
   flagged, ring-drop counters exceed their per-request budget, or the
   generator could not hold its schedule (``load.lag_s`` p99 over
   budget — a lagging generator silently converts open-loop into
   closed-loop and invalidates everything else).  ``exit_code()``
   follows the SLO CLI contract: 0 green, 1 failed; config errors
   raise :class:`~..obs.slo.SLOConfigError` and exit 2 at the CLI
   (cli/soak.py).

The registry caveat from harness.py applies unchanged: the judged view
scrapes the first coordinator only.  So does its device rule: with no
cluster given, ``run_soak`` boots an :class:`~.harness.InProcCluster`
on the card and raises without a GPU.

The port's own copy of the reference's ``load/soak.py``.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..obs.scrape import FleetScraper
from ..obs.slo import SLOEngine, load_slo_config
from ..obs.timeseries import DEFAULT_TIERS, TimeSeriesStore
from ..runtime import faults
from ..runtime.health import LeakSentinel
from ..runtime.metrics import REGISTRY as metrics
from ..runtime.telemetry import RECORDER
from .harness import InProcCluster, _CompletionTracker, exact_percentile
from .loadgen import Arrival, LoadMix, OpenLoopRunner
from .shapes import RateShape, build_shaped_schedule

#: ring-drop budgets, per issued request (plus a flat allowance): a
#: bounded ring dropping its oldest under sustained load is the design
#: working, an EXPLOSION is evidence loss worth failing on.
DEFAULT_RING_DROP_PER_REQUEST: Dict[str, float] = {
    "telemetry.dropped_events": 20.0,
    "spans.dropped": 200.0,
}
DEFAULT_RING_DROP_FLAT = 2000.0

#: leak-sentinel noise floors, in each gauge's own units (total rise
#: over the run below which a climb is noise, not a leak)
DEFAULT_LEAK_FLOORS: Dict[str, float] = {
    "proc.threads": 8.0,
    "proc.open_fds": 32.0,
    "proc.rss_bytes": 256.0 * 1024 * 1024,
}

DEFAULT_LAG_BUDGET_S = 1.0


@dataclass
class PhaseVerdict:
    """One shape phase's windowed SLO judgment."""

    name: str
    start_s: float
    end_s: float
    status: str
    objectives: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "start_s": round(self.start_s, 3),
            "end_s": round(self.end_s, 3),
            "status": self.status,
            "objectives": self.objectives,
        }


@dataclass
class SoakVerdict:
    """The soak contract (module docstring): green needs every phase
    SLO-clean, zero leak suspects, bounded ring drops, bounded
    generator lag."""

    status: str  # pass | warn | breach
    phases: List[PhaseVerdict]
    leak_suspects: List[dict]
    ring_drops: Dict[str, float]
    ring_drop_budgets: Dict[str, float]
    lag_p99_s: Optional[float]
    lag_budget_s: float
    failures: List[str] = field(default_factory=list)
    ts: float = 0.0

    def exit_code(self) -> int:
        return 1 if self.status == "breach" else 0

    def to_dict(self) -> dict:
        return {
            "status": self.status,
            "ts": self.ts,
            "failures": list(self.failures),
            "phases": [p.to_dict() for p in self.phases],
            "leak_suspects": list(self.leak_suspects),
            "ring_drops": dict(self.ring_drops),
            "ring_drop_budgets": {k: round(v, 1) for k, v
                                  in self.ring_drop_budgets.items()},
            "lag_p99_s": self.lag_p99_s,
            "lag_budget_s": self.lag_budget_s,
        }

    def render(self) -> str:
        out = [f"Soak verdict: {self.status.upper()}"]
        for p in self.phases:
            out.append(f"  phase {p.name:24s} "
                       f"[{p.start_s:7.1f}s..{p.end_s:7.1f}s]  "
                       f"{p.status.upper()}")
        for s in self.leak_suspects:
            out.append(f"  LEAK SUSPECT {s.get('gauge')}: "
                       f"+{s.get('rise'):.3g} over "
                       f"{s.get('window_s'):.1f}s "
                       f"({s.get('slope_per_s'):.3g}/s)")
        for name, n in sorted(self.ring_drops.items()):
            budget = self.ring_drop_budgets.get(name, 0.0)
            tag = "OVER" if n > budget else "ok"
            out.append(f"  ring drops {name}: {n:.0f} "
                       f"(budget {budget:.0f}) {tag}")
        lag = "-" if self.lag_p99_s is None else f"{self.lag_p99_s:.4f}s"
        out.append(f"  generator lag p99: {lag} "
                   f"(budget {self.lag_budget_s:.3f}s)")
        for f in self.failures:
            out.append(f"  FAIL: {f}")
        return "\n".join(out)


def run_soak(
    shape: RateShape,
    mix: LoadMix,
    slo_config,
    cluster: Optional[InProcCluster] = None,
    n_workers: int = 2,
    coord_extra: Optional[dict] = None,
    worker_extra: Optional[dict] = None,
    scrape_interval_s: float = 1.0,
    scrape_deadline_s: float = 2.0,
    drain_timeout_s: float = 60.0,
    fault_spec: Optional[dict] = None,
    store: Optional[TimeSeriesStore] = None,
    spool_path: Optional[str] = None,
    leak_window_s: Optional[float] = None,
    leak_floors: Optional[Dict[str, float]] = None,
    leak_gauges: Tuple[str, ...] = ("proc.threads", "proc.open_fds",
                                    "proc.rss_bytes"),
    ring_drop_per_request: Optional[Dict[str, float]] = None,
    lag_budget_s: float = DEFAULT_LAG_BUDGET_S,
) -> Tuple[dict, SoakVerdict]:
    """Replay ``shape`` against a cluster with retention + sentinels on;
    returns ``(report, verdict)`` (module docstring).

    The mix supplies seed/keys/difficulties; its ``rate_hz`` /
    ``duration_s`` are placeholders (the shape rules).  ``cluster=None``
    boots an :class:`~.harness.InProcCluster` on the card; pass an
    attached cluster object (``.client``, ``.scrape_targets()``) to soak
    real processes (cli/soak.py).  ``fault_spec`` installs a chaos plan
    for the duration."""
    config = slo_config if hasattr(slo_config, "objectives") \
        else load_slo_config(slo_config)
    own_cluster = cluster is None
    if own_cluster:
        cluster = InProcCluster(n_workers=n_workers,
                                coord_extra=coord_extra,
                                worker_extra=worker_extra)
    if store is None:
        store = TimeSeriesStore(tiers=DEFAULT_TIERS, spool_path=spool_path)
    engine = SLOEngine(config, store=store)
    scraper = FleetScraper(
        # judged view: first coordinator only (module docstring)
        cluster.scrape_targets(include_workers=False)[:1],
        deadline_s=scrape_deadline_s,
    )
    tracker = _CompletionTracker()
    stop_drain = threading.Event()
    stop_sweeps = threading.Event()
    prev_plan = faults.PLAN

    def drain() -> None:
        q = cluster.client.notify_queue
        while not stop_drain.is_set():
            try:
                res = q.get(timeout=0.05)
            except _queue.Empty:
                continue
            tracker.completed_one(res)

    def submit(arr: Arrival) -> None:
        tracker.issued(arr)
        cluster.client.mine(arr.nonce, arr.ntz, hash_model=arr.hash_model)

    def sweep_once() -> Optional[dict]:
        try:
            merged = scraper.sweep()
        except Exception:
            # one lost point, never the run — the final sweep gates
            return None
        store.append(merged)
        metrics.inc("soak.sweeps")
        return merged

    def sweep_loop() -> None:
        while not stop_sweeps.wait(scrape_interval_s):
            sweep_once()

    try:
        if fault_spec:
            faults.install_from_spec(fault_spec)
        schedule = build_shaped_schedule(shape, mix)
        baseline = sweep_once()
        drainer = threading.Thread(target=drain, daemon=True,
                                   name="soak-drain")
        drainer.start()
        sweeper = threading.Thread(target=sweep_loop, daemon=True,
                                   name="soak-sweeps")
        sweeper.start()
        runner = OpenLoopRunner(submit)
        # phase boundaries are schedule offsets; the store is keyed by
        # the scraper's wall-clock stamps, so anchor offsets at the
        # wall clock once (an instant, not a duration — durations below
        # ride the monotonic clock)
        t0_wall = time.time()
        t0 = time.monotonic()
        load_report = runner.run(schedule)
        deadline = time.monotonic() + drain_timeout_s
        expected = load_report.issued - load_report.submit_errors
        while (tracker.completed < expected
               and time.monotonic() < deadline):
            time.sleep(0.02)
        wall_total_s = time.monotonic() - t0
        stop_sweeps.set()
        sweeper.join(timeout=scrape_deadline_s + 1.0)
        final = sweep_once()
        stop_drain.set()
        drainer.join(timeout=2.0)
        end_wall = t0_wall + wall_total_s

        verdict = _judge(
            engine, store, shape, t0_wall, end_wall,
            issued=load_report.issued,
            leak_window_s=leak_window_s or wall_total_s + 1.0,
            leak_floors={**DEFAULT_LEAK_FLOORS, **(leak_floors or {})},
            leak_gauges=leak_gauges,
            ring_drop_per_request={**DEFAULT_RING_DROP_PER_REQUEST,
                                   **(ring_drop_per_request or {})},
            lag_budget_s=lag_budget_s,
        )
        solved = list(tracker.latencies_s)
        report = {
            "shape": repr(shape),
            "phases": [{"name": n, "start_s": round(s, 3),
                        "end_s": round(e, 3),
                        "arrivals": sum(1 for a in schedule
                                        if s <= a.t < e)}
                       for n, s, e in shape.phases()],
            "mix": {"seed": mix.seed, "n_keys": mix.n_keys,
                    "zipf_s": mix.zipf_s, "chaos": bool(fault_spec)},
            "load": load_report.to_dict(),
            "completed": tracker.completed,
            "request_errors": len(tracker.errors),
            "error_samples": tracker.errors[:3],
            "wall_total_s": round(wall_total_s, 3),
            "achieved_solves_per_s": round(
                tracker.completed / max(wall_total_s, 1e-9), 3),
            "client_latency_ms": {
                "n": len(solved),
                "p50": _ms(exact_percentile(solved, 0.50)),
                "p95": _ms(exact_percentile(solved, 0.95)),
            },
            "retention": {
                "points": len(store),
                "tiers": [{"resolution_s": t.resolution_s,
                           "retention_s": t.retention_s,
                           "points": len(store.tier_points(i))}
                          for i, t in enumerate(store.tiers)],
                "spool": spool_path,
            },
            "sweeps_ok": baseline is not None and final is not None,
            "verdict": verdict.to_dict(),
        }
        return report, verdict
    finally:
        if fault_spec:
            faults.install(prev_plan)
        stop_sweeps.set()
        stop_drain.set()
        scraper.close()
        if own_cluster:
            cluster.close()


def _judge(engine: SLOEngine, store: TimeSeriesStore, shape: RateShape,
           t0_wall: float, end_wall: float, issued: int,
           leak_window_s: float, leak_floors: Dict[str, float],
           leak_gauges: Tuple[str, ...],
           ring_drop_per_request: Dict[str, float],
           lag_budget_s: float) -> SoakVerdict:
    failures: List[str] = []

    # 1. every shape phase must hold the SLO over ITS window
    phases: List[PhaseVerdict] = []
    worst = "pass"
    for name, s, e in shape.phases():
        try:
            pv = engine.judge_range(t0_wall + s, min(t0_wall + e, end_wall))
            objectives = [o.to_dict() for o in pv.objectives]
            # phase status prefers the informative tie-break: a warm
            # dominance cache legitimately starves miss-series
            # objectives of samples mid-soak, and "no_data" must not
            # mask the objectives that DID judge the phase green
            statuses = {o.status for o in pv.objectives}
            for status in ("breach", "warn", "pass", "no_data"):
                if status in statuses:
                    break
            else:
                status = "no_data"
        except ValueError:
            status, objectives = "no_data", []
        phases.append(PhaseVerdict(name=name, start_s=s, end_s=e,
                                   status=status, objectives=objectives))
        if status == "breach":
            metrics.inc("soak.phase_breaches")
            failures.append(f"phase {name!r} breached its SLO window")
            worst = "breach"
        elif status == "warn" and worst == "pass":
            worst = "warn"

    # 2. zero leak suspects (runtime/health.py; the event/counter side
    # effects fire inside check())
    sentinel = LeakSentinel(window_s=leak_window_s)
    suspects = sentinel.check(store, gauges=list(leak_gauges),
                              noise_floors=leak_floors)
    for s in suspects:
        failures.append(
            f"leak suspect: gauge {s.gauge!r} climbed {s.rise:.3g} "
            f"({s.slope_per_s:.3g}/s over {s.window_s:.1f}s)")

    # 3. ring-drop counters bounded (per-request budgets + flat slack)
    run_window = store.range_window(t0_wall, end_wall) or {}
    counters = run_window.get("counters") or {}
    drops: Dict[str, float] = {}
    budgets: Dict[str, float] = {}
    for name, per_req in ring_drop_per_request.items():
        n = float(counters.get(name, 0))
        budget = per_req * max(0, issued) + DEFAULT_RING_DROP_FLAT
        drops[name] = n
        budgets[name] = budget
        if n > budget:
            failures.append(f"ring drops {name}: {n:.0f} over "
                            f"budget {budget:.0f}")

    # 4. the generator held its schedule (load.lag_s over the run)
    lag_hist = (run_window.get("histograms") or {}).get("load.lag_s")
    lag_p99 = (lag_hist or {}).get("p99")
    if lag_p99 is not None and lag_p99 > lag_budget_s:
        failures.append(f"open-loop lag p99 {lag_p99:.3f}s over "
                        f"budget {lag_budget_s:.3f}s — the generator "
                        f"could not hold its schedule")

    status = "breach" if failures else worst
    verdict = SoakVerdict(
        status=status, phases=phases,
        leak_suspects=[s.to_dict() for s in suspects],
        ring_drops=drops, ring_drop_budgets=budgets,
        lag_p99_s=lag_p99, lag_budget_s=lag_budget_s,
        failures=failures, ts=end_wall,
    )
    RECORDER.record("soak.verdict", status=status,
                    failures=list(failures),
                    phases=[(p.name, p.status) for p in phases])
    return verdict


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1e3, 3)
