"""Declarative SLO engine over merged cluster snapshots (docs/SLO.md).

Objectives live in a checked-in JSON config (config/slo.json) and are
evaluated against the cluster snapshots the fleet scraper merges
(:mod:`.scrape` / :mod:`.merge`).  Three things distinguish this from a
shell script grepping ``--prom`` output:

* **typed verdicts** — every objective yields an
  :class:`ObjectiveVerdict` (pass / warn / breach / no_data with the
  observed value, threshold, and window evidence) rolled into one
  :class:`SLOVerdict` whose ``exit_code()`` is the CI contract: breach
  is nonzero, everything else is 0;
* **burn-rate windows** — objectives are judged over a FAST and a SLOW
  window (bucket-wise histogram deltas / counter deltas between merged
  snapshots): breach requires both windows over threshold (a sustained
  burn), fast-only is a warn (a spike), slow-only is a recovering warn.
  With too little history — the one-shot CI evaluation — both windows
  degrade to all-time cumulative, so a single sweep can still gate;
* **unknown-metric rejection** — every series named in the config is
  validated against the declared registries in ``runtime/metrics.py``
  (``KNOWN_HISTOGRAMS``/``KNOWN_COUNTERS`` + prefixes) at LOAD time.
  A typo'd objective is a config error (exit 2), never a silently
  green gate.

On breach the engine records one ``slo.breach`` flight-recorder event
per breached objective and dumps the whole ring — metrics snapshot,
verdict, (when a telemetry journal is configured) the critical-path
breakdown of the slowest recent rounds (:mod:`.trace_profile`), and the
top-k slowest request timelines as full span trees (runtime/spans.py,
docs/FORENSICS.md) — so the evidence for *why* the objective burned is
captured by construction.

Per-model objectives (``"per_model": true``) expand over the
``worker.solve_s.<model>`` histogram family (nodes/worker.py), because
per-hash performance spread is exactly why one global serving target
would be meaningless.

The port's own copy of the reference's ``obs/slo.py``; the critical-path
profiler is the package's own :mod:`.trace_profile`, where the reference
loads ``scripts/trace_profile.py`` from the repo root by path.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..runtime.metrics import (
    KNOWN_COUNTER_PREFIXES,
    KNOWN_COUNTERS,
    KNOWN_HISTOGRAM_PREFIXES,
    KNOWN_HISTOGRAMS,
)
from ..runtime.metrics import REGISTRY as metrics
from ..runtime.spans import SPANS
from ..runtime.telemetry import RECORDER
from . import trace_profile
from .merge import PER_MODEL_HISTOGRAM_PREFIX
from .timeseries import Tier, TimeSeriesStore

_STATS = ("p50", "p95", "p99", "mean")
_STATUS_RANK = {"pass": 0, "no_data": 0, "warn": 1, "breach": 2}

DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 300.0


class SLOConfigError(ValueError):
    """Malformed or unknown-metric SLO config — the gate must fail
    loudly at load time, not evaluate green against a series that can
    never exist."""


def _known_histogram(name: str) -> bool:
    return name in KNOWN_HISTOGRAMS or any(
        name.startswith(p) and len(name) > len(p)
        for p in KNOWN_HISTOGRAM_PREFIXES
    )


def _known_counter(name: str) -> bool:
    return name in KNOWN_COUNTERS or any(
        name.startswith(p) and len(name) > len(p)
        for p in KNOWN_COUNTER_PREFIXES
    )


@dataclass(frozen=True)
class Objective:
    """One declared objective (see docs/SLO.md for the JSON schema)."""

    name: str
    max: float
    histogram: Optional[str] = None
    stat: str = "p95"
    ratio: Optional[Tuple[str, str]] = None  # (numerator, denominator)
    per_model: bool = False
    models: Dict[str, float] = field(default_factory=dict)
    description: str = ""


@dataclass(frozen=True)
class SLOConfig:
    objectives: Tuple[Objective, ...]
    fast_window_s: float = DEFAULT_FAST_WINDOW_S
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S
    source: str = "<dict>"


def load_slo_config(src) -> SLOConfig:
    """Parse and VALIDATE an SLO config (path or already-loaded dict).

    Raises :class:`SLOConfigError` on any malformed objective or any
    metric name the registry declarations don't know."""
    source = "<dict>"
    if isinstance(src, (str, os.PathLike)):
        source = str(src)
        try:
            with open(src) as fh:
                src = json.load(fh)
        except (OSError, ValueError) as exc:
            raise SLOConfigError(f"unreadable SLO config {source}: {exc}")
    if not isinstance(src, dict):
        raise SLOConfigError(f"SLO config must be a JSON object, "
                             f"got {type(src).__name__}")
    windows = src.get("windows") or {}
    fast = float(windows.get("fast_s", DEFAULT_FAST_WINDOW_S))
    slow = float(windows.get("slow_s", DEFAULT_SLOW_WINDOW_S))
    if not (0 < fast <= slow):
        raise SLOConfigError(
            f"windows must satisfy 0 < fast_s <= slow_s "
            f"(got fast_s={fast}, slow_s={slow})")
    raw = src.get("objectives")
    if not isinstance(raw, list) or not raw:
        raise SLOConfigError("SLO config needs a non-empty 'objectives' list")
    objectives: List[Objective] = []
    seen = set()
    for i, o in enumerate(raw):
        where = f"objective[{i}]"
        if not isinstance(o, dict):
            raise SLOConfigError(f"{where} must be an object")
        name = o.get("name")
        if not name or not isinstance(name, str):
            raise SLOConfigError(f"{where} needs a string 'name'")
        where = f"objective {name!r}"
        if name in seen:
            raise SLOConfigError(f"duplicate objective name {name!r}")
        seen.add(name)
        try:
            mx = float(o["max"])
        except (KeyError, TypeError, ValueError):
            raise SLOConfigError(f"{where} needs a numeric 'max' threshold")
        if mx <= 0:
            raise SLOConfigError(f"{where}: 'max' must be positive")
        hist = o.get("histogram")
        ratio = o.get("ratio")
        if (hist is None) == (ratio is None):
            raise SLOConfigError(
                f"{where} needs exactly one of 'histogram' or 'ratio'")
        stat = o.get("stat", "p95")
        per_model = bool(o.get("per_model", False))
        models = {str(k): float(v) for k, v in (o.get("models") or {}).items()}
        if hist is not None:
            if stat not in _STATS:
                raise SLOConfigError(
                    f"{where}: unknown stat {stat!r} (one of {_STATS})")
            if not _known_histogram(hist):
                raise SLOConfigError(
                    f"{where}: unknown histogram {hist!r} — not declared in "
                    f"runtime/metrics.py KNOWN_HISTOGRAMS/_PREFIXES")
            if per_model:
                base = PER_MODEL_HISTOGRAM_PREFIX.rstrip(".")
                if hist != base:
                    raise SLOConfigError(
                        f"{where}: per_model applies to the {base!r} family "
                        f"only (got {hist!r})")
                for m in models:
                    if not _known_histogram(f"{hist}.{m}"):
                        raise SLOConfigError(
                            f"{where}: per-model series {hist}.{m!r} matches "
                            f"no declared histogram family")
            elif models:
                raise SLOConfigError(
                    f"{where}: 'models' requires 'per_model': true")
            obj = Objective(name=name, max=mx, histogram=hist, stat=stat,
                            per_model=per_model, models=models,
                            description=str(o.get("description", "")))
        else:
            if not (isinstance(ratio, dict)
                    and isinstance(ratio.get("num"), str)
                    and isinstance(ratio.get("den"), str)):
                raise SLOConfigError(
                    f"{where}: 'ratio' must be "
                    f'{{"num": counter, "den": counter}}')
            for part in (ratio["num"], ratio["den"]):
                if not _known_counter(part):
                    raise SLOConfigError(
                        f"{where}: unknown counter {part!r} — not declared "
                        f"in runtime/metrics.py KNOWN_COUNTERS/_PREFIXES")
            if per_model or models:
                raise SLOConfigError(f"{where}: per_model is histogram-only")
            obj = Objective(name=name, max=mx,
                            ratio=(ratio["num"], ratio["den"]),
                            description=str(o.get("description", "")))
        objectives.append(obj)
    return SLOConfig(objectives=tuple(objectives), fast_window_s=fast,
                     slow_window_s=slow, source=source)


@dataclass
class ObjectiveVerdict:
    name: str
    status: str  # pass | warn | breach | no_data
    value: Optional[float]  # fast-window observation
    threshold: float
    slow_value: Optional[float] = None
    series: str = ""
    model: Optional[str] = None
    fast_window_s: float = 0.0
    slow_window_s: float = 0.0
    burn: Optional[float] = None  # value / threshold
    detail: str = ""

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if v not in (None, "")}
        d["status"] = self.status
        return d


@dataclass
class SLOVerdict:
    status: str
    objectives: List[ObjectiveVerdict]
    ts: float
    stale_nodes: List[str] = field(default_factory=list)
    dump_path: Optional[str] = None

    def exit_code(self) -> int:
        """The CI contract: 0 unless some objective breached."""
        return 1 if self.status == "breach" else 0

    def to_dict(self) -> dict:
        return {
            "status": self.status,
            "ts": self.ts,
            "stale_nodes": list(self.stale_nodes),
            "dump_path": self.dump_path,
            "objectives": [o.to_dict() for o in self.objectives],
        }

    def render(self) -> str:
        """Human one-screen verdict."""
        out = [f"SLO verdict: {self.status.upper()}"
               + (f"  (stale: {', '.join(self.stale_nodes)})"
                  if self.stale_nodes else "")]
        for o in self.objectives:
            tag = o.name if o.model is None else f"{o.name}[{o.model}]"
            val = "-" if o.value is None else f"{o.value:.4g}"
            burn = "" if o.burn is None else f"  burn={o.burn:.2f}x"
            extra = f"  ({o.detail})" if o.detail else ""
            out.append(f"  {o.status.upper():7s} {tag:32s} "
                       f"{val} vs max {o.threshold:.4g}{burn}{extra}")
        return "\n".join(out)


def _hist_stat(h: Optional[dict], stat: str) -> Optional[float]:
    if not h or not h.get("count"):
        return None
    if stat == "mean":
        return float(h.get("sum", 0.0)) / max(1, int(h["count"]))
    return h.get(stat)


class SLOEngine:
    """Evaluate a :class:`SLOConfig` over retained merged snapshots.

    Feed every sweep through :meth:`observe` (or pass it straight to
    :meth:`evaluate`); history lives in a
    :class:`~.timeseries.TimeSeriesStore` (pass your own
    ``store`` to share retention with a soak harness — the engine's
    burn windows and the soak verdict's phase windows then read the
    SAME points) and the fast/slow windows are the store's windowed
    delta queries.  ``ts`` parameters exist for deterministic tests —
    production callers omit them."""

    def __init__(self, config: SLOConfig, history: int = 512,
                 journal_path: Optional[str] = None,
                 span_addrs: Optional[List[str]] = None,
                 store: Optional[TimeSeriesStore] = None):
        self.config = config
        # a private store sized to the burn windows when none is shared:
        # full resolution across the slow window (plus slack), coarse
        # beyond — `history` survives as the finest tier's point cap
        # proxy via retention, so existing constructors keep working
        self.store = store if store is not None else TimeSeriesStore(
            tiers=(
                Tier(0.0, max(2 * config.slow_window_s, 600.0)),
                Tier(10.0, 3600.0),
            ))
        self._journal_path = journal_path
        # where to fetch slow-request span trees from when THIS process
        # has no local ring evidence (the cli/slo.py gate judging a
        # separate-process cluster): the scraped fleet's addresses, for
        # a Node.Spans sweep on breach (docs/FORENSICS.md)
        self._span_addrs = list(span_addrs or [])

    # -- history ------------------------------------------------------------
    def observe(self, merged: dict, ts: Optional[float] = None) -> None:
        self.store.append(merged, ts if ts is not None else time.time())

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, merged: Optional[dict] = None,
                 ts: Optional[float] = None,
                 breach_hooks: bool = True) -> SLOVerdict:
        """Judge every objective against the latest merged snapshot.

        ``merged`` (if given) is observed first.  ``breach_hooks=False``
        suppresses the flight-recorder side effects (the load harness's
        mid-run peeks must not dump on a transient warm-up spike)."""
        if merged is not None:
            self.observe(merged, ts)
        latest = self.store.latest()
        if latest is None:
            raise ValueError("no merged snapshot to evaluate")
        metrics.inc("slo.evaluations")
        now = latest[0]
        fast = self.store.window(self.config.fast_window_s, now) or latest[1]
        slow = self.store.window(self.config.slow_window_s, now) or latest[1]
        verdict = self._judge_windows(fast, slow, now,
                                      latest[1].get("stale_nodes") or [])
        if verdict.status == "breach" and breach_hooks:
            self._on_breach(verdict)
        return verdict

    def judge_range(self, start_ts: float, end_ts: float) -> SLOVerdict:
        """Judge every objective over ONE historical window — the delta
        between the retained snapshots at ``end_ts`` and ``start_ts``
        (both resolved by the store's snapshot_at contract).  Fast and
        slow collapse to the same window: a phase is judged as a whole,
        not as a burn rate.  No breach side effects — the soak verdict
        (load/soak.py) aggregates these per shape phase and carries its
        own evidence hooks."""
        win = self.store.range_window(start_ts, end_ts)
        if win is None:
            raise ValueError("no retained snapshot inside the range")
        return self._judge_windows(win, win, end_ts,
                                   win.get("stale_nodes") or [])

    def _judge_windows(self, fast: dict, slow: dict, now: float,
                       stale_nodes) -> SLOVerdict:
        verdicts: List[ObjectiveVerdict] = []
        for obj in self.config.objectives:
            verdicts.extend(self._judge(obj, fast, slow))
        status = max((v.status for v in verdicts),
                     key=lambda s: _STATUS_RANK[s], default="pass")
        return SLOVerdict(status=status, objectives=verdicts, ts=now,
                          stale_nodes=list(stale_nodes))

    def _judge(self, obj: Objective, fast: dict,
               slow: dict) -> List[ObjectiveVerdict]:
        if obj.ratio is not None:
            return [self._judge_ratio(obj, fast, slow)]
        if not obj.per_model:
            return [self._judge_hist(obj, fast, slow, obj.histogram or "",
                                     obj.max, None)]
        out = []
        prefix = PER_MODEL_HISTOGRAM_PREFIX
        seen = {
            name[len(prefix):]
            for name in (fast.get("histograms") or {})
            if name.startswith(prefix)
        }
        for model in sorted(seen | set(obj.models)):
            out.append(self._judge_hist(
                obj, fast, slow, f"{obj.histogram}.{model}",
                obj.models.get(model, obj.max), model,
            ))
        if not out:
            out.append(ObjectiveVerdict(
                name=obj.name, status="no_data", value=None,
                threshold=obj.max, series=f"{obj.histogram}.*",
                detail="no per-model series observed yet",
            ))
        return out

    def _verdict(self, obj: Objective, series: str, threshold: float,
                 v_fast: Optional[float], v_slow: Optional[float],
                 model: Optional[str], fast: dict, slow: dict,
                 detail: str = "") -> ObjectiveVerdict:
        if v_fast is None and v_slow is None:
            status = "no_data"
        else:
            over_fast = v_fast is not None and v_fast > threshold
            over_slow = v_slow is not None and v_slow > threshold
            if over_fast and over_slow:
                status = "breach"
            elif over_fast:
                status, detail = "warn", detail or "fast-window spike"
            elif over_slow:
                status, detail = "warn", detail or "recovering (slow window)"
            else:
                status = "pass"
        ref = v_fast if v_fast is not None else v_slow
        return ObjectiveVerdict(
            name=obj.name, status=status, value=v_fast, slow_value=v_slow,
            threshold=threshold, series=series, model=model,
            fast_window_s=float(fast.get("window_s") or 0.0),
            slow_window_s=float(slow.get("window_s") or 0.0),
            burn=None if ref is None else round(ref / threshold, 4),
            detail=detail,
        )

    def _judge_hist(self, obj: Objective, fast: dict, slow: dict,
                    series: str, threshold: float,
                    model: Optional[str]) -> ObjectiveVerdict:
        v_fast = _hist_stat((fast.get("histograms") or {}).get(series),
                            obj.stat)
        v_slow = _hist_stat((slow.get("histograms") or {}).get(series),
                            obj.stat)
        return self._verdict(obj, f"{series}:{obj.stat}", threshold,
                             v_fast, v_slow, model, fast, slow)

    def _judge_ratio(self, obj: Objective, fast: dict,
                     slow: dict) -> ObjectiveVerdict:
        num, den = obj.ratio  # type: ignore[misc]

        def rate(win: dict) -> Optional[float]:
            c = win.get("counters") or {}
            d = float(c.get(den, 0))
            return None if d <= 0 else float(c.get(num, 0)) / d
        return self._verdict(obj, f"{num}/{den}", obj.max,
                             rate(fast), rate(slow), None, fast, slow)

    # -- breach side effects ------------------------------------------------
    def _on_breach(self, verdict: SLOVerdict) -> None:
        """Flight-recorder evidence (module docstring): one event per
        breached objective, then one dump carrying the verdict plus the
        trace_profile critical-path breakdown when a telemetry journal
        exists.  Dumping is best-effort — with no dump directory
        configured the events still land in the in-memory ring."""
        metrics.inc("slo.breaches")
        for o in verdict.objectives:
            if o.status != "breach":
                continue
            RECORDER.record(
                "slo.breach", objective=o.name, series=o.series,
                model=o.model, value=o.value, slow_value=o.slow_value,
                threshold=o.threshold, burn=o.burn,
                fast_window_s=o.fast_window_s, slow_window_s=o.slow_window_s,
            )
        extra = {"verdict": verdict.to_dict()}
        profile = self._critical_path()
        if profile is not None:
            extra["critical_path"] = profile
        # the forensics evidence (docs/FORENSICS.md): the dump
        # attaches the top-k slowest REQUEST timelines — full span
        # trees, not just round milestones — so "which request burned
        # the objective, and where inside it" is in the evidence file
        # by construction.  In-process harnesses read the shared local
        # ring; the production gate process (cli/slo.py observing a
        # separate-process cluster) has an EMPTY local ring and sweeps
        # the scraped fleet's Node.Spans instead — best-effort, like
        # every other evidence hook (a breach verdict must never crash
        # on its own evidence collection).
        slow = SPANS.slowest_traces(5)
        if not slow and self._span_addrs:
            try:
                from .forensics import slowest_request_timelines

                slow = slowest_request_timelines(self._span_addrs, k=5)
            except Exception:
                slow = []
        if slow:
            extra["slow_requests"] = slow
        verdict.dump_path = RECORDER.dump("slo-breach", extra=extra)

    def _critical_path(self, top_n: int = 5) -> Optional[list]:
        """Per-request queue->fanout->first-result->cancel breakdown of
        the slowest recent Mines, from the flight-recorder journal via
        :mod:`.trace_profile` (best-effort: None when no journal is
        configured)."""
        path = self._journal_path or getattr(RECORDER, "_journal_path", None)
        if not path:
            return None
        try:
            RECORDER.flush_journal()  # the breach-window events must be in
            if not os.path.exists(path):
                return None
            reqs = trace_profile.profile_journal(path)
            # slowest rounds first: cancel-complete spans the whole
            # round when present, first-result otherwise
            reqs.sort(key=lambda r: -(r.get("cancel_propagation_s")
                                      or r.get("first_result_s") or 0.0))
            return reqs[:top_n]
        except Exception:
            # evidence collection must never turn a breach verdict into
            # a crash — the verdict (and the ring events) already stand
            return None
