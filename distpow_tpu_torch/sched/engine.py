"""Continuous-batching engine: many searches, one device loop.

The port of the reference's ``distpow_tpu/sched/engine.py``.  One loop
thread owns the device; each request becomes a *slot* in a table that the
loop packs into shared launches, one launch group per (hash model, tail
layout), all groups of a launch fetched with one host sync.

* **join**: ``submit()`` appends a slot to the run queue; the loop admits
  it at the next launch boundary.
* **run**: each iteration the loop takes the active slots in ``(vtime,
  seq)`` order, keeps one layout group per hash model, and launches them:
  per group the ``cuda`` lane's group kernel (``hash_group_search``), the
  ``mesh`` lane's group kernel on every shard of a mesh, or the ``torch``
  lane's plain step, one mixed step for all of a launch's torch groups
  (``sched/lanes.py``).  A slot's cursor moves by its lane's coverage
  (the mesh lane's is ``n_shards x mesh_span()`` batches).  Per-slot
  difficulty masks (every digest word), partitions and cursors are
  operands, so slots at any difficulty share a launch.
* **leave**: a hit (verified with hashlib), a cancel (polled at each
  boundary) or an exhausted enumeration finishes the slot.

Weighted-fair allocation as in the reference: a slot's virtual time
advances by ``candidates / weight`` per launch, a joining slot starts at the
smallest virtual time of the table (the floor), and when the table is full
the most-served active slot is preempted once it is a full quantum ahead of
the queue head.  Searches the packed step cannot express (a partition that
is not a power of two, an unsatisfiable difficulty, a model the engine does
not admit) go to ``_solo``.

On a CUDA device every CUDA call of the loop is made on the scheduler's
device and stream.  Each group's slot rows go up from pinned memory
without a wait (``group_operands``), each group kernel writes its slots'
results into device cells, each group's cells are copied ``non_blocking``
into one pinned host buffer, and one event is recorded and waited on: the
one host wait, and one ``search.blocking_syncs``, per engine launch.  A failing build or launch
raises; the loop dies, its slots finish with the error and
``sched.loop_failures`` counts it.  There is no demotion to the plain step.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..backends import TorchBackend
from ..backends.cuda_backend import CudaBackend, _require_device
from ..models import puzzle
from ..models.registry import get_hash_model
from ..ops.difficulty import nibble_masks
from ..ops.operands import MASK32, Device, GroupOperands, group_operands
from ..ops.packing import build_tail_spec
from ..ops.search_step import (SENTINEL, XLA_SERVING_COMPILE_IMPRACTICAL,
                               mixed_slot_search_step)
from ..parallel.mesh_search import Mesh
from ..parallel.partition import contiguous_bounds
from ..parallel.search import assemble_secret, effective_batch, width_segments
from ..runtime.metrics import REGISTRY, Metrics
from ..runtime.spans import SPANS
from ..runtime.telemetry import RECORDER
from ..runtime.watchdog import FIRST_COMPILE_GRACE_S, WATCHDOG
from .lanes import LanePlanner

log = logging.getLogger("distpow.sched")

# how often queued-slot cancels are honored while the device is idle
_IDLE_TICK_S = 0.02


class Slot:
    """One search's scheduler state.  ``done`` fires exactly once, with
    ``secret`` set (hit), ``secret=None`` (cancelled or exhausted), or
    ``error`` set (engine failure)."""

    __slots__ = (
        "seq", "nonce", "ntz", "tb_lo", "tbc", "log_tbc", "weight",
        "cancel_check", "masks", "done", "secret", "error", "vtime",
        "launches", "submitted_t", "first_launch_t", "exhausted",
        "_segments", "vw", "seg_hi", "extra", "spec", "chunk0",
        "_cancelled", "model", "span", "preemptions",
    )

    def __init__(self, seq: int, nonce: bytes, ntz: int, tb_lo: int, tbc: int,
                 cancel_check: Optional[Callable[[], bool]], weight: float,
                 masks: tuple, segments, model) -> None:
        self.model = model
        self.seq = seq
        self.nonce = nonce
        self.ntz = ntz
        self.tb_lo = tb_lo
        self.tbc = tbc
        self.log_tbc = tbc.bit_length() - 1
        self.weight = weight
        self.cancel_check = cancel_check
        self.masks = masks
        self.done = threading.Event()
        self.secret: Optional[bytes] = None
        self.error: Optional[str] = None
        self.vtime = 0.0
        self.launches = 0
        self.submitted_t = time.monotonic()
        self.first_launch_t: Optional[float] = None
        self.exhausted = False
        self._segments = segments
        self._cancelled = False
        self.vw = 0
        self.seg_hi = 0
        self.extra = b""
        self.spec = None
        self.chunk0 = 0
        self.span = None  # the sched.slot span, finished by _finish
        self.preemptions = 0

    def cancel(self) -> None:
        """Request cancellation; honored at the next launch boundary."""
        self._cancelled = True

    def cancel_requested(self) -> bool:
        if self._cancelled:
            return True
        if self.cancel_check is not None and self.cancel_check():
            self._cancelled = True
        return self._cancelled

    def result(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Block for the slot's outcome; raises on engine failure."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"slot {self.seq} not done in {timeout}s")
        if self.error is not None:
            raise RuntimeError(self.error)
        return self.secret


class BatchingScheduler:
    """Drop-in for ``backend.search`` that packs concurrent searches into
    shared launches (module docstring).

    ``device`` is where the loop launches (``"cuda"`` by default; without a
    GPU it raises unless ``device="cpu"``).  ``fallback`` is the solo
    backend (a port backend) for default-model shapes the packed step
    cannot express.  ``start=False`` defers the loop (tests submit a
    deterministic slot set first, then ``start``).  ``lane`` pins the lane
    (``WorkerConfig.SchedLane``: ``auto``, ``cuda``, ``mesh`` or ``torch``,
    or the reference's ``pallas`` and ``xla``; ``sched/lanes.py``), and
    ``mesh`` is the mesh lane's mesh (``parallel.mesh_search.make_mesh``;
    its first device is ``device``; default every visible GPU).
    """

    def __init__(self, hash_model: str = "md5", batch_size: int = 1 << 20,
                 max_slots: int = 8, max_width: int = 8, fallback: object = None,
                 start: bool = True, extra_models: Sequence[str] = (),
                 lane: str = "auto", device: Device = "cuda",
                 metrics: Metrics = REGISTRY, mesh: Optional[Mesh] = None) -> None:
        self.device = _require_device(device)
        self.model = get_hash_model(hash_model)
        # the default model and the configured extras; the models the
        # reference never admits to its packed step stay on the solo route
        self.models = {self.model.name: self.model}
        for name in extra_models:
            m = get_hash_model(name)
            if m.name not in XLA_SERVING_COMPILE_IMPRACTICAL:
                self.models[m.name] = m
        self.batch = effective_batch(batch_size)
        self.max_slots = max(1, int(max_slots))
        self.max_width = max_width
        self.fallback = fallback
        self.metrics = metrics
        self.planner = LanePlanner(override=lane, device=self.device, mesh=mesh)
        self.lane = self.planner.override
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._solo_backends: Dict[str, object] = {}
        self._cond = threading.Condition()
        self._pending: List[Slot] = []
        self._active: List[Slot] = []
        self._seq = 0
        self._stop = threading.Event()
        self._dead = False
        self._compiled: set = set()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="sched-batching-loop",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the loop; unfinished slots complete with ``None``."""
        self._stop.set()
        with self._cond:
            # refuse submissions racing with shutdown before draining
            self._dead = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        with self._cond:
            leftovers = self._pending + self._active
            self._pending = []
            self._active = []
            self._publish_gauges_locked()
        for s in leftovers:
            self._finish(s, None)

    # -- submission ---------------------------------------------------------
    def supports(self, difficulty: int, thread_bytes: Sequence[int],
                 hash_model: Optional[str] = None) -> bool:
        """True when the packed step can serve this shape: an admitted hash
        model, a contiguous power-of-two partition and a satisfiable
        difficulty."""
        model = self.models.get(hash_model or self.model.name)
        if model is None:
            return False
        try:
            _, tbc = contiguous_bounds(thread_bytes)
        except ValueError:
            return False
        return 0 < tbc <= 256 and tbc & (tbc - 1) == 0 and difficulty <= model.max_difficulty

    def submit(self, nonce: bytes, difficulty: int, thread_bytes: Sequence[int],
               cancel_check: Optional[Callable[[], bool]] = None, weight: float = 1.0,
               hash_model: Optional[str] = None) -> Slot:
        model = self.models[hash_model or self.model.name]
        nonce = bytes(nonce)
        tb_lo, tbc = contiguous_bounds(thread_bytes)
        masks = nibble_masks(difficulty, model)
        segments = self._segment_stream()
        with self._cond:
            if self._dead:
                raise RuntimeError("batching scheduler is closed or its device loop died")
            self._seq += 1
            slot = Slot(self._seq, nonce, difficulty, tb_lo, tbc, cancel_check, weight, masks,
                        segments, model)
            # the slot's whole scheduler life lands on the submitting thread's
            # trace; _finish is its one finish point
            slot.span = SPANS.begin("sched.slot", seq=slot.seq, model=model.name)
            # virtual-clock floor: a joining slot starts at the most-starved
            # slot's vtime, not 0, so fresh arrivals cannot starve a long one
            slot.vtime = min((s.vtime for s in self._active + self._pending), default=0.0)
            if not self._advance_segment(slot):
                raise RuntimeError("empty enumeration")  # unreachable
            self._pending.append(slot)
            self._publish_gauges_locked()
            self._cond.notify_all()
        return slot

    def _solo_backend(self, model):
        """The port backend that serves ``model``'s solo searches: the
        kernel (``cuda``), with the scheduler's lane as its persistent
        loop's override (the reference's ``persistent_step_builder(...,
        override=self.lane)``), or the plain step where the lane is
        ``torch``."""
        backend = self._solo_backends.get(model.name)
        if backend is None:
            kwargs = dict(hash_model=model.name, batch_size=self.batch, device=self.device,
                          metrics=self.metrics)
            backend = self._solo_backends[model.name] = (
                TorchBackend(**kwargs) if self.planner.default_lane == "torch"
                else CudaBackend(lane=self.lane, **kwargs))
        return backend

    def _solo(self, nonce: bytes, difficulty: int, thread_bytes,
              cancel_check: Optional[Callable[[], bool]],
              hash_model: Optional[str]) -> Optional[bytes]:
        """Route one search outside the packed step.

        Default-model shapes go to the wrapped fallback backend (it was built
        for that model).  Off-default models run the persistent loop
        (``persistent_search``, the backend's default ``loop``) with the
        requested model (``_solo_backend``), as the reference's do, except
        the models the reference never admits, which are refused as the
        reference refuses them."""
        if hash_model is None or hash_model == self.model.name:
            if self.fallback is None:
                raise ValueError(
                    f"unsupported search shape for the batching scheduler "
                    f"(difficulty={difficulty}) and no fallback backend")
            self.metrics.inc("sched.fallback_searches")
            return self.fallback.search(nonce, difficulty, thread_bytes,
                                        cancel_check=cancel_check)
        model = get_hash_model(hash_model)
        if model.name in XLA_SERVING_COMPILE_IMPRACTICAL:
            raise ValueError(
                f"hash model {model.name!r} is never admitted to the XLA serving path "
                f"(XLA_SERVING_COMPILE_IMPRACTICAL): serve it from a worker whose "
                f"configured model it is")
        self.metrics.inc("sched.fallback_searches")
        return self._solo_backend(model).search(nonce, difficulty, thread_bytes,
                                                cancel_check=cancel_check)

    def search(self, nonce: bytes, difficulty: int, thread_bytes,
               cancel_check: Optional[Callable[[], bool]] = None,
               hash_model: Optional[str] = None) -> Optional[bytes]:
        """Backend-compatible facade: first solving secret or None."""
        if self._dead or not self.supports(difficulty, thread_bytes, hash_model):
            return self._solo(nonce, difficulty, thread_bytes, cancel_check, hash_model)
        try:
            slot = self.submit(nonce, difficulty, thread_bytes, cancel_check=cancel_check,
                               hash_model=hash_model)
        except RuntimeError:
            # closed or died between the check and the append: serve solo
            if self.fallback is None and (hash_model is None or hash_model == self.model.name):
                raise
            return self._solo(nonce, difficulty, thread_bytes, cancel_check, hash_model)
        return slot.result()

    # -- cursor -------------------------------------------------------------
    def _segment_stream(self):
        for width in range(0, self.max_width + 1):
            yield from width_segments(width)

    def _advance_segment(self, slot: Slot) -> bool:
        """Move the slot to its next width segment; False = exhausted."""
        for vw, lo, hi, extra in slot._segments:
            slot.vw = vw
            slot.seg_hi = hi
            slot.extra = extra
            slot.chunk0 = lo
            slot.spec = build_tail_spec(slot.nonce, vw, slot.model, extra)
            return True
        return False

    @staticmethod
    def _group_key(slot: Slot) -> tuple:
        spec = slot.spec
        return (slot.model.name, spec.n_blocks, spec.tb_loc, spec.chunk_locs)

    # -- the device loop ----------------------------------------------------
    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                with self._cond:
                    self._reap_locked(self._active)
                    self._reap_locked(self._pending)
                    self._admit_locked()
                    group = self._pick_locked()
                    if group is None:
                        self._cond.wait(timeout=_IDLE_TICK_S)
                        continue
                self._launch(group)
        except Exception as exc:  # the loop must never die silently
            log.exception("batching scheduler device loop died: %s", exc)
            self.metrics.inc("sched.loop_failures")
            RECORDER.record("sched.loop_failure", error=str(exc))
            with self._cond:
                self._dead = True
                slots = self._pending + self._active
                self._pending = []
                self._active = []
                self._publish_gauges_locked()
            for s in slots:
                self._finish(s, None, error=f"scheduler loop died: {exc}")

    def _publish_gauges_locked(self) -> None:
        self.metrics.gauge("sched.active_slots", len(self._active))
        self.metrics.gauge("sched.run_queue_depth", len(self._pending))

    def _reap_locked(self, slots: List[Slot]) -> None:
        for s in list(slots):
            if s.cancel_requested():
                slots.remove(s)
                self.metrics.inc("search.cancelled")
                self._finish(s, None)
        self._publish_gauges_locked()

    def _admit_locked(self) -> None:
        self._pending.sort(key=lambda s: (s.vtime, s.seq))
        while self._pending and len(self._active) < self.max_slots:
            self._active.append(self._pending.pop(0))
        if self._pending and self._active:
            # oversubscribed: preempt the most-served active slot once it is
            # a full quantum ahead of the queue head, at most one a boundary
            head = self._pending[0]
            victim = max(self._active, key=lambda s: (s.vtime, s.seq))
            if victim.vtime >= head.vtime + self.batch / victim.weight:
                self._active.remove(victim)
                self._pending.append(victim)
                self._active.append(self._pending.pop(0))
                victim.preemptions += 1
                self.metrics.inc("sched.slots_preempted")
                RECORDER.record("sched.slot_preempt", slot=victim.seq, for_slot=head.seq,
                                vtime=round(victim.vtime, 1))
        self._publish_gauges_locked()

    def _pick_locked(self) -> Optional[List[Slot]]:
        if not self._active:
            return None
        cohort = sorted(self._active, key=lambda s: (s.vtime, s.seq))[: self.max_slots]
        # at most one layout group per model, led by the model's most-starved slot
        keep = {}
        for s in cohort:
            keep.setdefault(s.model.name, self._group_key(s))
        return [s for s in cohort if self._group_key(s) == keep[s.model.name]]

    def _on_device(self) -> contextlib.ExitStack:
        """The scheduler's device and stream as the current ones (CUDA)."""
        stack = contextlib.ExitStack()
        if self._stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _lane_ops(self, slots: List[Slot]) -> GroupOperands:
        """The group's slot rows, on the scheduler's device (one copy, no wait)."""
        return group_operands(
            [s.spec.init_state for s in slots],
            [s.spec.base_words for s in slots],
            [s.masks for s in slots],
            [s.tb_lo for s in slots],
            [s.log_tbc for s in slots],
            [s.chunk0 & MASK32 for s in slots],
            self.device,
        )

    def _fetch(self, pending: List[Tuple[int, torch.Tensor]], n_groups: int) -> List[list]:
        """Every group's first-hit vector on the host as uint32 ints, after
        one wait: device results are copied into one pinned buffer behind
        one event."""
        out: List[Optional[list]] = [None] * n_groups
        on_device = [(i, r) for i, r in pending if r.device.type == "cuda"]
        self.metrics.inc("search.blocking_syncs")
        if on_device:
            host = torch.empty(sum(r.numel() for _, r in on_device), dtype=torch.int32,
                               pin_memory=True)
            views, off = [], 0
            for i, r in on_device:
                view = host[off:off + r.numel()]
                view.copy_(r, non_blocking=True)
                views.append((i, view))
                off += r.numel()
            event = torch.cuda.Event()
            event.record(self._stream)
            event.synchronize()
            pending = [p for p in pending if p[1].device.type != "cuda"] + views
        for i, r in pending:
            out[i] = [v & MASK32 for v in r.tolist()]
        return out

    def _launch(self, group: List[Slot]) -> None:
        # one group per (model, layout); each group's slots share its launch
        by_key: dict = {}
        for s in group:
            by_key.setdefault(self._group_key(s), []).append(s)
        ordered = sorted(by_key.items(), key=lambda kv: kv[0])
        gdefs, gslots = [], []
        for (model_name, n_blocks, tb_loc, chunk_locs), slots in ordered:
            # the reference's power-of-two pad, kept in the planner's key
            n_pad = 1 << (len(slots) - 1).bit_length()
            gdefs.append((model_name, n_blocks, tb_loc, chunk_locs, n_pad))
            gslots.append(slots)
        resolved = [self.planner.resolve(gd, self.batch) for gd in gdefs]
        lanes_used = [lane for lane, _ in resolved]
        # candidates per slot per launch: the mesh lane's cover more
        coverages = [coverage for _, coverage in resolved]
        compile_key = (tuple(gdefs), tuple(lanes_used), self.batch)
        first_compile = compile_key not in self._compiled

        def run() -> List[list]:
            gops = [self._lane_ops(slots) for slots in gslots]
            pending: List[Tuple[int, torch.Tensor]] = []
            for i, lane in enumerate(lanes_used):
                if lane != "torch":
                    pending.append((i, self.planner.launch(lane, gdefs[i], gops[i], self.batch)))
            # every torch-lane group of the launch in one plain (mixed) step
            torch_idx = [i for i, lane in enumerate(lanes_used) if lane == "torch"]
            if torch_idx:
                step = mixed_slot_search_step(
                    [gdefs[i][:4] + (len(gslots[i]),) for i in torch_idx], self.batch)
                rows = [(gops[i].init, gops[i].base, gops[i].masks, gops[i].tb_lo,
                         gops[i].log_tbc, gops[i].chunk0) for i in torch_idx]
                pending.extend(zip(torch_idx, step(rows)))
            # one host sync for the whole launch, however many groups served it
            return self._fetch(pending, len(gdefs))

        now = time.monotonic()
        with WATCHDOG.active():
            WATCHDOG.beat()
            with self._on_device():
                if first_compile:
                    self._compiled.add(compile_key)
                    with WATCHDOG.grace(FIRST_COMPILE_GRACE_S):
                        res_groups = run()
                else:
                    res_groups = run()

        self.metrics.observe("sched.batch_occupancy", len(group))
        self.metrics.inc("sched.launches")
        for lane in lanes_used:
            self.metrics.inc(f"sched.lane_launches.{lane}")
        if len({d[0] for d in gdefs}) > 1:
            self.metrics.inc("sched.mixed_hash_launches")
        self.metrics.inc("search.hashes",
                         sum(len(sl) * c for sl, c in zip(gslots, coverages)))
        finished: List[Tuple[Slot, Optional[bytes]]] = []
        for slots, res, coverage in zip(gslots, res_groups, coverages):
            for s, f in zip(slots, res):
                s.launches += 1
                s.vtime += coverage / s.weight
                if s.first_launch_t is None:
                    s.first_launch_t = now
                    self.metrics.observe("sched.slot_wait_s", now - s.submitted_t)
                if f != SENTINEL:
                    secret, _ = assemble_secret(s.chunk0, f, s.vw, s.extra, s.tb_lo, s.tbc)
                    if not puzzle.check_secret(s.nonce, secret, s.ntz, s.model.name):
                        # kernel/oracle divergence: fail this slot, keep serving
                        finished.append((s, None))
                        s.error = (f"packed step returned non-solving candidate "
                                   f"{secret.hex()} (kernel/oracle divergence)")
                        continue
                    self.metrics.inc("search.found")
                    finished.append((s, secret))
                    continue
                s.chunk0 += coverage >> s.log_tbc
                if s.chunk0 >= s.seg_hi and not self._advance_segment(s):
                    s.exhausted = True
                    finished.append((s, None))
        with self._cond:
            for s, _ in finished:
                if s in self._active:
                    self._active.remove(s)
            self._publish_gauges_locked()
        for s, secret in finished:
            self._finish(s, secret, error=s.error)

    def _finish(self, slot: Slot, secret: Optional[bytes], error: Optional[str] = None) -> None:
        slot.secret = secret
        slot.error = error
        if slot.span is not None:
            slot.span.finish(launches=slot.launches, preemptions=slot.preemptions,
                             outcome=("found" if secret is not None
                                      else "error" if error else "no-result"))
        slot.done.set()

