"""The batched, pipelined search driver (the worker's miner loop).

Replaces the reference worker's ``miner`` hot loop (worker.go:258-401):

* a kernel is uninterruptible, so the driver dispatches launches of up to
  ``launch_candidates`` candidates and checks ``cancel_check`` between
  them: cancellation latency is bounded by one launch;
* the chunk counter grows by appending bytes (worker.go:234-244), which
  changes the message length, so the driver runs one step per chunk
  width; within a width the candidates are a dense integer range and the
  step maps flat indices to candidates arithmetically; widths above 4
  bytes fix the high chunk bytes per segment;
* ``pipeline_depth`` launches stay in flight and drain FIFO, which keeps
  the returned first match in reference enumeration order.

On CUDA, reading a result with ``.item()`` would enqueue its copy behind
the launch after it on the same stream and serialize the pipeline.  So
each launch enqueues its kernel, a ``non_blocking`` copy of the result
into pinned host memory and an event; the drain waits on that event only.

A launch whose chunk range overruns ``256**w`` hashes candidates whose
``w``-byte chunk has a zero top byte.  They are valid secrets (any
solving secret is acceptable, coordinator.go:202), can only win when no
canonical candidate of the same launch solves, and every result is
re-verified with hashlib before it is returned.

Instruments, as in the reference driver: the ``search.*`` counters, the
``search.launch_s`` histogram and one ``search.launch`` span per drained
launch (time blocked on its result, under the thread's bound trace id),
the ``search.hashes_per_s`` gauge (``_RateMeter``), and the device-hang
watchdog: the whole search is an active section, with a beat between
launches and before each blocking fetch, and the first launch of each
width segment, which may build the kernels, runs under the first-compile
grace.

``persistent_search`` is the persistent loop, the counterpart of the
reference's (``distpow_tpu/parallel/search.py persistent_search``): the
same contract and first hits, but each dispatch (beyond the width-0
probe, which goes through the serial step) covers up to ``k`` segments and
stops about one segment after its own first hit, the drain polls the
head's event instead of blocking on it (``search.blocking_syncs`` stays
flat; the wait is ``search.poll_s`` and a ``search.poll`` span), and the
search's ``StopFlag`` is set on every exit, so that the dispatches still
in flight behind a hit or a cancel stop within a segment.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..models import puzzle
from ..models.registry import HashModel, get_hash_model
from ..ops.operands import Device, u32_value
from ..ops.search_step import SENTINEL, cached_persistent_step, cached_search_step
from ..runtime.metrics import REGISTRY, Metrics
from ..runtime.spans import SPANS
from ..runtime.watchdog import FIRST_COMPILE_GRACE_S, WATCHDOG
from .partition import contiguous_bounds

DEFAULT_BATCH = 1 << 20
DEFAULT_PIPELINE_DEPTH = 2
# The persistent drain's longest sleep between two polls of the head's
# event (the reference's DEFAULT_POLL_INTERVAL_S); the first sleep of a
# wait is POLL_FIRST_FRACTION of it, doubling up to it, so that a launch
# of microseconds is not read a whole interval late.
DEFAULT_POLL_INTERVAL_S = 0.001
POLL_FIRST_FRACTION = 1 / 16
# Candidates one dispatch should cover: enough device work to amortize
# the host round trip of fetching its result, few enough to keep
# cancellation and solve-time granularity short.
DEFAULT_LAUNCH_CANDIDATES = 1 << 30


def scaled_launch_candidates(cost_ops: int, reference_ops: int = 584) -> int:
    """Per-dispatch candidate budget scaled by the model's cost (md5 is
    the reference point), with a 2^24 floor."""
    return max(1 << 24,
               (DEFAULT_LAUNCH_CANDIDATES * reference_ops)
               // max(cost_ops, reference_ops))


def launch_steps_for(
    vw: int,
    sub_chunks: int,
    tbc: int,
    max_launch: int = DEFAULT_LAUNCH_CANDIDATES,
) -> int:
    """Launch multiplier (sub-batches per dispatch) for one width segment:
    bounded by the dispatch budget and by the width's canonical
    256-thread-byte candidate volume."""
    if vw == 0 or sub_chunks < 1:
        return 1
    sub_cand = sub_chunks * tbc
    seg_chunks = (1 << 32) if vw >= 4 else 256 ** vw - 256 ** (vw - 1)
    k_seg = -(-(seg_chunks * 256) // sub_cand)
    k_rtt = max_launch // sub_cand
    return max(1, min(k_rtt, k_seg))


def effective_batch(batch_size: int) -> int:
    """The batch rounded down to a multiple of 256 (at least 256), so
    ``chunks * tbc`` equals it for every power-of-two partition."""
    return max(256, batch_size - batch_size % 256)


# A step factory maps (variable_width, extra_const_chunk, target_chunks,
# launch_steps) to (step_fn, chunks_per_step): step_fn(chunk0) evaluates
# chunks_per_step * tb_count candidates from chunk0 and returns a 0-d
# tensor holding the first hit's flat index (chunk-major,
# thread-byte-minor) or SENTINEL.
StepFactory = Callable[[int, bytes, int, int], Tuple[Callable, int]]

# A persistent step factory maps (variable_width >= 1, extra_const_chunk,
# target_chunks, segments) to (step_fn, chunks_each, chunks_per_step):
# step_fn(chunk0, stop) runs up to ``segments`` segments of ``chunks_each *
# tb_count`` candidates from chunk0 (``chunks_per_step`` chunks in all),
# reads the StopFlag ``stop``, and returns a two-word tensor: the first
# hit's flat index (or SENTINEL) and the segments executed.
PersistentFactory = Callable[[int, bytes, int, int], Tuple[Callable, int, int]]


@dataclass
class SearchResult:
    secret: bytes
    thread_byte: int
    chunk: bytes
    hashes_tried: int


class _RateMeter:
    """Process-wide live throughput behind the ``search.hashes_per_s`` gauge.

    One meter for all searches: concurrent searches drain the same device,
    so the rate that means something is candidates drained per wall-clock
    interval across them.  An EMA over drain-to-drain windows; when the
    last active search exits, the gauge drops to 0."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._active = 0
        self._last_t: Optional[float] = None
        self._ema: Optional[float] = None

    def enter(self) -> None:
        with self._lock:
            self._active += 1

    def exit(self, metrics: Metrics) -> None:
        with self._lock:
            self._active -= 1
            if self._active <= 0:
                self._last_t = self._ema = None
                metrics.gauge("search.hashes_per_s", 0)

    def note(self, n_cand: int, metrics: Metrics) -> None:
        now = time.monotonic()
        with self._lock:
            prev, self._last_t = self._last_t, now
            if prev is None or now <= prev:
                return
            inst = n_cand / (now - prev)
            self._ema = inst if self._ema is None else 0.7 * self._ema + 0.3 * inst
            metrics.gauge("search.hashes_per_s", round(self._ema, 3))


_RATE_METER = _RateMeter()


def assemble_secret(
    chunk0: int, f: int, vw: int, extra: bytes, tb_lo: int, tbc: int
) -> Tuple[bytes, int]:
    """Host-side inverse of a launch's flat index: ``(secret, tb)``.  The
    width mask reproduces the overrun aliasing of the module docstring."""
    chunk_int = (chunk0 + f // tbc) & 0xFFFFFFFF
    tb = tb_lo + f % tbc
    chunk_bytes = (
        (chunk_int & (256 ** vw - 1)).to_bytes(vw, "little") if vw else b""
    ) + extra
    return bytes([tb]) + chunk_bytes, tb


def width_segments(width: int):
    """Yield (variable_width, chunk_lo, chunk_hi, extra_const_chunk) for
    one chunk width; beyond 4 bytes the high bytes are fixed per segment."""
    if width == 0:
        yield 0, 0, 1, b""
        return
    if width <= 4:
        yield width, 256 ** (width - 1), 256 ** width, b""
        return
    hi_w = width - 4
    for hi in range(256 ** (hi_w - 1), 256 ** hi_w):
        yield 4, 0, 1 << 32, hi.to_bytes(hi_w, "little")


def _unsatisfiable_wait(model: HashModel, difficulty: int, cancel_check,
                        max_hashes) -> None:
    """A difficulty above the digest's nibble count is unsatisfiable: wait
    on the cancel/budget gates without using the device, and raise when
    neither gate is given (the wait could never end)."""
    if cancel_check is None and max_hashes is None:
        raise ValueError(
            f"difficulty {difficulty} exceeds {model.name}'s "
            f"{model.max_difficulty} digest nibbles (unsatisfiable) "
            f"and no cancel_check/max_hashes gate was supplied; the "
            f"search could never return"
        )
    while True:
        if cancel_check is not None and cancel_check():
            return None
        if max_hashes is not None:
            return None
        time.sleep(0.01)


def default_step_factory(
    nonce: bytes,
    difficulty: int,
    tb_lo: int,
    tb_count: int,
    model: HashModel,
    device: Device = "cuda",
) -> StepFactory:
    """Factory over the plain PyTorch step on ``device``."""
    dev = str(torch.device(device))

    def factory(vw: int, extra: bytes, target_chunks: int, launch_steps: int = 1):
        chunks = max(1, target_chunks) if vw else 1
        k = launch_steps if vw else 1
        step = cached_search_step(
            bytes(nonce), vw, difficulty, tb_lo, tb_count,
            chunks, model.name, extra, k, dev,
        )
        return step, chunks * k

    return factory


def default_persistent_factory(
    nonce: bytes,
    difficulty: int,
    tb_lo: int,
    tb_count: int,
    model: HashModel,
    device: Device = "cuda",
) -> PersistentFactory:
    """Persistent factory over the plain persistent step on ``device``."""
    dev = torch.device(device)

    def factory(vw: int, extra: bytes, target_chunks: int, segments: int):
        chunks = max(1, target_chunks)
        bound = cached_persistent_step(bytes(nonce), vw, difficulty, tb_lo, tb_count, chunks,
                                       model.name, extra, segments, str(dev))
        return (lambda chunk0, stop: bound(chunk0, stop.operand(dev))), chunks, chunks * segments

    return factory


class StopFlag:
    """The persistent loop's stop flag (the reference's ``StopFlag``): one
    int32 word per device, which every persistent launch of the search on
    that device reads once a segment; ``set()`` writes 1 into each.

    A word is made at its first ``operand(device)``, holding 0 (1 once
    set), on the current stream, before the launches that read it.  On a
    card ``set()`` copies a pinned 1 into it on a side stream of its device
    (the copy engine, no SM), after the word's own fill and without waiting
    for the launches, so a launch in flight stops within a segment; the
    reference's flag reached only later dispatches, its buffers being
    immutable.  Each search takes its own flag, so a set flag is never
    reset under launches that still read it."""

    def __init__(self, set_: bool = False) -> None:
        self._lock = threading.Lock()
        self._set = set_
        # device -> (word, the event after its fill, on a card)
        self._words: dict = {}

    def is_set(self) -> bool:
        return self._set

    def operand(self, device: Device) -> torch.Tensor:
        """The flag's word on ``device`` (an explicit device)."""
        dev = torch.device(device)
        with self._lock:
            entry = self._words.get(dev)
            if entry is None:
                word = torch.full((1,), int(self._set), dtype=torch.int32, device=dev)
                filled = None
                if dev.type == "cuda":
                    filled = torch.cuda.Event()
                    filled.record(torch.cuda.current_stream(dev))
                entry = self._words[dev] = (word, filled)
            return entry[0]

    def set(self) -> None:
        with self._lock:
            if self._set:
                return
            self._set = True
            for word, filled in self._words.values():
                if filled is None:
                    word.fill_(1)
                    continue
                one = torch.ones(1, dtype=torch.int32, pin_memory=True)
                with torch.cuda.device(word.device):
                    side = torch.cuda.Stream(word.device)
                    side.wait_event(filled)
                    with torch.cuda.stream(side):
                        word.copy_(one, non_blocking=True)
                    word.record_stream(side)


def _enqueue_fetch(res: torch.Tensor):
    """Start moving a launch's result to the host without waiting.

    CUDA: a ``non_blocking`` copy into pinned memory and an event behind
    it, both on the current stream.  CPU: the result is already there."""
    if res.device.type != "cuda":
        return res, None
    host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
    host.copy_(res, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(res.device))
    return host, event


# One width segment's dispatch plan for ``_drive``: (launch(chunk0) ->
# result tensor, chunks_each, chunks_per_step, pair); ``pair`` results are
# the persistent step's two words (first hit, segments executed).
Plan = Tuple[Callable[[int], torch.Tensor], int, int, bool]


def _drive(nonce: bytes, difficulty: int, model: HashModel, tb_lo: int, tbc: int,
           batch_size: int, pipeline_depth: int, cancel_check, max_hashes, max_width: int,
           launch_candidates: int, metrics: Metrics,
           plan: Callable[[int, bytes, int, int], Plan],
           wait: Callable[[Optional[torch.cuda.Event], int], bool]) -> Optional[SearchResult]:
    """The loop both drivers share: per chunk width and segment, dispatch
    ``plan(vw, extra, target_chunks, k)``'s launches with ``pipeline_depth``
    of them in flight, drained FIFO (``wait(event, n_cand)`` until the
    head's result is on the host: True if the search was cancelled while
    waiting); ``cancel_check`` and ``max_hashes`` between dispatches; the
    first dispatch of each width segment under the first-compile grace;
    ``search.hashes`` counted on every exit path."""
    target_chunks = max(1, effective_batch(batch_size) // tbc)
    hashes = 0
    # FIFO of in-flight dispatches: (host_result, event, chunk0, vw, extra,
    # seg_chunks, chunks_each, pair); seg_chunks is the dispatch's chunks
    # within the segment (a dispatch may overshoot the segment end; the
    # overshot chunk ints alias already-covered candidates and are not
    # counted)
    inflight: deque = deque()

    def count(n_cand: int) -> None:
        nonlocal hashes
        hashes += n_cand
        metrics.inc("search.hashes", n_cand)

    def drain_one() -> Tuple[Optional[SearchResult], bool]:
        """Wait for the head, then read it: ``(found, cancelled)``."""
        host, event, chunk0, vw, extra, seg_chunks, chunks_each, pair = inflight.popleft()
        if wait(event, seg_chunks * tbc):
            count(seg_chunks * tbc)
            return None, True
        if pair:
            f, segs = u32_value(host[0]), u32_value(host[1])
            metrics.inc("search.persistent_steps", segs)
            n_cand = min(segs * chunks_each, seg_chunks) * tbc
        else:
            f, n_cand = u32_value(host), seg_chunks * tbc
        count(n_cand)
        _RATE_METER.note(n_cand, metrics)
        if f == SENTINEL:
            return None, False
        secret, tb = assemble_secret(chunk0, f, vw, extra, tb_lo, tbc)
        if not puzzle.check_secret(nonce, secret, difficulty, model.name):
            raise RuntimeError(
                f"kernel returned non-solving candidate tb={tb} "
                f"chunk={secret[1:].hex()} (kernel/oracle divergence)"
            )
        return SearchResult(secret=secret, thread_byte=tb, chunk=secret[1:],
                            hashes_tried=hashes), False

    def drain_all() -> Tuple[Optional[SearchResult], bool]:
        while inflight:
            found, cancelled = drain_one()
            if found is not None or cancelled:
                return found, cancelled
        return None, False

    def finish(found: Optional[SearchResult], cancelled: bool) -> Optional[SearchResult]:
        """Count the dispatches still in flight without waiting (one that
        a stop flag cut short counts whole: an upper bound), so that
        search.hashes equals dispatched work on every exit path, while
        hashes_tried stays the drained count."""
        while inflight:
            count(inflight.popleft()[5] * tbc)
        if cancelled:
            metrics.inc("search.cancelled")
            return None
        if found is not None:
            metrics.inc("search.found")
        return found

    _RATE_METER.enter()
    try:
        with WATCHDOG.active():
            for width in range(0, max_width + 1):
                for vw, lo, hi, extra in width_segments(width):
                    WATCHDOG.beat()  # the step's build may run nvcc below
                    k = launch_steps_for(vw, target_chunks, tbc, launch_candidates)
                    launch, chunks_each, chunks_per_step, pair = plan(vw, extra, target_chunks, k)
                    chunk0 = lo
                    while chunk0 < hi:
                        seg_chunks = min(chunks_per_step, hi - chunk0)
                        WATCHDOG.beat()
                        if cancel_check is not None and cancel_check():
                            return finish(None, True)
                        if max_hashes is not None and hashes >= max_hashes:
                            return finish(*drain_all())
                        if chunk0 == lo:
                            # a segment's first launch may build the kernels
                            # (nvcc at the first load of a library): one
                            # uninterruptible gap, under the compile grace
                            with WATCHDOG.grace(FIRST_COMPILE_GRACE_S):
                                res = launch(chunk0 & 0xFFFFFFFF)
                        else:
                            res = launch(chunk0 & 0xFFFFFFFF)
                        metrics.inc("search.launches")
                        inflight.append((*_enqueue_fetch(res), chunk0, vw, extra, seg_chunks,
                                         chunks_each, pair))
                        chunk0 += chunks_per_step
                        if len(inflight) >= pipeline_depth:
                            found, cancelled = drain_one()
                            if found is not None or cancelled:
                                return finish(found, cancelled)
                    found, cancelled = drain_all()
                    if found is not None or cancelled:
                        return finish(found, cancelled)
        return None
    finally:
        _RATE_METER.exit(metrics)


def _serial_plan(factory: StepFactory) -> Callable[[int, bytes, int, int], Plan]:
    def plan(vw: int, extra: bytes, target_chunks: int, k: int) -> Plan:
        step, chunks_per_step = factory(vw, extra, target_chunks, k)
        return step, chunks_per_step, chunks_per_step, False

    return plan


def search(
    nonce: bytes,
    difficulty: int,
    thread_bytes: Sequence[int],
    *,
    model: Optional[HashModel] = None,
    batch_size: int = DEFAULT_BATCH,
    pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
    cancel_check: Optional[Callable[[], bool]] = None,
    max_hashes: Optional[int] = None,
    max_width: int = 8,
    step_factory: Optional[StepFactory] = None,
    launch_candidates: Optional[int] = None,
    device: Device = "cuda",
    metrics: Metrics = REGISTRY,
) -> Optional[SearchResult]:
    """Find the first (reference-enumeration-order) solving secret.

    Returns None if cancelled or ``max_hashes`` is exhausted.
    ``step_factory`` overrides the launch builder (the CUDA backend plugs
    its kernel in here); the default is the plain step on ``device``.
    ``launch_candidates`` defaults to the model's cost-scaled budget.  The
    drain blocks on the head's event, the one place the host waits on the
    device (``search.blocking_syncs``, ``search.launch_s`` and a
    ``search.launch`` span).
    """
    model = model or get_hash_model("md5")
    if launch_candidates is None:
        launch_candidates = scaled_launch_candidates(model.cost_ops)
    nonce = bytes(nonce)
    tb_lo, tbc = contiguous_bounds(thread_bytes)
    if difficulty > model.max_difficulty:
        return _unsatisfiable_wait(model, difficulty, cancel_check, max_hashes)
    factory = step_factory or default_step_factory(
        nonce, difficulty, tb_lo, tbc, model, device
    )

    def block(event, n_cand: int) -> bool:
        WATCHDOG.beat()  # about to block on a launch's result
        metrics.inc("search.blocking_syncs")
        fetch_ts = time.time()
        t0 = time.monotonic()
        if event is not None:
            event.synchronize()
        fetch_s = time.monotonic() - t0
        metrics.observe("search.launch_s", fetch_s)
        if SPANS.enabled:
            SPANS.record("search.launch", fetch_ts, fetch_s, n_cand=n_cand)
        return False

    return _drive(nonce, difficulty, model, tb_lo, tbc, batch_size, pipeline_depth, cancel_check,
                  max_hashes, max_width, launch_candidates, metrics, _serial_plan(factory),
                  block)


def persistent_search(
    nonce: bytes,
    difficulty: int,
    thread_bytes: Sequence[int],
    *,
    model: Optional[HashModel] = None,
    batch_size: int = DEFAULT_BATCH,
    pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
    cancel_check: Optional[Callable[[], bool]] = None,
    max_hashes: Optional[int] = None,
    max_width: int = 8,
    step_factory: Optional[StepFactory] = None,
    persistent_factory: Optional[PersistentFactory] = None,
    step_builder: Optional[Callable] = None,
    launch_candidates: Optional[int] = None,
    poll_interval_s: float = DEFAULT_POLL_INTERVAL_S,
    device: Device = "cuda",
    metrics: Metrics = REGISTRY,
) -> Optional[SearchResult]:
    """The persistent loop: ``search``'s contract and first hit, in the
    reference's control flow (``distpow_tpu/parallel/search.py
    persistent_search``).

    * The width-0 probe goes through ``step_factory`` (the serial step);
      every other dispatch through ``step_builder(vw, extra, target_chunks,
      k)`` (the launch-lane hook, ``sched/lanes.py
      persistent_step_builder``) where it returns a plan, else through
      ``persistent_factory`` (the plain persistent step on ``device`` by
      default; the CUDA backends plug in the kernels' persistent form).
    * The drain polls the head's event (``torch.cuda.Event.query`` behind the
      pinned copy), sleeping up to ``poll_interval_s`` between polls, and
      never blocks; ``search.poll_s`` and a ``search.poll`` span record a
      wait, ``search.persistent_steps`` the segments each dispatch ran.
      No watchdog beat while waiting: a hung device leaves the event
      unready, and that staleness is what the watchdog must see.
    * A cancel seen while polling or between dispatches returns at once;
      every exit sets the search's ``StopFlag``.
    """
    model = model or get_hash_model("md5")
    if launch_candidates is None:
        launch_candidates = scaled_launch_candidates(model.cost_ops)
    nonce = bytes(nonce)
    tb_lo, tbc = contiguous_bounds(thread_bytes)
    if difficulty > model.max_difficulty:
        return _unsatisfiable_wait(model, difficulty, cancel_check, max_hashes)
    serial = _serial_plan(step_factory or default_step_factory(nonce, difficulty, tb_lo, tbc,
                                                               model, device))
    persistent = persistent_factory or default_persistent_factory(
        nonce, difficulty, tb_lo, tbc, model, device)
    stop = StopFlag()

    def plan(vw: int, extra: bytes, target_chunks: int, k: int) -> Plan:
        if vw == 0:
            return serial(0, extra, target_chunks, 1)
        built = step_builder(vw, extra, target_chunks, k) if step_builder is not None else None
        step, chunks_each, chunks_per_step = \
            built if built is not None else persistent(vw, extra, target_chunks, k)
        return (lambda chunk0: step(chunk0, stop)), chunks_each, chunks_per_step, True

    def poll(event, n_cand: int) -> bool:
        poll_ts, poll_t0 = time.time(), time.monotonic()
        waited, delay = False, poll_interval_s * POLL_FIRST_FRACTION
        while event is not None and not event.query():
            waited = True
            if cancel_check is not None and cancel_check():
                return True
            time.sleep(delay)
            delay = min(poll_interval_s, 2 * delay)
        if waited:
            poll_s = time.monotonic() - poll_t0
            metrics.observe("search.poll_s", poll_s)
            if SPANS.enabled:
                SPANS.record("search.poll", poll_ts, poll_s)
        return False

    try:
        return _drive(nonce, difficulty, model, tb_lo, tbc, batch_size, pipeline_depth,
                      cancel_check, max_hashes, max_width, launch_candidates, metrics, plan,
                      poll)
    finally:
        stop.set()
