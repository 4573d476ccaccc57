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
from ..ops.search_step import SENTINEL, cached_search_step
from ..runtime.metrics import REGISTRY, Metrics
from ..runtime.spans import SPANS
from ..runtime.watchdog import FIRST_COMPILE_GRACE_S, WATCHDOG
from .partition import contiguous_bounds

DEFAULT_BATCH = 1 << 20
DEFAULT_PIPELINE_DEPTH = 2
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
    ``launch_candidates`` defaults to the model's cost-scaled budget.
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
    target_chunks = max(1, effective_batch(batch_size) // tbc)

    hashes = 0
    # FIFO of in-flight launches: (host_result, event, chunk0, vw, extra, n_cand)
    inflight: deque = deque()

    def drain_one() -> Optional[SearchResult]:
        nonlocal hashes
        WATCHDOG.beat()  # about to block on a launch's result
        host, event, chunk0, vw, extra, n_cand = inflight.popleft()
        hashes += n_cand
        metrics.inc("search.hashes", n_cand)
        # the one place the host waits on the device
        metrics.inc("search.blocking_syncs")
        fetch_ts = time.time()
        t0 = time.monotonic()
        if event is not None:
            event.synchronize()
        f = u32_value(host)
        fetch_s = time.monotonic() - t0
        metrics.observe("search.launch_s", fetch_s)
        if SPANS.enabled:
            SPANS.record("search.launch", fetch_ts, fetch_s, n_cand=n_cand)
        _RATE_METER.note(n_cand, metrics)
        if f == SENTINEL:
            return None
        secret, tb = assemble_secret(chunk0, f, vw, extra, tb_lo, tbc)
        if not puzzle.check_secret(nonce, secret, difficulty, model.name):
            raise RuntimeError(
                f"kernel returned non-solving candidate tb={tb} "
                f"chunk={secret[1:].hex()} (kernel/oracle divergence)"
            )
        return SearchResult(secret=secret, thread_byte=tb, chunk=secret[1:],
                            hashes_tried=hashes)

    def drain_all() -> Optional[SearchResult]:
        while inflight:
            found = drain_one()
            if found is not None:
                return found
        return None

    def flush_inflight_counts() -> None:
        """Count launches still in flight at an early exit without waiting
        for them: search.hashes equals dispatched work on every exit path,
        while hashes_tried stays the drained count."""
        nonlocal hashes
        while inflight:
            *_, n = inflight.popleft()
            hashes += n
            metrics.inc("search.hashes", n)

    _RATE_METER.enter()
    try:
        with WATCHDOG.active():
            for width in range(0, max_width + 1):
                for vw, lo, hi, extra in width_segments(width):
                    WATCHDOG.beat()
                    k = launch_steps_for(vw, target_chunks, tbc, launch_candidates)
                    step, chunks_per_step = factory(vw, extra, target_chunks, k)
                    chunk0 = lo
                    while chunk0 < hi:
                        # a launch may overshoot the segment end; overshot
                        # chunk ints alias already-covered candidates and
                        # are not counted
                        n_cand = min(chunks_per_step, hi - chunk0) * tbc
                        WATCHDOG.beat()
                        if cancel_check is not None and cancel_check():
                            flush_inflight_counts()
                            metrics.inc("search.cancelled")
                            return None
                        if max_hashes is not None and hashes >= max_hashes:
                            found = drain_all()
                            flush_inflight_counts()
                            if found is not None:
                                metrics.inc("search.found")
                            return found
                        if chunk0 == lo:
                            # a segment's first launch may build the kernels
                            # (nvcc at the first load of a library): one
                            # uninterruptible gap, under the compile grace
                            with WATCHDOG.grace(FIRST_COMPILE_GRACE_S):
                                res = step(chunk0 & 0xFFFFFFFF)
                        else:
                            res = step(chunk0 & 0xFFFFFFFF)
                        metrics.inc("search.launches")
                        inflight.append((*_enqueue_fetch(res), chunk0, vw, extra, n_cand))
                        chunk0 += chunks_per_step
                        if len(inflight) >= pipeline_depth:
                            found = drain_one()
                            if found is not None:
                                flush_inflight_counts()
                                metrics.inc("search.found")
                                return found
                    found = drain_all()
                    if found is not None:
                        flush_inflight_counts()
                        metrics.inc("search.found")
                        return found
        return None
    finally:
        _RATE_METER.exit(metrics)
