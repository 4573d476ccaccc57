"""The device timeline and the spans' export (``runtime/spans.py``,
``parallel/search.py``, ``nodes/worker.py``) and what the benchmark reads of
them (``portbench/spantrace.py``).

* The driver with the switch on, on the CPU with stand-in timing events: one
  ``search.device_s`` a drained launch, one ``search.past_hit_s`` a launch
  left in flight (resolved later, never waited for), a ``search.enqueue``
  span a launch; with the switch off none of it is written.
* ``SpanRecorder.since`` reads every span once across a ring overflow, a
  reader sees what the ring overwrote before it came as a gap in the
  sequence numbers, and ``spans.dropped`` counts every overwrite; a
  profiler recording in the process leaves the switch off.
* ``worker.cancel_s`` starts at the Found, not at the Mine; a Mine under
  the switch leaves a ``worker.mine_start`` span that ends at its first
  launch.
* The clock anchor on CPU torch; ``idle_by_span`` and the idle time in a
  search on synthetic events (every idle second is given out once; the
  idle time in a search is at most the idle time); an in-process worker
  serving concurrent Mines under the profiler, the switch and a span
  reader, on the CPU.
* On the card (marker ``card``): the same at md5's difficulty 8 with four
  Mines at a time: the driver's timed device time against the profiler's
  kernel time, no span lost to the reader, the anchor's offset, the idle
  time's labels.

This file imports no JAX: on the chip run it alone, ``python3 -m pytest
--noconftest -p no:cacheprovider tests/test_torch_device_timeline.py -m
card``.
"""

import queue
import random
import threading
import time

import pytest
import torch

from distpow_tpu_torch.backends import get_backend
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.nodes.worker import WorkerRPCHandler
from distpow_tpu_torch.ops import hash_cuda
from distpow_tpu_torch.parallel import search as port_search
from distpow_tpu_torch.runtime.metrics import REGISTRY, Metrics
from distpow_tpu_torch.runtime.spans import SPANS, SpanRecorder
from distpow_tpu_torch.runtime.tracing import MemorySink, Tracer, wire_token
from portbench import spantrace
from portbench.profile import merged, split_events

NONCE, FULL = b"\x01\x02\x03\x04", list(range(256))
MD5 = get_hash_model("md5")
ELAPSED_MS = 2.0


class _Event:
    """A timing event's stand-in on the CPU: complete unless the class's
    ``pending`` is set, ``ELAPSED_MS`` from any start."""

    pending = False

    def record(self, stream=None):
        pass

    def query(self):
        return not type(self).pending

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        assert end.query()
        return ELAPSED_MS


@pytest.fixture
def timeline(monkeypatch):
    """The driver's CUDA timing on the CPU with ``_Event``s; yields a
    function that turns the switch on or off."""
    monkeypatch.setattr(_Event, "pending", False)
    monkeypatch.setattr(port_search, "_timed", lambda device: True)
    monkeypatch.setattr(port_search, "_timed_launch",
                        lambda launch, chunk0, card: (launch(chunk0), (_Event(), _Event())))
    monkeypatch.setattr(port_search, "_enqueue_fetch", lambda res: (res, _Event()))
    monkeypatch.setattr(port_search, "_PAST_HIT", port_search._PastHit())
    yield lambda on: SPANS.configure(device_timing=on)
    SPANS.configure(device_timing=False)


def _drive(driver, m, cancel_check=None, difficulty=4):
    return driver(NONCE, difficulty, FULL, model=MD5, batch_size=1 << 10,
                  launch_candidates=1 << 12, device="cpu", metrics=m, cancel_check=cancel_check)


def _new_spans(seq0):
    return SPANS.recent()[-(SPANS.total_recorded - seq0):] if SPANS.total_recorded > seq0 else []


@pytest.mark.parametrize("driver", [port_search.search, port_search.persistent_search])
def test_the_switch_times_each_drained_launch_and_each_left_in_flight(timeline, driver):
    timeline(True)
    m, seq0 = Metrics(), SPANS.total_recorded
    want = _drive(driver, Metrics())
    got = _drive(driver, m)
    assert got.secret == want.secret
    launches = m.get("search.launches")
    drained = m.get_observed("search.device_s")
    assert drained["count"] >= 1 and drained["sum"] == pytest.approx(drained["count"] * 2e-3)
    # the launches in flight when the search returned are pending until their end
    # events complete, then observed once each
    left = launches - drained["count"]
    assert len(port_search._PAST_HIT._pending) == left
    _Event.pending = True
    port_search.resolve_past_hit()
    assert m.get_observed("search.past_hit_s")["count"] == 0
    _Event.pending = False
    port_search.resolve_past_hit()
    port_search.resolve_past_hit()
    assert m.get_observed("search.past_hit_s")["count"] == left
    assert not port_search._PAST_HIT._pending
    if SPANS.enabled:
        enqueues = [s for s in _new_spans(seq0) if s["name"] == "search.enqueue"]
        assert len(enqueues) == 2 * launches  # both searches
        assert enqueues[0]["attrs"] == {"vw": 0}  # the width-0 probe first


def test_a_cancelled_search_leaves_its_launches_to_the_past_hit(timeline):
    timeline(True)
    m, calls = Metrics(), []

    def cancel():
        calls.append(1)
        return len(calls) > 5

    assert _drive(port_search.persistent_search, m, cancel, difficulty=7) is None
    port_search.resolve_past_hit()
    assert m.get("search.cancelled") == 1
    assert m.get_observed("search.device_s")["count"] + \
        m.get_observed("search.past_hit_s")["count"] == m.get("search.launches")
    assert m.get_observed("search.past_hit_s")["count"] >= 1


@pytest.mark.parametrize("driver", [port_search.search, port_search.persistent_search])
def test_with_the_switch_off_nothing_new_is_written(timeline, driver, monkeypatch):
    timeline(False)
    starts = []
    monkeypatch.setattr(port_search, "_timed_launch",
                        lambda launch, chunk0, card: starts.append(card))
    m, seq0 = Metrics(), SPANS.total_recorded
    assert _drive(driver, m) is not None
    snap = m.snapshot()
    assert not {"search.device_s", "search.past_hit_s"} & set(snap["histograms"])
    assert not starts and not port_search._PAST_HIT._pending
    assert "search.enqueue" not in {s["name"] for s in _new_spans(seq0)}


def test_only_configure_turns_the_switch_on():
    from torch.profiler import ProfilerActivity, profile

    assert not SPANS.device_timing
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert not SPANS.device_timing  # a profiler in the process is not the switch
    finally:
        prof.stop()
    SPANS.configure(device_timing=True)
    try:
        assert SPANS.device_timing
    finally:
        SPANS.configure(device_timing=False)
    assert not SPANS.device_timing


def test_since_reads_every_span_once_across_a_ring_overflow():
    rec = SpanRecorder(capacity=8)
    rec.configure(enabled=True)
    dropped0 = REGISTRY.get("spans.dropped")
    seq, got = 0, []
    for i in range(50):
        rec.record("s", float(i), 0.0, trace_id=i + 1)
        if i % 5 == 4:  # a reader that keeps up: five new spans a read
            batch = rec.since(seq)
            seq = batch[-1]["seq"]
            got += batch
    assert [s["trace_id"] for s in got] == list(range(1, 51))
    assert rec.since(seq) == []
    # spans.dropped counts every overwrite, read or not: the ring's 42 here
    assert REGISTRY.get("spans.dropped") == dropped0 + 42
    for i in range(20):  # nobody reads: the ring overwrites 12 unread spans
        rec.record("s", 0.0, 0.0, trace_id=100 + i)
    assert REGISTRY.get("spans.dropped") == dropped0 + 62
    late = rec.since(seq)
    # the reader sees its own loss as the gap between its seq and the first it gets
    assert seq == 50 and [s["seq"] for s in late] == list(range(63, 71))


def _handler(**backend):
    return WorkerRPCHandler(Tracer("worker1", MemorySink()), queue.Queue(),
                            get_backend("cuda", hash_model="md5", device="cpu", **backend),
                            device="cpu")


def _params(nonce, ntz, **extra):
    token = wire_token(Tracer("client", MemorySink()).create_trace().generate_token())
    return {"nonce": nonce, "num_trailing_zeros": ntz, "worker_byte": 0, "worker_bits": 0,
            "token": token, **extra}


def _take(q, n, timeout=60.0):
    deadline, out = time.monotonic() + timeout, []
    while len(out) < n:
        out.append(q.get(timeout=max(0.1, deadline - time.monotonic())))
    return out


def test_cancel_time_starts_at_the_found_not_at_the_mine():
    handler = _handler(batch_size=1 << 10, max_launch=1 << 12)
    before = REGISTRY.get_observed("worker.cancel_s")
    seq0 = SPANS.total_recorded
    delay = 0.5
    nonce = b"\x09\x08\x07\x06"
    handler.Mine(_params(nonce, 12))  # never solves in the test's time
    time.sleep(delay)
    # an off-default hash model keeps the secret out of the cache, so the Found
    # alone stops the search
    handler.Found(_params(nonce, 12, secret=b"\x00", hash_model="sha1"))
    acks = _take(handler.result_queue, 2)
    assert all(a["secret"] is None for a in acks)
    after = REGISTRY.get_observed("worker.cancel_s")
    assert after["count"] == before["count"] + 1
    observed = after["sum"] - before["sum"]
    assert 0.0 <= observed < delay
    if SPANS.enabled:
        cancels = [s for s in _new_spans(seq0) if s["name"] == "worker.cancel"]
        assert len(cancels) == 1 and cancels[0]["dur_s"] == pytest.approx(observed, abs=1e-5)


def test_a_mine_under_the_switch_opens_its_start_until_the_first_launch(timeline):
    if not SPANS.enabled:
        pytest.skip("span recording is off (DISTPOW_SPANS=0)")
    timeline(True)
    handler = _handler(batch_size=1 << 10, max_launch=1 << 12, loop="persistent")
    seq0 = SPANS.total_recorded
    handler.Mine(_params(NONCE, 3))
    result = _take(handler.result_queue, 1)[0]
    assert result["secret"] is not None
    handler.Found(_params(NONCE, 3, secret=result["secret"]))
    _take(handler.result_queue, 1)
    spans = _new_spans(seq0)
    starts = [s for s in spans if s["name"] == "worker.mine_start"]
    enqueues = sorted(s["ts"] for s in spans if s["name"] == "search.enqueue")
    assert len(starts) == 1 and enqueues
    start = starts[0]
    assert start["ts"] + start["dur_s"] <= enqueues[0] + 1e-5
    assert start["trace_id"] == spans[-1]["trace_id"] != 0


# -- the benchmark's reduction -------------------------------------------------

MS = 1_000_000  # ns


def test_idle_by_span_gives_each_idle_stretch_its_innermost_span():
    device = [("k", 0, 10 * MS), ("k", 20 * MS, 10 * MS), ("k", 50 * MS, 10 * MS)]
    spans = [("worker.solve", 5 * MS, 70 * MS, 1), ("search.poll", 22 * MS, 40 * MS, 1),
             ("search.enqueue", 41 * MS, 45 * MS, 1), ("worker.mine_start", 80 * MS, 90 * MS, 2)]
    gaps = spantrace.idle_gaps(device, 0, 100 * MS)
    assert gaps == [(10 * MS, 20 * MS), (30 * MS, 50 * MS), (60 * MS, 100 * MS)]
    idle = spantrace.idle_by_span(gaps, spans)
    assert idle == pytest.approx({"worker.solve": 0.026, "search.poll": 0.010,
                                  "search.enqueue": 0.004, spantrace.NO_SEARCH: 0.030})
    assert spantrace.in_search_s(idle) == pytest.approx(0.040)


def test_idle_time_is_shared_among_the_open_searches():
    # two searches idle the card together for 10 ms; search 2 enqueues for 2 ms of
    # it: that span takes half of those 2 ms, not all of them
    gaps = [(0, 10 * MS)]
    spans = [("worker.solve", 0, 10 * MS, 1), ("search.poll", 1 * MS, 10 * MS, 1),
             ("worker.solve", 0, 10 * MS, 2), ("search.enqueue", 4 * MS, 6 * MS, 2)]
    idle = spantrace.idle_by_span(gaps, spans)
    assert idle == pytest.approx({"worker.solve": 0.0005 + 0.004, "search.poll": 0.0045,
                                  "search.enqueue": 0.001})
    # a search's span still counts once the other's solve has ended
    spans = [("worker.solve", 0, 4 * MS, 1), ("worker.result_forward", 4 * MS, 10 * MS, 1),
             ("worker.solve", 0, 8 * MS, 2)]
    idle = spantrace.idle_by_span(gaps, spans)
    assert idle == pytest.approx({"worker.solve": 0.004 + 0.002,
                                  "worker.result_forward": 0.002, spantrace.NO_SEARCH: 0.002})


@pytest.mark.parametrize("seed", range(12))
def test_every_idle_second_gets_one_label(seed):
    rng = random.Random(seed)
    lo, hi = 0, 1000 * MS
    device = []
    for _ in range(rng.randint(0, 40)):
        s = rng.randrange(-50 * MS, hi)
        device.append(("k", s, rng.randrange(1, 60 * MS)))
    names = ["worker.solve", "search.poll", "search.enqueue", "worker.mine_start",
             "worker.cancel"]
    spans = []
    for _ in range(rng.randint(0, 30)):
        s = rng.randrange(-100 * MS, hi)
        spans.append((rng.choice(names), s, s + rng.randrange(0, 300 * MS), rng.randint(1, 4)))
    gaps = spantrace.idle_gaps(device, lo, hi)
    idle_s = sum(e - s for s, e in gaps) / 1e9
    busy_s = sum(e - s for s, e in port_merged(device, lo, hi)) / 1e9
    assert idle_s == pytest.approx((hi - lo) / 1e9 - busy_s)
    idle = spantrace.idle_by_span(gaps, spans)
    assert sum(idle.values()) == pytest.approx(idle_s, abs=1e-9)
    assert set(idle) <= set(names) | {spantrace.NO_SEARCH}
    assert spantrace.in_search_s(idle) <= idle_s + 1e-12
    if not any(n == "worker.solve" for n, _, _, _ in spans):
        assert spantrace.in_search_s(idle) == 0


def port_merged(device, lo, hi):
    return merged([(max(s, lo), min(s + d, hi)) for _, s, d in device if s < hi and s + d > lo])


def test_summarize_puts_the_spans_on_the_profilers_clock():
    offset = 3 * MS  # the profiler's clock runs 3 ms ahead of time.time
    t0 = 1_700_000_000 * 10 ** 9
    # two anchors: the first one's bracket stretched to 12 ms, the second 2 us wide
    host = [("distpow.clock_anchor", t0 + offset + 300, 500),
            ("distpow.clock_anchor", t0 + offset + 1000, 500), ("op", t0 + offset, 100 * MS)]
    device = [("k", t0 + offset + 50 * MS, 50 * MS)]
    spans = [{"name": "worker.solve", "ts": (t0 + 10 * MS) / 1e9, "dur_s": 0.030, "trace_id": 5},
             {"name": "search.enqueue", "ts": (t0 + 12 * MS) / 1e9, "dur_s": 0.002,
              "attrs": {"vw": 0}, "trace_id": 5},
             {"name": "search.enqueue", "ts": (t0 + 20 * MS) / 1e9, "dur_s": 0.001,
              "attrs": {"vw": 1}, "trace_id": 5}]
    out = spantrace.summarize(device, host, spans,
                              [(t0 - 12 * MS, t0 + 2000), (t0, t0 + 2000)])
    assert out["clock_offset_ms"] == pytest.approx(3.0, abs=1e-5)
    assert out["idle_s"] == pytest.approx(0.050)
    assert out["idle_by_span"] == pytest.approx(
        {"worker.solve": 0.027, spantrace.PROBE: 0.002, "search.enqueue": 0.001,
         spantrace.NO_SEARCH: 0.020}, abs=1e-6)
    assert out["idle_in_search_s"] == pytest.approx(0.030, abs=1e-6)


def test_the_clock_anchor_on_cpu_torch_is_within_5_ms():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        brackets = spantrace.clock_anchors()
        torch.ones(64).sum()
    finally:
        prof.stop()
    _, host = split_events(prof.profiler.kineto_results.events())
    assert len(brackets) == 8
    assert abs(spantrace.anchor_offset_ns(host, brackets)) < 5 * MS


class _SpanReader:
    """A reader that takes the span ring from a sequence number on every
    0.1 s, on a thread of its own, as a traced window's collector would."""

    def __init__(self):
        self.first = self.seq = SPANS.total_recorded
        self.spans, self.lost = [], 0
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _read(self):
        batch = SPANS.since(self.seq)
        if batch:
            self.lost += batch[0]["seq"] - self.seq - 1
            self.seq = batch[-1]["seq"]
            self.spans += batch

    def _run(self):
        while not self._done.wait(0.1):
            self._read()

    def stop(self):
        self._done.set()
        self._thread.join()
        self._read()
        return self.spans


def _traced_mines(device, ntz, clients, per_client, **backend):
    """An in-process worker on ``device`` serving ``clients`` closed-loop
    clients (Mine, result, Found, its ACK) ``per_client`` puzzles each, under
    the profiler, the switch and a span reader: ``(spantrace summary, reader,
    timed device s, profiled kernel device s)``."""
    from torch.profiler import ProfilerActivity, profile

    handler = WorkerRPCHandler(Tracer("worker1", MemorySink()), queue.Queue(),
                               get_backend("cuda", hash_model="md5", device=device, **backend),
                               device=device)
    routes = {}

    def route():
        while True:
            msg = handler.result_queue.get()
            if msg is None:
                return
            routes[bytes(msg["nonce"])].put(msg)

    def solve(nonce, n):
        routes[nonce] = q = queue.Queue()
        handler.Mine(_params(nonce, n))
        secret = q.get(timeout=120)["secret"]
        assert secret is not None
        handler.Found(_params(nonce, n, secret=secret))
        q.get(timeout=120)  # the Found's ACK

    def client(c):
        for j in range(per_client):
            solve(bytes([0x40 + c, j, 0x5A, 0x11]), ntz)

    router = threading.Thread(target=route, daemon=True)
    router.start()
    solve(b"\x7f\x00\x00\x01", 2)  # builds and loads the kernels
    timed = ("search.device_s", "search.past_hit_s")
    before = sum(REGISTRY.get_observed(name)["sum"] for name in timed)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=acts)
    prof.start()
    SPANS.configure(device_timing=True)
    try:
        brackets = spantrace.clock_anchors()
        reader = _SpanReader()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        # anchors at the close too: on the CPU the profiler sees no op of the
        # miner threads, and the traced window runs from the first host op to the last
        brackets += spantrace.clock_anchors()
    finally:
        SPANS.configure(device_timing=False)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        handler.result_queue.put(None)
    spans = reader.stop()
    port_search.resolve_past_hit()  # every launch left in flight has ended
    timed_s = sum(REGISTRY.get_observed(name)["sum"] for name in timed) - before
    device_events, host = split_events(prof.profiler.kineto_results.events())
    kernel_s = sum(d for name, _, d in device_events if "hash_" in name and "kernel" in name) / 1e9
    return spantrace.summarize(device_events, host, spans, brackets), reader, timed_s, kernel_s


def test_an_in_process_traced_worker_on_the_cpu_labels_its_idle_time():
    summary, reader, timed_s, kernel_s = _traced_mines(
        "cpu", 3, clients=2, per_client=3, batch_size=1 << 10, max_launch=1 << 12)
    assert reader.lost == 0 and reader.seq - reader.first == len(reader.spans)
    assert abs(summary["clock_offset_ms"]) < 5.0
    assert timed_s == 0 and kernel_s == 0  # no card: nothing timed, no kernel
    # no device events: the whole traced window is idle, and every second of it labelled
    assert sum(summary["idle_by_span"].values()) == pytest.approx(summary["idle_s"])
    assert summary["idle_in_search_s"] <= summary["idle_s"] + 1e-12
    if SPANS.enabled:
        names = {s["name"] for s in reader.spans}
        assert {"worker.solve", "worker.mine_start"} <= names
        assert summary["idle_in_search_s"] > 0


@pytest.mark.card
def test_a_traced_md5_run_on_the_card_times_its_kernels_and_labels_its_idle_time():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    summary, reader, timed_s, kernel_s = _traced_mines("cuda:0", 8, clients=4, per_client=6)
    assert reader.lost == 0
    assert 0.95 <= timed_s / kernel_s <= 1.05, (timed_s, kernel_s)
    assert abs(summary["clock_offset_ms"]) < 2.0, summary
    assert summary["idle_in_search_s"] <= summary["idle_s"] + 1e-12
    assert sum(summary["idle_by_span"].values()) == pytest.approx(summary["idle_s"])
    assert summary["idle_by_span"].keys() - {spantrace.NO_SEARCH}, summary


def test_threads_share_one_lock_a_card():
    locks = []

    def take():
        locks.append(hash_cuda._card_lock(torch.device("cuda", 1)))

    threads = [threading.Thread(target=take) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(locks) == 8 and len({id(lk) for lk in locks}) == 1
    assert hash_cuda._card_lock(torch.device("cuda", 2)) is not locks[0]


def test_a_launch_that_reaches_no_kernel_is_not_timed():
    # the plain steps on the CPU launch no kernel: no events, and the request
    # does not outlive the call
    assert hash_cuda.timed(lambda: 7, torch.device("cuda", 0)) == (7, None)
    assert hash_cuda._TIMED.device is None and hash_cuda._TIMED.events is None


def test_a_timed_launch_calls_its_c_function_holding_the_gil():
    import ctypes

    libc = ctypes.CDLL(None)
    fn = libc.labs
    fn.argtypes, fn.restype = [ctypes.c_long], ctypes.c_long
    held = hash_cuda._gil_held(fn)
    assert held(-5) == 5 and hash_cuda._gil_held(fn) is held
    assert isinstance(held, ctypes._CFuncPtr) and held._flags_ & ctypes._FUNCFLAG_PYTHONAPI

