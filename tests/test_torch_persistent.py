"""The persistent search loop of the port (``parallel/search.py
persistent_search`` over ``ops/search_step.py cached_persistent_step``, and
the kernels' persistent form through its wrapper, ``hash_cuda
hash_persistent_search``, whose CPU path is the plain step) against the
reference's (``distpow_tpu/parallel/search.py persistent_search`` over the
XLA ``cached_persistent_step``, JAX on the CPU).

* One dispatch: the first hit and the segments executed, both words,
  exactly, at widths 1-4 (width 0 raises in both), one- and two-block
  tails, power-of-two and other runs, one and several segments, hits in
  the first segment, a middle one and none; a set stop flag gives
  ``(SENTINEL, 0)``.
* The whole search: the secret, ``hashes_tried`` and
  ``search.persistent_steps``, for md5, sha1, sha256d and sha512.
* The flag protocol: a cancel during a search returns None within a bound
  and sets the flag; ``search.blocking_syncs`` stays flat under the
  persistent loop while the serial loop counts, and a wait on a launch is
  observed as ``search.poll_s``.
* The routes: every backend name follows ``loop``, the boot warm-up
  launches the persistent step with a set flag, the scheduler's solo route
  for an off-default model runs ``persistent_search``, and a worker with
  ``SearchLoop`` persistent or serial gives the same secrets.
Inputs are fixed nonces and ones drawn from a numpy seed.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distpow_tpu.models import registry as jax_registry
from distpow_tpu.ops import search_step as jax_step
from distpow_tpu.parallel.search import persistent_search as jax_persistent_search
from distpow_tpu.runtime.metrics import REGISTRY as JAX_REGISTRY
from distpow_tpu_torch.backends import TorchBackend, get_backend
from distpow_tpu_torch.backends import cuda_backend
from distpow_tpu_torch.backends.cuda_backend import CudaBackend, CudaMeshBackend
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops import search_step
from distpow_tpu_torch.ops.hash_cuda import LAUNCHES, hash_persistent_search
from distpow_tpu_torch.ops.operands import u32_value
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.ops.search_step import SENTINEL
from distpow_tpu_torch.parallel import search as port_search
from distpow_tpu_torch.parallel.partition import thread_bytes, worker_bits
from distpow_tpu_torch.runtime.metrics import Metrics

MODELS = ("md5", "sha1", "sha256d", "sha512")
SEED = 20261017

# (nonce_len, width, difficulty, tb_lo, tbc, chunks, segments, chunk0, extra)
STEP_CASES = [
    (4, 1, 1, 0, 256, 1, 1, 1, b""),              # one segment
    (4, 2, 3, 0, 256, 4, 8, 256, b""),            # several segments
    (4, 3, 3, 64, 64, 16, 6, 65536, b""),         # a sub-partition
    (13, 2, 3, 5, 3, 300, 5, 256, b""),           # a run of 3 thread bytes
    (60, 3, 2, 0, 96, 8, 4, 65536, b""),          # two-block tail, a run of 96
    (62, 4, 3, 0, 256, 4, 8, 1 << 24, b""),       # width 4, the run across the blocks
    (100, 4, 3, 128, 128, 8, 4, (1 << 24) + 7, b""),  # absorbed prefix, width 4
    (5, 4, 8, 0, 256, 4, 3, 0, b"\x01"),          # no hit, a fixed high chunk byte
    (56, 1, 2, 0, 256, 2, 1, 1, b""),             # two-block tail, one segment
    (2, 4, 4, 0, 256, 16, 7, 1 << 24, b""),       # width 4, several segments
]


def _nonce(n, salt=0):
    return np.random.default_rng(SEED + 1000 * salt + n).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _jax_step(name, case, stop=0):
    n_len, width, d, tb_lo, tbc, chunks, segs, chunk0, extra = case
    step = jax_step.cached_persistent_step(_nonce(n_len), width, d, tb_lo, tbc, chunks, name,
                                           extra, segs)
    return [int(v) for v in step(jnp.uint32(chunk0), jnp.uint32(stop))]


def _port_step(name, case, stop=0):
    n_len, width, d, tb_lo, tbc, chunks, segs, chunk0, extra = case
    step = search_step.cached_persistent_step(_nonce(n_len), width, d, tb_lo, tbc, chunks, name,
                                              extra, segs, "cpu")
    out = step(chunk0, torch.tensor([stop], dtype=torch.int32))
    return [u32_value(v) for v in out]


@pytest.mark.parametrize("case", STEP_CASES, ids=[f"case{i}" for i in range(len(STEP_CASES))])
@pytest.mark.parametrize("name", MODELS)
def test_persistent_step_matches_reference(name, case):
    """Both words of one dispatch, the plain step's and the wrapper's CPU
    path's, equal the reference's XLA persistent step's."""
    want = _jax_step(name, case)
    assert _port_step(name, case) == want
    n_len, width, d, tb_lo, tbc, chunks, segs, chunk0, extra = case
    model = get_hash_model(name)
    spec = build_tail_spec(_nonce(n_len), width, model, extra)
    ops = search_step.step_operands(spec, d, model, tb_lo, tbc, "cpu")
    before = LAUNCHES[f"{name}_search_persistent"].value
    got = hash_persistent_search(model, ops, spec.tb_loc, spec.chunk_locs, chunk0, chunks * tbc,
                                 segs, torch.zeros(1, dtype=torch.int32), device="cpu")
    assert [u32_value(v) for v in got] == want
    # the CPU path is the plain version, no launch
    assert LAUNCHES[f"{name}_search_persistent"].value == before


@pytest.mark.parametrize("name", MODELS)
def test_step_cases_hit_the_first_a_middle_and_no_segment(name):
    """The cases above hold a first hit in the first segment, one in a
    middle segment, and none, by the reference's step."""
    kinds = set()
    for case in STEP_CASES:
        f, segs = _jax_step(name, case)
        kinds.add("none" if f == SENTINEL else "first" if segs == 1 else
                  "middle" if segs < case[6] else "last")
    assert {"first", "middle", "none"} <= kinds


@pytest.mark.parametrize("case", STEP_CASES[:4], ids=[f"case{i}" for i in range(4)])
@pytest.mark.parametrize("name", MODELS)
def test_set_stop_flag_gives_sentinel_and_no_segment(name, case):
    assert _jax_step(name, case, stop=1) == [SENTINEL, 0]
    assert _port_step(name, case, stop=1) == [SENTINEL, 0]


def test_width_zero_has_no_persistent_form():
    with pytest.raises(ValueError, match="width 0"):
        jax_step.cached_persistent_step(b"\x01", 0, 1, 0, 256, 1, "md5")
    with pytest.raises(ValueError, match="width 0"):
        search_step.cached_persistent_step(b"\x01", 0, 1, 0, 256, 1, "md5", b"", 1, "cpu")
    model = get_hash_model("md5")
    spec = build_tail_spec(b"\x01", 0, model)
    ops = search_step.step_operands(spec, 1, model, 0, 256, "cpu")
    with pytest.raises(ValueError, match="width 0"):
        hash_persistent_search(model, ops, spec.tb_loc, spec.chunk_locs, 0, 256, 1,
                               torch.zeros(1, dtype=torch.int32), device="cpu")


def test_one_wave_for_a_launch_expected_to_hold_a_hit():
    """A persistent launch runs on one resident wave where it is expected
    to hold at least half a hit (each candidate hits with probability
    16^-difficulty), else on the serial kernel's grid."""
    from distpow_tpu_torch.ops.hash_cuda import ONE_WAVE_EXPECTED_HITS, one_wave_for

    assert ONE_WAVE_EXPECTED_HITS == 0.5
    assert one_wave_for(1 << 30, 7) and not one_wave_for(1 << 30, 8)
    assert one_wave_for(1 << 31, 8) and not one_wave_for((1 << 31) - 1, 8)
    assert one_wave_for(8, 1) and not one_wave_for(7, 1)
    assert not one_wave_for(1 << 30, 16)


@pytest.mark.parametrize("difficulty", [2, 3, 4])
def test_backend_launches_on_the_grid_its_expected_hits_choose(monkeypatch, difficulty):
    """``CudaBackend``'s persistent step asks for one resident wave exactly
    where ``one_wave_for`` says so for its launch's candidates, and the
    search's secret does not depend on the grid (the nonce's secrets at
    difficulties 2-4 all need a chunk byte, so each search reaches the
    persistent step)."""
    from distpow_tpu_torch.ops.hash_cuda import one_wave_for

    seen = []
    real = cuda_backend.hash_persistent_search

    def recorded(model, ops, tb_loc, chunk_locs, chunk0, batch, segments, stop, **kw):
        seen.append((batch * segments, kw["one_wave"]))
        return real(model, ops, tb_loc, chunk_locs, chunk0, batch, segments, stop, **kw)

    monkeypatch.setattr(cuda_backend, "hash_persistent_search", recorded)
    be = CudaBackend(hash_model="md5", device="cpu", batch_size=1 << 10, max_launch=1 << 12)
    nonce = b"\x02\x02\x02\x02"
    got = be.search(nonce, difficulty, range(256))
    assert seen and all(wave == one_wave_for(n, difficulty) for n, wave in seen)
    assert {wave for _, wave in seen} == {difficulty < 4}
    want = jax_persistent_search(nonce, difficulty, list(range(256)),
                                 model=jax_registry.get_hash_model("md5"), batch_size=1 << 10,
                                 launch_candidates=1 << 12)
    assert got == want.secret


def test_persistent_grids_tool_exits_without_a_gpu(capsys):
    from distpow_tpu_torch.tools import persistent_grids

    assert not torch.cuda.is_available()
    assert persistent_grids.main([]) == 2
    assert "no GPU" in capsys.readouterr().err


# (model, nonce, difficulty, thread bytes, batch, launch candidates)
SEARCH_CASES = [
    ("md5", b"\x01\x02\x03\x04", 4, range(256), 1 << 10, 1 << 13),   # 8 segments a dispatch
    ("md5", b"\x02\x02\x02\x02", 4, range(256), 1 << 12, 1 << 12),   # 1 segment a dispatch
    ("md5", _nonce(60), 4, range(5, 8), 1 << 10, 1 << 13),           # two blocks, run of 3
    ("sha1", b"\x01\x02\x03\x04", 4, range(256), 1 << 12, 1 << 15),
    ("sha1", _nonce(7), 4, thread_bytes(1, worker_bits(4)), 1 << 10, 1 << 12),  # width 2
    ("sha256d", b"\xfe\xff", 3, range(256), 1 << 10, 1 << 13),
    ("sha256d", _nonce(57), 3, range(16, 112), 1 << 10, 1 << 12),     # run of 96
    ("sha512", b"\x01\x02\x03\x04", 3, range(256), 1 << 10, 1 << 13),
    ("sha512", _nonce(115), 3, range(0, 3), 1 << 10, 1 << 12),        # two blocks, width 2
]


@pytest.mark.parametrize("case", SEARCH_CASES, ids=[f"{c[0]}-{i}" for i, c in
                                                    enumerate(SEARCH_CASES)])
def test_persistent_search_matches_reference(case):
    """The secret, ``hashes_tried`` and the segments executed
    (``search.persistent_steps``) of a whole search."""
    name, nonce, d, tbs, batch, launch = case
    tbs = list(tbs)
    steps0 = JAX_REGISTRY.get("search.persistent_steps")
    want = jax_persistent_search(nonce, d, tbs, model=jax_registry.get_hash_model(name),
                                        batch_size=batch, launch_candidates=launch)
    want_steps = JAX_REGISTRY.get("search.persistent_steps") - steps0
    m = Metrics()
    got = port_search.persistent_search(nonce, d, tbs, model=get_hash_model(name),
                                        batch_size=batch, launch_candidates=launch,
                                        device="cpu", metrics=m)
    assert want is not None and got is not None
    assert (got.secret, got.thread_byte, got.hashes_tried) == \
        (want.secret, want.thread_byte, want.hashes_tried)
    assert m.get("search.persistent_steps") == want_steps > 0
    assert m.get("search.found") == 1 and m.get("search.blocking_syncs") == 0
    # and the serial loop finds the same secret
    serial = port_search.search(nonce, d, tbs, model=get_hash_model(name), batch_size=batch,
                                launch_candidates=launch, device="cpu", metrics=Metrics())
    assert serial.secret == got.secret


def test_max_hashes_budget_and_unsatisfiable_gates():
    m = Metrics()
    assert port_search.persistent_search(b"\x01", 30, range(256), batch_size=1 << 10,
                                         launch_candidates=1 << 12, max_hashes=1,
                                         device="cpu", metrics=m) is None
    assert m.get("search.hashes") > 0
    assert port_search.persistent_search(b"\x01", 33, range(256), device="cpu",
                                         cancel_check=lambda: True) is None
    with pytest.raises(ValueError, match="unsatisfiable"):
        port_search.persistent_search(b"\x01", 33, range(256), device="cpu")


# -- the flag protocol ---------------------------------------------------------

def test_stop_flag_words():
    flag = port_search.StopFlag()
    word = flag.operand("cpu")
    assert not flag.is_set() and int(word) == 0 and flag.operand("cpu") is word
    flag.set()
    assert flag.is_set() and int(word) == 1
    # a word made after set() holds 1 from the start
    assert int(port_search.StopFlag(set_=True).operand("cpu")) == 1


def test_cancel_during_a_search_returns_none_within_a_bound():
    ev = threading.Event()
    out = {}
    flags = []
    real = port_search.StopFlag

    class Recorded(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            flags.append(self)

    m = Metrics()

    def run():
        out["res"] = port_search.persistent_search(
            b"\xde\xad\xbe", 16, list(range(256)), batch_size=1 << 10,
            launch_candidates=1 << 12, cancel_check=ev.is_set, device="cpu", metrics=m)

    port_search.StopFlag = Recorded
    try:
        t = threading.Thread(target=run, daemon=True)
        t.start()
        time.sleep(0.3)
        t0 = time.monotonic()
        ev.set()
        t.join(timeout=30)
    finally:
        port_search.StopFlag = real
    assert not t.is_alive(), "cancel did not stop the persistent search"
    latency = time.monotonic() - t0
    assert out["res"] is None and m.get("search.cancelled") == 1
    # a dispatch here is 4 segments of 2^10 md5 candidates of the plain step
    assert latency < 2.0, f"cancel took {latency:.2f} s"
    assert len(flags) == 1 and flags[0].is_set()
    assert m.get("search.launches") > 0 and m.get("search.hashes") > 0


def test_blocking_syncs_stay_flat_under_the_persistent_loop():
    nonce, tbs = b"\x61\x62", list(range(256))
    m = Metrics()
    serial = port_search.search(nonce, 3, tbs, batch_size=1 << 10, launch_candidates=1 << 12,
                                device="cpu", metrics=m)
    b1 = m.get("search.blocking_syncs")
    persistent = port_search.persistent_search(nonce, 3, tbs, batch_size=1 << 10,
                                               launch_candidates=1 << 12, device="cpu",
                                               metrics=m)
    assert serial.secret == persistent.secret
    assert b1 >= 1, "the serial drain stopped counting blocking syncs"
    assert m.get("search.blocking_syncs") == b1, "the persistent drain blocked"


class _SlowEvent:
    """An event that reads unready ``n`` times, as a launch still running."""

    def __init__(self, n):
        self.n = n

    def query(self):
        self.n -= 1
        return self.n < 0

    def synchronize(self):
        raise AssertionError("the persistent drain waited on an event")


def test_a_wait_on_a_launch_is_polled_and_observed(monkeypatch):
    from distpow_tpu_torch.runtime.spans import SPANS

    want = port_search.search(b"\x01\x02\x03\x04", 4, range(256), batch_size=1 << 10,
                              launch_candidates=1 << 12, device="cpu", metrics=Metrics())
    real = port_search._enqueue_fetch
    monkeypatch.setattr(port_search, "_enqueue_fetch",
                        lambda res: (real(res)[0], _SlowEvent(3)))
    m = Metrics()
    spans0 = SPANS.total_recorded
    got = port_search.persistent_search(b"\x01\x02\x03\x04", 4, range(256),
                                        batch_size=1 << 10, launch_candidates=1 << 12,
                                        device="cpu", metrics=m, poll_interval_s=0.002)
    assert got.secret == want.secret
    # every drained launch was polled (the one in flight behind the hit is
    # counted, not drained)
    polls = m.get_observed("search.poll_s")
    assert 2 <= polls["count"] < m.get("search.launches")
    assert m.get("search.blocking_syncs") == 0
    if SPANS.enabled:
        names = [s["name"] for s in SPANS.recent()[-(SPANS.total_recorded - spans0):]]
        assert names.count("search.poll") == polls["count"]
        assert "search.launch" not in names


def test_a_cancel_while_polling_returns_at_once(monkeypatch):
    real = port_search._enqueue_fetch
    monkeypatch.setattr(port_search, "_enqueue_fetch",
                        lambda res: (real(res)[0], _SlowEvent(10 ** 9)))
    m = Metrics()
    polls = []

    def cancel():
        polls.append(1)
        return len(polls) > 5

    assert port_search.persistent_search(b"\x01\x02", 16, range(256), batch_size=1 << 10,
                                         launch_candidates=1 << 12, cancel_check=cancel,
                                         device="cpu", metrics=m) is None
    assert m.get("search.cancelled") == 1
    # the width-0 probe, polled until the cancel, is counted: 256 candidates
    assert m.get("search.launches") == 1 and m.get("search.hashes") == 256
    assert len(polls) == 6


# -- the routes ------------------------------------------------------------------

def _record_drivers(monkeypatch):
    seen = []
    for name in ("search", "persistent_search"):
        real = getattr(cuda_backend, name)

        def wrapped(*a, _real=real, _name=name, **k):
            seen.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(cuda_backend, name, wrapped)
    return seen


@pytest.mark.parametrize("name", ["cuda", "pallas", "jax", "auto", "torch", "cuda-mesh",
                                  "pallas-mesh", "jax-mesh", "mesh"])
def test_every_backend_name_follows_the_loop(monkeypatch, name):
    seen = _record_drivers(monkeypatch)
    secrets = {}
    for loop in ("persistent", "serial"):
        be = get_backend(name, hash_model="sha1", device="cpu", batch_size=1 << 10,
                         max_launch=1 << 12, loop=loop)
        assert be.loop == loop
        secrets[loop] = be.search(b"\x01\x02\x03\x04", 3, range(256))
    assert seen == ["persistent_search", "search"]
    assert secrets["persistent"] == secrets["serial"] is not None


@pytest.mark.parametrize("cls", [CudaBackend, TorchBackend, CudaMeshBackend])
def test_warmup_under_the_persistent_loop_launches_with_a_set_flag(monkeypatch, cls):
    """Width 0 through the serial step, every other width once through the
    persistent step with a set flag, which stops before its first
    candidate; nothing is built on the CPU."""
    from distpow_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("warmup on the CPU built a library")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    import distpow_tpu_torch.ops.hash_cuda as hash_cuda

    results = []
    for name, stop_at in (("persistent_search_step", 6), ("plain_shard_persistent_search", 9)):
        real = getattr(search_step, name)

        def counted(*a, _real=real, _stop_at=stop_at, **k):
            out = _real(*a, **k)
            results.append((len(a[2]), int(a[_stop_at]), [u32_value(v) for v in out]))
            return out

        monkeypatch.setattr(search_step, name, counted)
        monkeypatch.setattr(hash_cuda, name, counted)
    kw = {"mesh_devices": 4} if cls is CudaMeshBackend else {}
    be = cls(hash_model="sha256", batch_size=1 << 10, max_launch=1 << 12, device="cpu", **kw)
    assert be.loop == "persistent"
    be.warmup([4, 60], [0, 1, 2, 3])
    # widths 1-3 of both nonce lengths (of each shard, of each warm-up run)
    assert {r[0] for r in results} == {1, 2, 3}
    assert len(results) == 6 * (sum(4 for _ in be._warm_runs()) if kw else 1)
    # every one stopped before its first candidate (a shard reports the
    # partition segment it was about to start; shard 0's is 0)
    assert all(stop == 1 and out[0] == SENTINEL for _, stop, out in results)
    assert all(out[1] == 0 for _, _, out in results[::4 if kw else 1])


def test_scheduler_solo_route_runs_the_persistent_loop(monkeypatch):
    from distpow_tpu_torch.sched import BatchingScheduler

    seen = _record_drivers(monkeypatch)
    sched = BatchingScheduler(device="cpu", lane="cuda", batch_size=1 << 10,
                              extra_models=("sha1",))
    try:
        # sha1 is not a model of this scheduler's packed step: its solo route
        secret = sched.search(b"\x01\x02\x03\x04", 3, range(256), hash_model="sha256")
    finally:
        sched.close()
    assert seen == ["persistent_search"]
    want = jax_persistent_search(b"\x01\x02\x03\x04", 3, list(range(256)),
                                        model=jax_registry.get_hash_model("sha256"),
                                        batch_size=1 << 10)
    assert secret == want.secret


def test_worker_serves_both_loops_with_the_same_secrets():
    from distpow_tpu.nodes import Client, Coordinator
    from distpow_tpu.runtime.config import ClientConfig, CoordinatorConfig
    from distpow_tpu.runtime.tracing import MemorySink as RefMemorySink
    from distpow_tpu_torch.nodes import Worker
    from distpow_tpu_torch.runtime.config import WorkerConfig
    from distpow_tpu_torch.runtime.tracing import MemorySink

    nonces = [b"\x01\x02\x03\x04", _nonce(6, salt=1), _nonce(3, salt=2)]
    secrets, drivers = {}, {}
    for loop in ("persistent", "serial"):
        coord = Coordinator(CoordinatorConfig(ClientAPIListenAddr="127.0.0.1:0",
                                              WorkerAPIListenAddr="127.0.0.1:0",
                                              Workers=["pending:0"]), sink=RefMemorySink())
        client_addr, worker_api = coord.initialize_rpcs()
        w = Worker(WorkerConfig(WorkerID="worker1", ListenAddr="127.0.0.1:0",
                                CoordAddr=worker_api, Backend="jax", BatchSize=1 << 12,
                                MaxLaunchCandidates=1 << 14, WarmupNonceLens=[],
                                WarmupWidths=[], SearchLoop=loop),
                   sink=MemorySink(), device="cpu")
        client = None
        try:
            coord.set_worker_addrs([w.initialize_rpcs()])
            w.start_forwarder()
            drivers[loop] = w.handler.backend.loop
            client = Client(ClientConfig(ClientID="client1", CoordAddr=client_addr),
                            sink=RefMemorySink())
            client.initialize()
            got = []
            for i, nonce in enumerate(nonces):
                client.mine(nonce, 3 + i % 2)
                res = client.notify_queue.get(timeout=60)
                assert res.error is None
                got.append(res.secret)
            secrets[loop] = got
        finally:
            if client is not None:
                client.close()
            w.shutdown()
            coord.shutdown()
    assert drivers == {"persistent": "persistent", "serial": "serial"}
    assert secrets["persistent"] == secrets["serial"]
    from distpow_tpu.models import puzzle as ref_puzzle

    for i, (nonce, secret) in enumerate(zip(nonces, secrets["persistent"])):
        assert secret == ref_puzzle.python_search(nonce, 3 + i % 2, list(range(256)))
