"""The search driver's instruments, the backends' keyword arguments and
names, and the boot warm-up, against the reference where it has them.

* The port's ``search`` writes the same ``search.*`` counters, histograms
  and gauges and records the same span names as the reference driver
  (``distpow_tpu/parallel/search.py``, JAX on the CPU) on the same request;
  it beats the device-hang watchdog around every launch and fetch, and the
  first launch of each width segment runs under the first-compile grace.
* ``TorchBackend`` and ``CudaBackend`` take the reference worker's
  ``mesh_devices``, ``interpret`` and ``loop``; ``get_backend`` maps the
  reference's ``Backend`` names.
* ``warmup`` launches each (nonce length, width) layout once, on the CPU
  without building anything.
"""

import contextlib
import threading

import pytest

from distpow_tpu_torch.backends import PythonBackend, TorchBackend, get_backend
from distpow_tpu_torch.backends import cuda_backend
from distpow_tpu_torch.backends.cuda_backend import CudaBackend, CudaMeshBackend
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.parallel import search as port_search
from distpow_tpu_torch.runtime.metrics import Metrics
from distpow_tpu_torch.runtime.spans import SPANS
from distpow_tpu_torch.runtime.watchdog import FIRST_COMPILE_GRACE_S

NONCE, DIFFICULTY, FULL = b"\x01\x02\x03\x04", 4, list(range(256))


def _record_names(registry, monkeypatch) -> dict:
    """The search.* counters, histograms and gauges that the calling thread
    writes into ``registry`` from now on (another thread of the test
    process writing the same registry does not count)."""
    me = threading.get_ident()
    names = {"counters": set(), "histograms": set(), "gauges": set()}
    for kind, method in (("counters", "inc"), ("histograms", "observe"), ("gauges", "gauge")):
        def record(name, *args, _kind=kind, _write=getattr(registry, method), **kwargs):
            if threading.get_ident() == me and name.startswith("search."):
                names[_kind].add(name)
            return _write(name, *args, **kwargs)

        monkeypatch.setattr(registry, method, record)
    return names


def test_search_writes_the_reference_drivers_metrics_and_spans(monkeypatch):
    from distpow_tpu.models.registry import get_hash_model as jax_model
    from distpow_tpu.parallel.search import search as jax_search
    from distpow_tpu.runtime.metrics import REGISTRY as JAX_REGISTRY
    from distpow_tpu.runtime.spans import SPANS as JAX_SPANS

    jax_names, spans0 = _record_names(JAX_REGISTRY, monkeypatch), JAX_SPANS.total_recorded
    want = jax_search(NONCE, DIFFICULTY, FULL, model=jax_model("md5"), batch_size=1 << 10,
                      launch_candidates=1 << 12)
    jax_spans = JAX_SPANS.recent()[-(JAX_SPANS.total_recorded - spans0):]

    m = Metrics()
    port_names, spans0 = _record_names(m, monkeypatch), SPANS.total_recorded
    got = port_search.search(NONCE, DIFFICULTY, FULL, model=get_hash_model("md5"),
                             batch_size=1 << 10, launch_candidates=1 << 12, device="cpu",
                             metrics=m)
    port_spans = SPANS.recent()[-(SPANS.total_recorded - spans0):]
    assert got.secret == want.secret
    assert port_names == jax_names
    assert jax_names["gauges"] == {"search.hashes_per_s"}
    assert {"search.launches", "search.hashes", "search.found",
            "search.blocking_syncs"} <= jax_names["counters"]
    assert jax_names["histograms"] == {"search.launch_s"}
    assert sorted({s["name"] for s in port_spans}) == sorted({s["name"] for s in jax_spans}) \
        == ["search.launch"]
    assert len(port_spans) == m.get("search.blocking_syncs")
    assert [sorted(s["attrs"]) for s in port_spans] == [sorted(s["attrs"]) for s in jax_spans]
    assert m.get("search.hashes_per_s") == 0  # dropped to 0 as the last search exits


class _Watchdog:
    """Records the driver's watchdog calls."""

    def __init__(self):
        self.calls = []

    def beat(self):
        self.calls.append("beat")

    @contextlib.contextmanager
    def active(self):
        self.calls.append("active")
        yield
        self.calls.append("inactive")

    @contextlib.contextmanager
    def grace(self, seconds):
        self.calls.append(("grace", seconds))
        yield


class _GaugeLog(Metrics):
    def __init__(self):
        super().__init__()
        self.rates = []

    def gauge(self, name, value):
        if name == "search.hashes_per_s":
            self.rates.append(value)
        super().gauge(name, value)


def test_search_beats_the_watchdog_and_meters_the_rate(monkeypatch):
    dog = _Watchdog()
    monkeypatch.setattr(port_search, "WATCHDOG", dog)
    m = _GaugeLog()
    res = port_search.search(NONCE, 5, FULL, model=get_hash_model("md5"), batch_size=1 << 10,
                             launch_candidates=1 << 11, device="cpu", metrics=m)
    assert res is not None
    launches = m.get("search.launches")
    assert dog.calls[0] == "active" and dog.calls[-1] == "inactive"
    assert dog.calls.count("active") == 1
    # a beat before each launch and before each blocking fetch
    assert dog.calls.count("beat") >= launches + m.get("search.blocking_syncs")
    # the first launch of each width segment (0, 1, 2, 3, ...) under the grace
    graces = [c for c in dog.calls if isinstance(c, tuple)]
    assert graces and all(c == ("grace", FIRST_COMPILE_GRACE_S) for c in graces)
    assert len(graces) < launches
    assert any(r > 0 for r in m.rates) and m.rates[-1] == 0


@pytest.mark.parametrize("cls", [TorchBackend, CudaBackend])
def test_backends_take_the_reference_workers_keywords(cls):
    for mesh_devices in (0, 1):
        for loop in ("persistent", "serial"):
            be = cls(hash_model="sha1", batch_size=1 << 10, device="cpu",
                     mesh_devices=mesh_devices, max_launch=None, interpret=False, loop=loop)
            assert be.loop == loop and be.model.name == "sha1"
    # a single-device backend names the mesh backend that serves the count
    with pytest.raises(ValueError, match="CudaMeshBackend"):
        cls(device="cpu", mesh_devices=4)
    with pytest.raises(ValueError, match="no interpret mode"):
        cls(device="cpu", interpret=True)
    with pytest.raises(ValueError, match="unknown search loop"):
        cls(device="cpu", loop="spin")
    # the persistent loop is the persistent driver: it counts the segments
    # it ran and never blocks on a result
    m = Metrics()
    be = cls(device="cpu", batch_size=1 << 10, max_launch=1 << 12, loop="persistent", metrics=m)
    assert be.search(NONCE, DIFFICULTY, FULL) is not None
    assert m.get("search.persistent_steps") > 0 and m.get("search.blocking_syncs") == 0


def test_get_backend_maps_the_reference_names():
    kw = dict(hash_model="md5", batch_size=1 << 10, mesh_devices=0, max_launch=None,
              interpret=False, loop="persistent")
    for name in ("pallas", "jax", "cuda", "auto"):
        assert type(get_backend(name, device="cpu", **kw)) is CudaBackend
    assert type(get_backend("torch", device="cpu", **kw)) is TorchBackend
    assert type(get_backend("python", **kw)) is PythonBackend
    for name in ("jax-mesh", "pallas-mesh", "mesh", "cuda-mesh"):
        assert type(get_backend(name, device="cpu", **kw)) is CudaMeshBackend
    # the cuda names with more than one mesh device are the mesh backend
    assert type(get_backend("pallas", device="cpu", **{**kw, "mesh_devices": 4})) is \
        CudaMeshBackend
    with pytest.raises(ValueError, match="Queue 1 item 5"):
        get_backend("native", **kw)


@pytest.mark.parametrize("cls", [CudaBackend, TorchBackend])
def test_warmup_launches_each_layout_once(monkeypatch, cls):
    """On the CPU: one launch per (nonce length, width) of the full
    partition, no build (nvcc exists only beside a card)."""
    from distpow_tpu_torch.ops import _build, search_step

    def no_build(*a, **k):
        raise AssertionError("warmup on the CPU built a library")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    seen = []
    # the serial and the persistent launch (the backend's default loop, which
    # warms every width but 0 through its persistent step)
    if cls is CudaBackend:
        for name in ("hash_search", "hash_persistent_search"):
            real = getattr(cuda_backend, name)

            def counted(model, ops, tb_loc, chunk_locs, *a, _real=real, **k):
                seen.append((ops.n_blocks, tb_loc, chunk_locs, ops.tb_lo, ops.tb_count))
                return _real(model, ops, tb_loc, chunk_locs, *a, **k)

            monkeypatch.setattr(cuda_backend, name, counted)
    else:
        for name in ("plain_search", "persistent_search_step"):
            real = getattr(search_step, name)

            # (a persistent step launched with a set flag runs no plain_search)
            def counted(ops, tb_loc, chunk_locs, *a, _real=real, **k):
                seen.append((ops.n_blocks, tb_loc, chunk_locs, ops.tb_lo, ops.tb_count))
                return _real(ops, tb_loc, chunk_locs, *a, **k)

            monkeypatch.setattr(search_step, name, counted)
        real_w0 = search_step.plain_search_w0

        def counted_w0(ops, tb_loc, chunk_locs=(), **k):
            seen.append((ops.n_blocks, tb_loc, tuple(chunk_locs), ops.tb_lo, ops.tb_count))
            return real_w0(ops, tb_loc, chunk_locs, **k)

        monkeypatch.setattr(search_step, "plain_search_w0", counted_w0)
    be = cls(hash_model="sha256", batch_size=1 << 10, max_launch=1 << 12, device="cpu")
    assert be.loop == "persistent"
    be.warmup([4, 60], [0, 1, 2, 3])
    assert len(seen) == 8 and len(set(seen)) == 8
    assert {s[3:] for s in seen} == {(0, 256)}
    assert {s[0] for s in seen} == {1, 2}
