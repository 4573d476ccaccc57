"""The port's mesh search (``distpow_tpu_torch/parallel/mesh_search.py``) on
the CPU, held to the JAX package on the 8 CPU devices ``conftest.py``
forces.

* ``split_thread_bytes`` equals the reference's.
* The step parity of all nine models against the reference's XLA mesh
  step is in ``test_torch_mesh_step.py``.
* md5's kernels' factory against the reference's Pallas mesh step in
  interpret mode.
* ``search_mesh`` against the reference's ``search_mesh``, the Python
  oracle and the port's solo ``search`` (after ``tests/test_search.py``),
  and cancellation, at once and mid-search.
* The mesh backend: names, ``auto``, ``mesh_devices``, ``devices`` and
  ``warmup`` (both regimes, one launch per layout and shard, no build).
"""

import jax
import numpy as np
import pytest
import torch

from distpow_tpu.models.registry import get_hash_model as ref_model
from distpow_tpu.parallel import mesh_search as ref_mesh
from distpow_tpu.parallel import partition as ref_partition
from distpow_tpu_torch.backends import cuda_backend, get_backend
from distpow_tpu_torch.backends.cuda_backend import CudaBackend, CudaMeshBackend
from distpow_tpu_torch.models import puzzle
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops import _build
from distpow_tpu_torch.ops.operands import u32_value
from distpow_tpu_torch.parallel import mesh_search, partition
from distpow_tpu_torch.parallel.search import search
from distpow_tpu_torch.runtime.metrics import Metrics

FULL = list(range(256))



def _cpu_mesh(n):
    return mesh_search.make_mesh(["cpu"] * n)


def _jax_mesh(n):
    return ref_mesh.make_mesh(jax.devices()[:n])


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8, 256, 300])
@pytest.mark.parametrize("tbs", [FULL, list(range(64, 128)), [5, 6, 7], [9], []])
def test_split_thread_bytes_matches_the_reference(tbs, n_shards):
    assert partition.split_thread_bytes(tbs, n_shards) == \
        ref_partition.split_thread_bytes(tbs, n_shards)


def test_split_thread_bytes_rejects_no_shards():
    for fn in (partition.split_thread_bytes, ref_partition.split_thread_bytes):
        with pytest.raises(ValueError, match="positive"):
            fn(FULL, 0)


@pytest.mark.parametrize("n_dev,tb_lo,tbc,width,steps", [
    (8, 0, 256, 2, 2),   # thread-byte split
    (8, 0, 4, 3, 1),     # chunk split
    (2, 128, 64, 1, 2),  # a sub-partition
])
def test_md5_mesh_kernels_factory_matches_the_reference_pallas_mesh_step(n_dev, tb_lo, tbc,
                                                                         width, steps):
    """md5's mesh kernels' factory (CPU shards: the wrapper's plain version)
    against the reference's Pallas mesh step in interpret mode, as
    ``tests/test_pallas.py`` runs it: same coverage, same index."""
    nonce = b"\x07\x08\x09"
    target = (1 << 14) // tbc
    for d in (2, 3):
        ref = ref_mesh._pallas_mesh_step_factory(nonce, d, tb_lo, tbc, ref_model("md5"),
                                                 _jax_mesh(n_dev), ref_mesh.AXIS,
                                                 interpret=True)
        ref_step, ref_chunks = ref(width, b"", target, steps)
        step, chunks = mesh_search._cuda_mesh_step_factory(
            nonce, d, tb_lo, tbc, get_hash_model("md5"), _cpu_mesh(n_dev))(width, b"", target,
                                                                           steps)
        assert chunks == ref_chunks
        chunk0 = 256 ** (width - 1) + 17
        assert u32_value(step(chunk0)) == int(ref_step(np.uint32(chunk0)))


def test_kernels_factory_keeps_every_partition_index_below_2_31():
    """The per-shard batch rounds up to whole 256-candidate blocks (a run of
    12 per shard: chunks in multiples of 64) and the launch multiplier is
    clamped again to the rounded global batch and the dispatch budget."""
    model, mesh = get_hash_model("md5"), _cpu_mesh(8)
    f = mesh_search._cuda_mesh_step_factory(b"\x01", 5, 0, 96, model, mesh,
                                            max_launch=1 << 30)
    _, chunks = f(4, b"", (1 << 20) // 96, 1 << 20)
    chunks_local = mesh_search._chunks_local((1 << 20) // 96, 96, 8)
    rounded = -(-chunks_local // 64) * 64
    k = (1 << 30) // (rounded * 96)
    assert chunks == rounded * k and chunks * 96 <= 1 << 30
    f = mesh_search._cuda_mesh_step_factory(b"\x01", 5, 0, 256, model, mesh)
    _, chunks = f(4, b"", 1 << 22, 1 << 20)
    assert chunks * 256 < 1 << 31
    with pytest.raises(ValueError, match="2\\^31"):
        mesh_search._cuda_mesh_step_factory(b"\x01", 5, 0, 256, model, mesh)(
            4, b"", 1 << 24, 1)


@pytest.mark.parametrize("difficulty", [2, 3])
def test_search_mesh_matches_the_reference_and_the_single_device_search(difficulty):
    nonce = b"\x01\x02\x03\x04"
    oracle = puzzle.python_search(nonce, difficulty, FULL)
    got = mesh_search.search_mesh(nonce, difficulty, FULL, mesh=_cpu_mesh(8),
                                  batch_size=1 << 14)
    ref = ref_mesh.search_mesh(nonce, difficulty, FULL, mesh=_jax_mesh(8), batch_size=1 << 14)
    solo = search(nonce, difficulty, FULL, batch_size=1 << 14, device="cpu")
    assert got is not None and got.secret == oracle == ref.secret == solo.secret
    assert got.thread_byte == oracle[0] and got.chunk == oracle[1:]


@pytest.mark.parametrize("n_dev", [8, 3])
def test_search_mesh_sub_partition_and_chunk_split(n_dev):
    nonce = b"\x03\x01\x04\x01"
    # thread-byte split (64 over 8 shards; over 3 a chunk split), then fewer
    # thread bytes than shards: the chunk split
    for tbs in (ref_partition.thread_bytes(1, 2), [5, 6, 7]):
        oracle = puzzle.python_search(nonce, 2, tbs)
        got = mesh_search.search_mesh(nonce, 2, tbs, mesh=_cpu_mesh(n_dev), batch_size=1 << 13)
        ref = ref_mesh.search_mesh(nonce, 2, tbs, mesh=_jax_mesh(n_dev), batch_size=1 << 13)
        assert got is not None and got.secret == oracle == ref.secret


def test_search_mesh_wide_model_and_small_launch_budget():
    """sha512 on 4 shards, and md5 with a launch budget that splits every
    launch into sub-batches: the oracle's secret."""
    nonce = b"\x0a\x0b\x0c\x0d"
    for model_name, d, kw in (("sha512", 2, {}), ("md5", 3, {"launch_candidates": 1 << 16})):
        oracle = puzzle.python_search(nonce, d, FULL, algo=model_name)
        got = mesh_search.search_mesh(nonce, d, FULL, mesh=_cpu_mesh(4),
                                      model=get_hash_model(model_name), batch_size=1 << 13, **kw)
        assert got is not None and got.secret == oracle


def test_search_mesh_cancellation():
    m = Metrics()
    assert mesh_search.search_mesh(b"\x01", 30, FULL, mesh=_cpu_mesh(8),
                                   cancel_check=lambda: True, metrics=m) is None
    assert m.get("search.cancelled") == 1
    # mid-search: an unsatisfiable-in-practice difficulty, cancelled after
    # a few launches have been dispatched
    polls = []

    def cancel_check():
        polls.append(1)
        return len(polls) > 6

    m = Metrics()
    assert mesh_search.search_mesh(b"\x01", 30, FULL, mesh=_cpu_mesh(4), batch_size=1 << 10,
                                   launch_candidates=1 << 12, cancel_check=cancel_check,
                                   metrics=m) is None
    assert m.get("search.cancelled") == 1 and m.get("search.launches") >= 5


def test_mesh_needs_explicit_devices_of_one_type():
    assert mesh_search.make_mesh(["cpu"] * 3).size == 3
    with pytest.raises(ValueError, match="at least one"):
        mesh_search.Mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh_search.make_mesh(["cuda:0"] * 2)
        with pytest.raises(RuntimeError, match="none is visible"):
            mesh_search.make_mesh()
    with pytest.raises(ValueError, match="launches on a mesh of 2"):
        mesh_search.make_mesh(["cpu"] * 2).run([lambda: torch.tensor(1)] * 3)
    # the least uint32, not the least int32: SENTINEL ranks above every hit
    out = mesh_search.make_mesh(["cpu"] * 3).run(
        [lambda: torch.tensor(-1, dtype=torch.int32), lambda: torch.tensor(0x80000005),
         lambda: torch.tensor(0xFFFFFFFF)])
    assert u32_value(out) == 0x80000005


def test_mesh_backend_names_auto_and_device_counts(monkeypatch):
    kw = dict(hash_model="md5", batch_size=1 << 12, max_launch=1 << 14, device="cpu")
    for name in ("cuda-mesh", "pallas-mesh", "jax-mesh", "mesh"):
        be = get_backend(name, mesh_devices=4, **kw)
        assert type(be) is CudaMeshBackend and be.mesh.size == 4
    assert type(get_backend("cuda", mesh_devices=2, **kw)) is CudaMeshBackend
    assert type(get_backend("auto", mesh_devices=1, **kw)) is CudaBackend
    assert CudaMeshBackend(devices=["cpu"] * 3, **kw).mesh.size == 3
    assert CudaMeshBackend(**kw).mesh.size == 1  # the CPU: one shard unless asked
    with pytest.raises(ValueError, match="no interpret mode"):
        CudaMeshBackend(interpret=True, **kw)
    # auto picks the mesh where more than one GPU is visible, as the
    # reference's auto picks pallas-mesh
    from distpow_tpu_torch import backends

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert backends._wants_mesh("auto", {}) and not backends._wants_mesh("auto", kw)
    assert not backends._wants_mesh("auto", {"mesh_devices": 1})
    assert not backends._wants_mesh("cuda", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="2 GPU"):
        cuda_backend._mesh_device_list(torch.device("cuda"), 4)
    assert [str(d) for d in cuda_backend._mesh_device_list(torch.device("cuda"), 0)] == \
        ["cuda:0", "cuda:1"]


def test_mesh_backend_starts_at_the_callers_card(monkeypatch):
    """On a host of 4 GPUs: a card the caller names is the mesh's first
    device, the other visible GPUs follow in order; ``auto`` with a named
    card stays on that card; a ``devices`` list that starts elsewhere
    raises instead of moving the worker."""
    from distpow_tpu_torch import backends

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def names(device, n, devices=None):
        return [str(d) for d in cuda_backend._mesh_device_list(torch.device(device), n, devices)]

    assert names("cuda", 2) == ["cuda:0", "cuda:1"]
    assert names("cuda:2", 2) == ["cuda:2", "cuda:0"]
    assert names("cuda:1", 0) == ["cuda:1", "cuda:0", "cuda:2", "cuda:3"]
    with pytest.raises(ValueError, match="4 GPU"):
        names("cuda:3", 5)
    assert names("cuda:1", 0, ["cuda:1"] * 4) == ["cuda:1"] * 4
    assert names("cuda", 0, ["cuda:3", "cuda:2"]) == ["cuda:3", "cuda:2"]
    for device, devices in (("cuda:1", ["cuda:0", "cuda:1"]), ("cpu", ["cuda:0"]),
                            ("cuda", ["cpu"])):
        with pytest.raises(ValueError, match="the mesh starts at"):
            names(device, 0, devices)
    assert not backends._wants_mesh("auto", {"device": "cuda:1"})
    assert not backends._wants_mesh("auto", {"device": "cuda:0"})
    assert backends._wants_mesh("auto", {"device": "cuda"})
    be = get_backend("auto", hash_model="md5", device="cuda:1")
    assert type(be) is CudaBackend and be.device == torch.device("cuda", 1)


def test_mesh_backend_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this test describes a machine without one")
    for name in ("pallas-mesh", "jax-mesh"):
        with pytest.raises(RuntimeError, match="needs a GPU"):
            get_backend(name)


@pytest.mark.parametrize("n_dev", [4, 3])
def test_mesh_backend_search_and_warmup(monkeypatch, n_dev):
    """The backend's secret is the oracle's.  ``warmup`` builds nothing on
    the CPU and launches each layout once on every shard, at the full run
    (4 shards: the thread-byte split; 3: the chunk split) and at n_dev // 2
    thread bytes (the chunk split); width 0 runs on the first shard, the
    other widths in the persistent form (the backend's default loop)."""
    def no_build(*a, **k):
        raise AssertionError("warmup on the CPU built a library")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    be = get_backend("pallas-mesh", hash_model="sha1", batch_size=1 << 10, max_launch=1 << 12,
                     device="cpu", mesh_devices=n_dev)
    nonce = b"\x11\x22"
    assert be.search(nonce, 2, FULL) == puzzle.python_search(nonce, 2, FULL, algo="sha1")
    seen = []
    real = mesh_search.hash_mesh_search

    def counted(model, ops, tb_loc, chunk_locs, chunk0, batch, steps, origin, **k):
        seen.append((origin.tbc, len(chunk_locs), ops.tb_lo, ops.tb_count, str(ops.device)))
        return real(model, ops, tb_loc, chunk_locs, chunk0, batch, steps, origin, **k)

    monkeypatch.setattr(mesh_search, "hash_mesh_search", counted)
    real_persistent = mesh_search.hash_mesh_persistent_search

    def counted_persistent(model, ops, tb_loc, chunk_locs, chunk0, batch, steps, origin, *a,
                           **k):
        seen.append((origin.tbc, len(chunk_locs), ops.tb_lo, ops.tb_count, str(ops.device)))
        return real_persistent(model, ops, tb_loc, chunk_locs, chunk0, batch, steps, origin,
                               *a, **k)

    monkeypatch.setattr(mesh_search, "hash_mesh_persistent_search", counted_persistent)
    assert be.loop == "persistent"
    be.warmup([4, 60], [0, 1, 2])
    split = 256 % n_dev == 0
    want = []
    for tbc in (256, n_dev // 2):
        for _ in (4, 60):
            for width in (0, 1, 2):
                if width == 0:
                    want.append((tbc, 0, 0, tbc, "cpu"))
                    continue
                tbl = tbc // n_dev if split and tbc == 256 else tbc
                runs = range(n_dev)
                want += [(tbc, width, (d * tbl if tbl != tbc else 0), tbl, "cpu") for d in runs]
    assert seen == want
