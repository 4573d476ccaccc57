"""The persistent loop's mesh step of the port (``parallel/mesh_search.py
mesh_persistent_factory``: one persistent shard launch per shard,
``hash_cuda.hash_mesh_persistent_search``, whose CPU path is
``plain_shard_persistent_search``, and the least of each word across the
shards) and its lane plan (``sched/lanes.py persistent_step_builder``), on
logical CPU shards, against the reference (JAX on the 8 CPU devices
``conftest.py`` forces).

* One dispatch: both words equal the port's solo persistent step at the
  partition's segment, for 1-8 shards in both regimes (thread-byte split and
  chunk split), widths 1-4, one- and two-block tails, hits and none, and a
  set flag gives ``(SENTINEL, 0)``; in the thread-byte split both words
  also equal the reference's mesh persistent step's.
* The whole search: ``CudaMeshBackend`` on 4 logical CPU shards, and the
  solo backend with the mesh's lane plan, give the reference's first hits
  (its ``persistent_search`` over its mesh persistent step), and the
  segments executed where the two meshes segment alike.
* ``persistent_step_builder``: the single-device plan (``None``) for one
  device, a named card or another override, the mesh otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distpow_tpu.models.registry import get_hash_model as ref_model
from distpow_tpu.parallel import mesh_search as ref_mesh
from distpow_tpu.parallel.search import persistent_search as ref_persistent_search
from distpow_tpu.runtime.metrics import REGISTRY as JAX_REGISTRY
from distpow_tpu.sched import lanes as ref_lanes
from distpow_tpu_torch.backends import get_backend
from distpow_tpu_torch.backends.cuda_backend import CudaBackend
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops import search_step
from distpow_tpu_torch.ops.hash_cuda import hash_mesh_persistent_search
from distpow_tpu_torch.ops.operands import u32_value
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.ops.search_step import SENTINEL, MeshOrigin
from distpow_tpu_torch.parallel import mesh_search
from distpow_tpu_torch.parallel.partition import thread_bytes, worker_bits
from distpow_tpu_torch.parallel.search import StopFlag, launch_steps_for, persistent_search
from distpow_tpu_torch.runtime.metrics import Metrics
from distpow_tpu_torch.sched.lanes import LaneCaps, persistent_step_builder

SEED = 20261017


def _nonce(n):
    return np.random.default_rng(SEED + n).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _cpu_mesh(n):
    return mesh_search.make_mesh(["cpu"] * n)


def _words(t):
    return [u32_value(v) for v in t]


# (shards, tb_lo, tbc): thread-byte splits and chunk splits (fewer thread
# bytes than shards, or a count they do not divide)
LAYOUTS = [(1, 0, 256), (2, 0, 256), (4, 64, 64), (8, 0, 256), (3, 0, 256), (8, 16, 4),
           (4, 5, 3), (8, 16, 96)]
# (nonce_len, width, difficulty, target chunks, segments, chunk0)
DISPATCHES = [(4, 1, 2, 4, 3, 1), (13, 2, 3, 16, 4, 256), (60, 3, 3, 8, 5, 65536),
              (62, 4, 2, 4, 3, 1 << 24), (100, 2, 7, 4, 2, 300)]


@pytest.mark.parametrize("dispatch", DISPATCHES, ids=[f"d{i}" for i in range(len(DISPATCHES))])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"{n}x{lo}+{c}" for n, lo, c in LAYOUTS])
@pytest.mark.parametrize("name", ["md5", "sha256"])
def test_mesh_persistent_step_matches_the_solo_persistent_step(name, layout, dispatch):
    n_dev, tb_lo, tbc = layout
    n_len, width, d, target, segs, chunk0 = dispatch
    model, nonce = get_hash_model(name), _nonce(n_len)
    factory = mesh_search.mesh_persistent_factory(nonce, d, tb_lo, tbc, model, _cpu_mesh(n_dev))
    step, chunks_each, chunks_per_step = factory(width, b"", target, segs)
    got = _words(step(chunk0, StopFlag()))
    solo = search_step.cached_persistent_step(nonce, width, d, tb_lo, tbc, chunks_each, name,
                                              b"", chunks_per_step // chunks_each, "cpu")
    assert got == _words(solo(chunk0))
    assert _words(step(chunk0, StopFlag(set_=True))) == [SENTINEL, 0]


@pytest.mark.parametrize("dispatch", DISPATCHES[:4], ids=[f"d{i}" for i in range(4)])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_thread_byte_split_matches_the_reference_mesh_persistent_step(n_dev, dispatch):
    """Where both meshes cut a segment alike (the thread-byte split, whole
    blocks a shard), both words equal the reference's mesh persistent step
    on as many JAX CPU devices."""
    n_len, width, d, target, segs, chunk0 = dispatch
    nonce = _nonce(n_len)
    target = max(target, 256)  # a whole block of 256 candidates a shard
    ref = ref_mesh.mesh_persistent_factory(nonce, d, 0, 256, ref_model("md5"),
                                           ref_mesh.make_mesh(jax.devices()[:n_dev]))
    ref_step, ref_each, ref_chunks = ref(width, b"", target, segs)
    want = [int(v) for v in ref_step(jnp.uint32(chunk0), jnp.uint32(0))]
    step, each, chunks = mesh_search.mesh_persistent_factory(
        nonce, d, 0, 256, get_hash_model("md5"), _cpu_mesh(n_dev))(width, b"", target, segs)
    assert (each, chunks) == (ref_each, ref_chunks)
    assert _words(step(chunk0, StopFlag())) == want
    assert [int(v) for v in ref_step(jnp.uint32(chunk0), jnp.uint32(1))] == [SENTINEL, 0]


def test_width_zero_has_no_mesh_persistent_form():
    factory = mesh_search.mesh_persistent_factory(b"\x01", 1, 0, 256, get_hash_model("md5"),
                                                  _cpu_mesh(4))
    with pytest.raises(ValueError, match="width 0"):
        factory(0, b"", 4096, 1)


def test_shard_wrapper_reports_partition_segments():
    """One shard (the second of a thread-byte split of 4) through the
    wrapper's CPU path: its first hit as the partition's index, its
    segments counted in the partition's, ``total`` where it finds none."""
    model = get_hash_model("sha1")
    nonce, width, chunks, segs = _nonce(9), 2, 8, 5
    spec = build_tail_spec(nonce, width, model)
    origin = MeshOrigin(256, 0, 256)
    zero = torch.zeros(1, dtype=torch.int32)
    for d in (2, 3, 9):
        ops = search_step.step_operands(spec, d, model, 64, 64, "cpu")
        got = _words(hash_mesh_persistent_search(model, ops, spec.tb_loc, spec.chunk_locs, 256,
                                                 chunks * 64, segs, origin, chunks * 256, segs,
                                                 zero, device="cpu"))
        plain = u32_value(search_step.plain_shard_search(ops, spec.tb_loc, spec.chunk_locs, 256,
                                                         chunks * 64, segs, origin, model=model))
        if plain == SENTINEL:
            assert got == [SENTINEL, segs]
        else:
            assert got == [plain, plain // (chunks * 256) + 1]
    stopped = hash_mesh_persistent_search(model, ops, spec.tb_loc, spec.chunk_locs, 256,
                                          chunks * 64, segs, origin, chunks * 256, segs,
                                          torch.ones(1, dtype=torch.int32), device="cpu")
    assert _words(stopped) == [SENTINEL, 0]


# (model, nonce, difficulty, thread bytes)
SEARCHES = [("md5", b"\x01\x02\x03\x04", 4, range(256)),
            ("md5", _nonce(60), 4, thread_bytes(2, worker_bits(4))),
            ("sha1", b"\x6a\x6b", 4, range(256)),
            ("sha256d", _nonce(57), 3, range(0, 2)),
            ("sha512", b"\x01\x02\x03\x04", 3, range(256))]


@pytest.mark.parametrize("case", SEARCHES, ids=[f"{c[0]}-{i}" for i, c in enumerate(SEARCHES)])
def test_mesh_backend_on_four_cpu_shards_gives_the_reference_first_hits(case):
    name, nonce, d, tbs = case
    tbs = list(tbs)
    tb_lo, tbc = tbs[0], len(tbs)
    batch, launch = 1 << 10, 1 << 13
    steps0 = JAX_REGISTRY.get("search.persistent_steps")
    want = ref_persistent_search(
        nonce, d, tbs, model=ref_model(name), batch_size=batch, launch_candidates=launch,
        step_builder=ref_lanes.persistent_step_builder(
            nonce, d, tb_lo, tbc, ref_model(name), caps=ref_lanes.LaneCaps("cpu", 4)))
    want_steps = JAX_REGISTRY.get("search.persistent_steps") - steps0
    m = Metrics()
    be = get_backend("pallas-mesh", hash_model=name, device="cpu", mesh_devices=4,
                     batch_size=batch, max_launch=launch, metrics=m)
    assert be.loop == "persistent" and be.mesh.size == 4
    assert be.search(nonce, d, tbs) == want.secret
    assert m.get("search.blocking_syncs") == 0 and m.get("search.persistent_steps") > 0
    if tbc % 4 == 0:
        # the thread-byte split segments as the reference's mesh does
        assert m.get("search.persistent_steps") == want_steps


def test_solo_backend_takes_the_mesh_lane_plan(monkeypatch):
    """A ``cuda`` backend whose lane plan is the mesh (as on a host of
    several GPUs with no card named) serves every width but 0 through the
    mesh persistent step, with the solo loop's first hit."""
    from distpow_tpu_torch.sched import lanes

    mesh = _cpu_mesh(4)
    plans = []

    def builder(nonce, d, tb_lo, tbc, model, override="auto", device="cuda", max_launch=None):
        plan = persistent_step_builder(nonce, d, tb_lo, tbc, model, caps=LaneCaps("cpu", 4),
                                       override=override, device=device, mesh=mesh,
                                       max_launch=max_launch)
        plans.append(plan)
        return plan

    monkeypatch.setattr(lanes, "persistent_step_builder", builder)
    calls = []
    real = mesh_search.hash_mesh_persistent_search

    def counted(*a, **k):
        calls.append(k["device"])
        return real(*a, **k)

    monkeypatch.setattr(mesh_search, "hash_mesh_persistent_search", counted)
    be = CudaBackend(hash_model="md5", device="cpu", batch_size=1 << 10, max_launch=1 << 13)
    got = be.search(b"\x01\x02\x03\x04", 4, range(256))
    assert plans and all(p is not None for p in plans) and calls
    solo = get_backend("cuda", hash_model="md5", device="cpu", batch_size=1 << 10,
                       max_launch=1 << 13, loop="serial")
    assert got == solo.search(b"\x01\x02\x03\x04", 4, range(256))


@pytest.mark.parametrize("lane, spreads", [("auto", True), ("mesh", True), ("cuda", False),
                                           ("pallas", False)])
def test_scheduler_solo_route_plans_with_the_scheduler_lane(monkeypatch, lane, spreads):
    """The scheduler's solo route hands its lane to the persistent loop's
    plan, as the reference's ``_solo`` passes ``override=self.lane``: on a
    host of several GPUs (caps of 4 devices, here 4 CPU shards), a
    scheduler pinned to the single-device lane (``cuda``, or the
    reference's ``pallas``) keeps an off-default model's search on its
    device, and ``auto`` and ``mesh`` spread it over the mesh; the secret
    is the reference's either way."""
    from distpow_tpu_torch.sched import BatchingScheduler, lanes

    mesh, seen = _cpu_mesh(4), []

    def builder(nonce, d, tb_lo, tbc, model, override="auto", device="cuda", max_launch=None):
        plan = persistent_step_builder(nonce, d, tb_lo, tbc, model, caps=LaneCaps("cpu", 4),
                                       override=override, device=device, mesh=mesh,
                                       max_launch=max_launch)
        seen.append((lanes.lane_name(override), plan is not None))
        return plan

    monkeypatch.setattr(lanes, "persistent_step_builder", builder)
    sched = BatchingScheduler(device="cpu", lane=lane, batch_size=1 << 10, start=False)
    # the planner sees a host of several GPUs, so its default lane is the
    # kernels' and the solo backend is CudaBackend
    sched.planner.caps = LaneCaps("cuda", 4)
    try:
        nonce = _nonce(5)
        secret = sched.search(nonce, 3, range(256), hash_model="sha1")
    finally:
        sched.close()
    assert isinstance(sched._solo_backends["sha1"], CudaBackend)
    assert seen and all(entry == (lanes.lane_name(lane), spreads) for entry in seen)
    want = ref_persistent_search(nonce, 3, list(range(256)), model=ref_model("sha1"),
                                 batch_size=1 << 10)
    assert secret == want.secret


@pytest.mark.parametrize("difficulty", [2, 4])
def test_mesh_shards_launch_on_the_grid_their_expected_hits_choose(monkeypatch, difficulty):
    """Each shard of a persistent mesh launch leaves the grid and the tile to
    the wrapper (one resident wave, ``claim_rounds``): it passes no grid
    choice whatever its share of the launch is expected to hold."""
    seen = []
    real = mesh_search.hash_mesh_persistent_search

    def recorded(model, ops, tb_loc, chunk_locs, chunk0, batch, segments, *a, **kw):
        seen.append((batch * segments, sorted(kw)))
        return real(model, ops, tb_loc, chunk_locs, chunk0, batch, segments, *a, **kw)

    monkeypatch.setattr(mesh_search, "hash_mesh_persistent_search", recorded)
    model = get_hash_model("md5")
    factory = mesh_search.mesh_persistent_factory(b"\x01\x02", difficulty, 0, 256, model,
                                                  _cpu_mesh(4), max_launch=1 << 14)
    step, each, chunks = factory(2, b"", 16, 4)
    step(256, StopFlag())
    assert len(seen) == 4 and all(n == chunks * 256 // 4 for n, _ in seen)
    assert all(kw == ["device"] for _, kw in seen)


def test_persistent_step_builder_plans():
    model = get_hash_model("md5")
    args = (b"\x01\x02", 3, 0, 256, model)
    # one device, a card named, or another override: the single-device step
    assert persistent_step_builder(*args, device="cpu") is None
    assert persistent_step_builder(*args, caps=LaneCaps("cuda", 1)) is None
    assert persistent_step_builder(*args, caps=LaneCaps("cuda", 4), device="cuda:1") is None
    assert persistent_step_builder(*args, caps=LaneCaps("cuda", 4), override="torch") is None
    # several devices and no card named: the mesh's persistent factory
    for override in ("auto", "mesh"):
        plan = persistent_step_builder(*args, caps=LaneCaps("cpu", 4), device="cpu",
                                       mesh=_cpu_mesh(4), override=override)
        k = launch_steps_for(2, 16, 256, 1 << 14)
        step, each, chunks = plan(2, b"", 16, k)
        assert (each, chunks) == (16, 16 * k)
        want = search_step.cached_persistent_step(b"\x01\x02", 2, 3, 0, 256, 16, "md5", b"",
                                                  k, "cpu")
        assert _words(step(256, StopFlag())) == _words(want(256))
    with pytest.raises(ValueError, match="unknown scheduler lane"):
        persistent_step_builder(*args, caps=LaneCaps("cpu", 4), override="spin")


def test_persistent_search_through_the_mesh_plan_matches_the_solo_loop():
    model = get_hash_model("sha1")
    nonce, d, tbs = _nonce(11), 4, list(range(256))
    plan = persistent_step_builder(nonce, d, 0, 256, model, caps=LaneCaps("cpu", 3),
                                   device="cpu", mesh=_cpu_mesh(3), max_launch=1 << 13)
    m_mesh, m_solo = Metrics(), Metrics()
    got = persistent_search(nonce, d, tbs, model=model, batch_size=1 << 10,
                            launch_candidates=1 << 13, step_builder=plan, device="cpu",
                            metrics=m_mesh)
    want = persistent_search(nonce, d, tbs, model=model, batch_size=1 << 10,
                             launch_candidates=1 << 13, device="cpu", metrics=m_solo)
    assert got.secret == want.secret
    assert m_mesh.get("search.found") == 1 and m_mesh.get("search.blocking_syncs") == 0
