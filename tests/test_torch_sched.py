"""The port's batching scheduler on the CPU (``device="cpu"``).

Ports of the engine tests of ``tests/test_sched.py``: the oracle, fewer
launches than solos, fairness, preemption, the solo fallback, the virtual
time floor, mixed-hash parity, unadmitted and never-admitted models, and
close.  Besides: the same deterministic slot set through the reference
engine (JAX on the CPU, lane ``xla``) and the port's gives the same
per-slot secrets, ``sched.launches``, per-slot launches and preemptions; a
group step that raises kills the loop and errors the slots instead of
demoting to the plain step; without a GPU the scheduler raises unless
built for the CPU; the mesh lane on logical CPU shards gives the torch
lane's secrets in fewer launches (each covers every shard's span), also
with a mixed-model cohort and a shard count that is not a power of two.
Each test counts into its own ``Metrics``.
"""

import threading
import time

import pytest
import torch

from distpow_tpu_torch.models import puzzle
from distpow_tpu_torch.parallel.mesh_search import make_mesh
from distpow_tpu_torch.runtime.metrics import Metrics
from distpow_tpu_torch.runtime.spans import SPANS
from distpow_tpu_torch.sched import BatchingScheduler

FULL = list(range(256))


def _engine(metrics, **kw):
    kw.setdefault("batch_size", 1 << 10)
    return BatchingScheduler(hash_model=kw.pop("hash_model", "md5"), device="cpu",
                             metrics=metrics, **kw)


def test_engine_single_search_matches_reference_oracle():
    eng = _engine(Metrics(), max_slots=4)
    try:
        for nonce, ntz in ((b"\x01\x02\x03\x04", 2), (b"\xaa\xbb", 3), (b"\x07", 1)):
            got = eng.search(nonce, ntz, FULL)
            oracle = puzzle.python_search(nonce, ntz, FULL)
            assert got == oracle, (nonce, ntz, got, oracle)
        tbs = list(range(64, 128))
        got = eng.search(b"\x03\x04", 2, tbs)
        assert got is not None and puzzle.check_secret(b"\x03\x04", got, 2)
        assert got[0] in tbs
    finally:
        eng.close()


def test_engine_eight_concurrent_fewer_launches_than_solos():
    nonces = [bytes([0x42, i]) for i in range(8)]
    ntz = 3
    m_seq = Metrics()
    seq_eng = _engine(m_seq, max_slots=8)
    try:
        for n in nonces:
            assert seq_eng.search(n, ntz, FULL) is not None
    finally:
        seq_eng.close()
    seq_launches = m_seq.get("sched.launches")
    assert seq_launches >= 8

    m = Metrics()
    conc_eng = _engine(m, max_slots=8, start=False)
    slots = [conc_eng.submit(n, ntz, FULL) for n in nonces]
    conc_eng.start()
    try:
        for n, s in zip(nonces, slots):
            secret = s.result(timeout=120)
            assert secret is not None and puzzle.check_secret(n, secret, ntz)
        launches = m.get("sched.launches")
        occ = m.get_observed("sched.batch_occupancy")
        assert occ["count"] == launches
        assert occ["sum"] / occ["count"] > 1
        assert launches < seq_launches, (launches, seq_launches)
        # one host sync per engine launch
        assert m.get("search.blocking_syncs") == launches
    finally:
        conc_eng.close()


def test_engine_fairness_hard_puzzle_cannot_starve_cheap_ones():
    eng = _engine(Metrics(), max_slots=8, start=False)
    try:
        hard = eng.submit(b"\xde\xad", 5, FULL)
        cheap = [eng.submit(bytes([0x51, i]), 1, FULL) for i in range(3)]
        eng.start()
        for i, s in enumerate(cheap):
            secret = s.result(timeout=60)
            assert secret is not None and puzzle.check_secret(bytes([0x51, i]), secret, 1)
            assert s.launches <= 4, s.launches
        assert not hard.done.is_set(), "hard slot finished implausibly fast"
        assert hard.launches >= 1
        hard.cancel()
        assert hard.result(timeout=30) is None
    finally:
        eng.close()


def test_engine_preempts_under_oversubscription():
    m = Metrics()
    eng = _engine(m, max_slots=2, start=False)
    try:
        nonces = [bytes([0x61, i]) for i in range(4)]
        slots = [eng.submit(n, 3, FULL) for n in nonces]
        eng.start()
        for n, s in zip(nonces, slots):
            secret = s.result(timeout=120)
            assert secret is not None and puzzle.check_secret(n, secret, 3)
    finally:
        eng.close()
    assert m.get("sched.slots_preempted") > 0


def test_engine_falls_back_for_unsupported_shapes():
    calls = []

    class Fallback:
        def search(self, nonce, ntz, tbs, cancel_check=None):
            calls.append((bytes(nonce), ntz, tuple(tbs)))
            return b"\xfa\x11"

    m = Metrics()
    eng = _engine(m, fallback=Fallback())
    try:
        assert eng.search(b"\x01", 1, [3, 4, 5]) == b"\xfa\x11"
        assert eng.search(b"\x01", 33, FULL) == b"\xfa\x11"
        assert len(calls) == 2
        assert m.get("sched.fallback_searches") == 2
        assert not eng.supports(1, [3, 4, 5])
        assert eng.supports(1, FULL)
    finally:
        eng.close()


def test_new_slots_inherit_vtime_floor_no_starvation():
    eng = _engine(Metrics(), max_slots=1, start=False)
    try:
        hard = eng.submit(b"\xde\xad", 5, FULL)
        eng.start()
        deadline = time.time() + 30
        while time.time() < deadline and hard.launches < 2:
            time.sleep(0.01)
        assert hard.launches >= 2
        late = eng.submit(bytes([0x52, 1]), 1, FULL)
        assert late.vtime >= eng.batch, "late slot joined at vtime 0"
        secret = late.result(timeout=60)
        assert secret is not None and puzzle.check_secret(bytes([0x52, 1]), secret, 1)
        l0 = hard.launches
        deadline = time.time() + 30
        while time.time() < deadline and hard.launches <= l0:
            time.sleep(0.01)
        assert hard.launches > l0, "hard slot starved after rotation"
        hard.cancel()
        assert hard.result(timeout=30) is None
    finally:
        eng.close()


def test_mixed_hash_slots_share_launch_with_parity():
    m = Metrics()
    eng = _engine(m, max_slots=8, extra_models=("sha1",), start=False)
    reqs = [("sha1" if i % 2 else "md5", bytes([0x91, i])) for i in range(8)]
    slots = [eng.submit(nonce, 3, FULL, hash_model=model) for model, nonce in reqs]
    eng.start()
    try:
        for (model, nonce), s in zip(reqs, slots):
            secret = s.result(timeout=180)
            oracle = puzzle.python_search(nonce, 3, FULL, algo=model)
            assert secret == oracle, (model, nonce, secret, oracle)
        launches = m.get("sched.launches")
        occ = m.get_observed("sched.batch_occupancy")
        assert occ["count"] == launches and occ["sum"] / occ["count"] > 1
        assert m.get("sched.mixed_hash_launches") >= 1
        assert launches < 8 * 2
        assert m.get("sched.lane_launches.torch") >= launches
    finally:
        eng.close()


def test_mixed_hash_unadmitted_model_routes_solo_with_parity():
    m = Metrics()
    eng = _engine(m, start=False)
    try:
        assert not eng.supports(2, FULL, hash_model="sha1")
        got = eng.search(b"\x92\x01", 2, FULL, hash_model="sha1")
        assert got == puzzle.python_search(b"\x92\x01", 2, FULL, algo="sha1")
        assert m.get("sched.fallback_searches") == 1
    finally:
        eng.close()


def test_mixed_hash_impractical_model_never_admitted():
    eng = _engine(Metrics(), extra_models=("sha512",), start=False)
    try:
        assert "sha512" not in eng.models
        assert not eng.supports(2, FULL, hash_model="sha512")
        with pytest.raises(ValueError, match="never admitted"):
            eng.search(b"\x92\x02", 2, FULL, hash_model="sha512")
    finally:
        eng.close()


def test_engine_close_unblocks_waiters():
    eng = _engine(Metrics(), start=False)
    slot = eng.submit(b"\x99", 5, FULL)
    eng.close()
    assert slot.result(timeout=5) is None


def _slot_set(engine):
    """A deterministic slot set: two models, difficulties 1-3, power-of-two
    partitions, more slots than the table holds (preemption)."""
    reqs = [("md5", b"\x10\x20", 3, FULL), ("sha1", b"\x11", 2, list(range(64, 128))),
            ("md5", b"\x12\x34\x56", 2, list(range(16))), ("md5", b"\x13", 3, FULL),
            ("sha1", b"\x14\x15", 3, list(range(128))), ("md5", b"\x16", 1, [200])]
    return [engine.submit(nonce, d, tbs, hash_model=model) for model, nonce, d, tbs in reqs]


def test_engine_matches_reference_engine_launch_for_launch():
    """The same slot set, submitted before the loop starts, through the
    reference's engine (JAX on the CPU, lane xla) and the port's: the same
    secret per slot, the same sched.launches, per-slot launches and
    preemptions."""
    from distpow_tpu.runtime.metrics import REGISTRY as JAX_REGISTRY
    from distpow_tpu.sched.engine import BatchingScheduler as JaxScheduler

    kw = dict(hash_model="md5", batch_size=1 << 10, max_slots=3, extra_models=("sha1",),
              start=False)
    ref = JaxScheduler(lane="xla", **kw)
    m = Metrics()
    port = BatchingScheduler(lane="torch", device="cpu", metrics=m, **kw)
    out = {}
    for name, eng, launches in (("ref", ref, lambda: JAX_REGISTRY.get("sched.launches")),
                                ("port", port, lambda: m.get("sched.launches"))):
        before = launches()
        slots = _slot_set(eng)
        eng.start()
        try:
            secrets = [s.result(timeout=300) for s in slots]
        finally:
            eng.close()
        out[name] = (secrets, launches() - before, [s.launches for s in slots],
                     [s.preemptions for s in slots])
    assert all(s is not None for s in out["port"][0])
    assert out["port"] == out["ref"]
    assert sum(out["port"][3]) > 0  # the set exercised preemption


def test_failing_group_step_kills_the_loop_instead_of_demoting():
    """A group step that raises (a build or launch failure) is not demoted to
    the plain step: the loop dies, every slot finishes with the error, and
    sched.loop_failures counts it; later searches go to the fallback."""
    m = Metrics()

    class Fallback:
        def search(self, nonce, ntz, tbs, cancel_check=None):
            return b"\xfa"

    eng = _engine(m, lane="cuda", start=False, fallback=Fallback())

    def broken(lane, gdef, ops, batch):
        raise RuntimeError("md5_search group kernel launch failed: CUDA error 1")

    eng.planner.launch = broken
    slots = [eng.submit(bytes([0x70, i]), 2, FULL) for i in range(3)]
    eng.start()
    try:
        for s in slots:
            with pytest.raises(RuntimeError, match="scheduler loop died.*launch failed"):
                s.result(timeout=30)
        assert m.get("sched.loop_failures") == 1
        assert m.get("sched.lane_launches.torch") == 0
        assert m.get("sched.launches") == 0
        assert eng.search(b"\x71", 2, FULL) == b"\xfa"
        assert m.get("sched.fallback_searches") == 1
    finally:
        eng.close()


def test_cuda_lane_on_cpu_tensors_runs_the_wrappers_plain_version():
    """lane="cuda" on the CPU goes through the group kernel's wrapper, which
    runs its plain version for CPU tensors; answers equal the oracle, every
    group counts under the cuda lane, and each slot leaves a sched.slot span."""
    m = Metrics()
    eng = _engine(m, lane="pallas", max_slots=4, start=False)
    spans0 = SPANS.total_recorded
    nonces = [bytes([0x33, i]) for i in range(4)]
    slots = [eng.submit(n, 2, FULL) for n in nonces]
    eng.start()
    try:
        for n, s in zip(nonces, slots):
            assert s.result(timeout=60) == puzzle.python_search(n, 2, FULL)
        assert m.get("sched.lane_launches.cuda") == m.get("sched.launches") > 0
        assert m.get("sched.lane_launches.torch") == 0
        names = [sp["name"] for sp in SPANS.recent()[-(SPANS.total_recorded - spans0):]]
        assert names.count("sched.slot") >= 4
    finally:
        eng.close()


def test_scheduler_needs_a_gpu_unless_built_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this test describes a machine without one")
    with pytest.raises(RuntimeError, match="GPU"):
        BatchingScheduler(start=False)
    eng = BatchingScheduler(device="cpu", start=False)
    assert eng.lane == "auto" and eng.planner.rank((), eng.batch) == ("torch",)
    eng.close()


def test_cancel_from_another_thread_returns_none():
    eng = _engine(Metrics())
    flag = threading.Event()
    try:
        t = threading.Timer(0.2, flag.set)
        t.start()
        assert eng.search(b"\x55", 16, FULL, cancel_check=flag.is_set) is None
    finally:
        eng.close()


def _serve(eng, requests):
    """All requests submitted before the loop starts, so they share launches."""
    slots = [eng.submit(n, d, tbs, hash_model=m) for m, n, d, tbs in requests]
    eng.start()
    try:
        return [s.result(timeout=120) for s in slots]
    finally:
        eng.close()


@pytest.mark.parametrize("n_shards", [4, 3])
def test_mesh_lane_on_cpu_shards_gives_the_torch_lanes_secrets(n_shards):
    """The same requests on the torch lane and on the mesh lane over logical
    CPU shards: the same secrets (each the oracle's), and the mesh lane's
    launches cover n_shards x mesh_span() batches a slot, so it needs fewer;
    width 0 stays on the torch lane."""
    requests = [("md5", bytes([0x61, i]), 3, FULL) for i in range(4)] + \
        [("sha1", b"\x62\x01", 3, FULL), ("md5", b"\x63\x02", 3, list(range(64, 128)))]
    got = {}
    for lane, mesh in (("torch", None), ("mesh", make_mesh(["cpu"] * n_shards))):
        m = Metrics()
        eng = _engine(m, lane=lane, mesh=mesh, max_slots=8, start=False,
                      extra_models=("sha1",))
        got[lane] = (_serve(eng, requests), m.get("sched.launches"),
                     m.get("sched.lane_launches.mesh"), m.get("sched.lane_launches.torch"))
    secrets, launches, mesh_groups, torch_groups = got["mesh"]
    assert secrets == got["torch"][0]
    assert secrets == [puzzle.python_search(n, d, tbs, algo=m) for m, n, d, tbs in requests]
    assert mesh_groups > 0 and torch_groups > 0  # width 0 on the torch lane
    assert launches < got["torch"][1]
    assert got["torch"][2] == 0
