"""The port's worker node served by the reference's coordinator and client.

The harness is the reference's ``Stack`` (``tests/test_nodes.py``): a
reference ``Coordinator``, reference ``Client`` objects, and workers that
are the port's ``distpow_tpu_torch.nodes.Worker``, each on the CPU
(``device="cpu"``) with ``Backend: "cuda"``, so the kernel wrapper runs its
plain PyTorch version.  Every node records into its own ``MemorySink``.
The same scenarios also run with the reference's workers (``Backend:
"python"``), and the two runs' action sequences, node by node, must be
equal.  Besides: the golden trace replay with the port's ``worker1``, the
RPC-level checks (explicit ranges, mixed-hash refusals, ``Stats``), the
device and ``JaxCoordinator`` refusals, ``CompilationCacheDir``, the boot
warm-up and its failure, and ``FleetRegister`` against the reference
coordinator's ``Fleet`` service.  Inputs are fixed nonces and ones drawn
from a numpy seed; every comparison is exact.
"""

import json
import os
import queue
import threading
import time

import numpy as np
import pytest

from distpow_tpu.models import puzzle as ref_puzzle
from distpow_tpu.nodes import Client, Coordinator
from distpow_tpu.nodes import Worker as RefWorker
from distpow_tpu.runtime.config import ClientConfig, CoordinatorConfig
from distpow_tpu.runtime.config import WorkerConfig as RefWorkerConfig
from distpow_tpu.runtime.rpc import RPCClient as RefRPCClient
from distpow_tpu.runtime.rpc import RPCError as RefRPCError
from distpow_tpu.runtime.tracing import MemorySink as RefMemorySink
from distpow_tpu_torch.backends.cuda_backend import CudaBackend
from distpow_tpu_torch.nodes import Worker
from distpow_tpu_torch.ops import _build
from distpow_tpu_torch.runtime.config import WorkerConfig
from distpow_tpu_torch.runtime.metrics import REGISTRY
from distpow_tpu_torch.runtime.tracing import MemorySink

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261017
# a CPU-sized worker: small batch and launch, no boot warm-up
CPU_WORKER = {"Backend": "cuda", "BatchSize": 1 << 12, "MaxLaunchCandidates": 1 << 14,
              "WarmupNonceLens": [], "WarmupWidths": []}


def _node_sequence(sink):
    """A node's ordered actions: trace id, action name, nonce, difficulty
    (the golden trace's form, ``tests/test_trace_parity.py``)."""
    seq = []
    for e in sink.events:
        if e["type"] != "action":
            continue
        b = e["body"]
        seq.append([e["trace_id"], e["action"],
                    bytes(b["Nonce"]).hex() if "Nonce" in b else None,
                    b.get("NumTrailingZeros")])
    return seq


class Stack:
    """The reference coordinator and clients with ``n_workers`` workers:
    the port's (``port=True``, on the CPU) or the reference's."""

    def __init__(self, n_workers, port=True, failure_policy="error", failure_probe_secs=0.2,
                 worker_extra=None):
        self.sinks = {"coordinator": RefMemorySink()}
        self.coordinator = Coordinator(
            CoordinatorConfig(ClientAPIListenAddr="127.0.0.1:0",
                              WorkerAPIListenAddr="127.0.0.1:0",
                              Workers=["pending:0"] * n_workers,
                              FailurePolicy=failure_policy,
                              FailureProbeSecs=failure_probe_secs),
            sink=self.sinks["coordinator"])
        client_addr, self.worker_api_addr = self.coordinator.initialize_rpcs()
        self.workers = []
        addrs = []
        for i in range(n_workers):
            wid = f"worker{i + 1}"
            fields = dict(WorkerID=wid, ListenAddr="127.0.0.1:0",
                          CoordAddr=self.worker_api_addr)
            if port:
                self.sinks[wid] = MemorySink()
                w = Worker(WorkerConfig(**fields, **{**CPU_WORKER, **(worker_extra or {})}),
                           sink=self.sinks[wid], device="cpu")
            else:
                self.sinks[wid] = RefMemorySink()
                w = RefWorker(RefWorkerConfig(**fields, Backend="python"),
                              sink=self.sinks[wid])
            addrs.append(w.initialize_rpcs())
            w.start_forwarder()
            self.workers.append(w)
        self.coordinator.set_worker_addrs(addrs)
        self.client_addr = client_addr
        self.clients = []

    def new_client(self, cid):
        self.sinks[cid] = RefMemorySink()
        c = Client(ClientConfig(ClientID=cid, CoordAddr=self.client_addr),
                   sink=self.sinks[cid])
        c.initialize()
        self.clients.append(c)
        return c

    def close(self):
        for c in self.clients:
            c.close()
        for w in self.workers:
            w.shutdown()
        self.coordinator.shutdown()

    def names(self, node):
        return [a[1] for a in self.sinks[node].actions()]

    def sequences(self):
        return {node: _node_sequence(sink) for node, sink in self.sinks.items()}


@pytest.fixture
def stack1():
    s = Stack(1)
    yield s
    s.close()


@pytest.fixture
def stack4():
    s = Stack(4)
    yield s
    s.close()


def mine_and_wait(client, nonce, ntz, timeout=60, hash_model=None):
    client.mine(nonce, ntz, hash_model=hash_model) if hash_model else client.mine(nonce, ntz)
    return client.notify_queue.get(timeout=timeout)


def _run_both(n_workers, scenario):
    """``scenario(stack)`` on the reference's workers, then on the port's;
    both runs' per-node action sequences and returns."""
    out = []
    for port in (False, True):
        s = Stack(n_workers, port=port)
        try:
            ret = scenario(s)
            time.sleep(0.2)  # the last round's ACKs land before the sinks are read
            out.append((s.sequences(), ret))
        finally:
            s.close()
    return out


def _seeded_nonces(n, seed=SEED):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(1, 9)), dtype=np.uint8).tobytes()
            for _ in range(n)]


# -- end to end, held to the reference's workers -----------------------------

def test_single_worker_end_to_end_matches_reference_workers():
    nonces = _seeded_nonces(3)

    def scenario(s):
        client = s.new_client("client1")
        return [mine_and_wait(client, n, 2 + i % 2).secret for i, n in enumerate(nonces)]

    (ref_seq, ref_secrets), (port_seq, port_secrets) = _run_both(1, scenario)
    assert port_secrets == ref_secrets
    for i, (nonce, secret) in enumerate(zip(nonces, port_secrets)):
        assert secret == ref_puzzle.python_search(nonce, 2 + i % 2, list(range(256)))
    assert port_seq == ref_seq
    # one Mine's worker actions, in the reference's order (worker.go:169-401)
    per_trace = {}
    for tid, name, _, _ in port_seq["worker1"]:
        per_trace.setdefault(tid, []).append(name)
    # (Found installs the winner, CacheAdd, before it releases the miner)
    assert list(per_trace.values()) == [
        ["WorkerMine", "CacheMiss", "WorkerResult", "CacheAdd", "WorkerCancel"]] * 3


def test_single_worker_actions(stack1):
    client = stack1.new_client("client1")
    res = mine_and_wait(client, b"\x01\x02\x03\x04", 3)
    assert res.error is None
    assert res.secret == ref_puzzle.python_search(b"\x01\x02\x03\x04", 3, list(range(256)))
    assert stack1.names("client1") == [
        "PowlibMiningBegin", "PowlibMine", "PowlibSuccess", "PowlibMiningComplete"]
    coord = stack1.names("coordinator")
    assert coord[:2] == ["CoordinatorMine", "CacheMiss"] and coord[-1] == "CoordinatorSuccess"
    assert stack1.names("worker1") == ["WorkerMine", "CacheMiss", "WorkerResult", "CacheAdd",
                                       "WorkerCancel"]
    snap = REGISTRY.snapshot()
    assert snap["histograms"]["worker.solve_s"]["count"] >= 1
    assert snap["histograms"]["worker.solve_s.md5"]["count"] >= 1


def test_four_workers_partition_and_ledger_match_reference_workers():
    nonces = _seeded_nonces(2, SEED + 1)

    def scenario(s):
        client = s.new_client("client1")
        got = [mine_and_wait(client, n, 2).secret for n in nonces]
        coord = s.names("coordinator")
        assert coord.count("CoordinatorWorkerMine") == 8
        assert coord.count("CoordinatorWorkerCancel") % 4 == 0
        for i in range(4):
            wk = s.names(f"worker{i + 1}")
            assert wk[0] == "WorkerMine" and "WorkerCancel" in wk
            if "WorkerResult" in wk:
                assert "WorkerCancel" in wk[wk.index("WorkerResult"):]
        return got

    (_, ref_secrets), (_, port_secrets) = _run_both(4, scenario)
    for nonce, secret in zip(nonces, port_secrets):
        assert ref_puzzle.check_secret(nonce, secret, 2)
    # the four shards race, so the winner may differ; each is a valid
    # first hit of its own shard (worker_bits 2: first byte's top two bits)
    for secret in port_secrets + ref_secrets:
        assert secret is not None


def test_cancelled_miners_send_two_nil_acks(stack4):
    """Every worker that lost the race cancels with two nil ACKs
    (worker.go:320-345); the coordinator's 2N-ack ledger then completes
    and a second request runs cleanly."""
    client = stack4.new_client("client1")
    res = mine_and_wait(client, b"\x05\x06\x07\x08", 3)
    assert ref_puzzle.check_secret(res.nonce, res.secret, 3)
    assert stack4.coordinator.handler._tasks == {}
    res2 = mine_and_wait(client, b"\x09\x0a", 2)
    assert ref_puzzle.check_secret(res2.nonce, res2.secret, 2)
    for w in stack4.workers:
        assert w.handler._tasks == {}


def test_cache_hit_skips_fanout(stack1):
    client = stack1.new_client("client1")
    mine_and_wait(client, b"\x21\x22", 2)
    n_mines = stack1.names("coordinator").count("CoordinatorWorkerMine")
    res2 = mine_and_wait(client, b"\x21\x22", 2)
    assert ref_puzzle.check_secret(res2.nonce, res2.secret, 2)
    coord = stack1.names("coordinator")
    assert coord.count("CoordinatorWorkerMine") == n_mines
    assert coord[-2:] == ["CacheHit", "CoordinatorSuccess"]


def test_worker_cache_hit_replays_the_found_path(stack1):
    client = stack1.new_client("client1")
    nonce = b"\x61\x62"
    mine_and_wait(client, nonce, 2)
    time.sleep(0.2)
    stack1.coordinator.handler.result_cache._entries.clear()
    mine_and_wait(client, nonce, 2)
    wk = stack1.names("worker1")
    hit = wk.index("CacheHit")
    assert wk[hit:hit + 2] == ["CacheHit", "WorkerResult"]
    assert wk[-1] == "WorkerCancel"


def test_dominance_supersede_matches_reference_workers():
    nonce = b"\x02\x02\x02\x02"

    def scenario(s):
        client = s.new_client("client1")
        r1 = mine_and_wait(client, nonce, 2)
        r2 = mine_and_wait(client, nonce, 3)
        coord = s.names("coordinator")
        assert coord.count("CoordinatorWorkerMine") == 2 and "CacheRemove" in coord
        assert s.coordinator.handler.result_cache.peek(nonce).num_trailing_zeros >= 3
        return [r1.secret, r2.secret]

    (ref_seq, ref_secrets), (port_seq, port_secrets) = _run_both(1, scenario)
    assert port_secrets == ref_secrets
    assert port_seq == ref_seq


def test_duplicate_concurrent_mine_same_key(stack1):
    client = stack1.new_client("client1")
    nonce = b"\x51\x52"
    client.mine(nonce, 3)
    client.mine(nonce, 3)
    for _ in range(2):
        r = client.notify_queue.get(timeout=60)
        assert ref_puzzle.check_secret(nonce, r.secret, 3)


def test_failed_mine_does_not_leak_task_entry():
    s = Stack(1, failure_policy="reassign", failure_probe_secs=0.1)
    try:
        s.workers[0].shutdown()
        client = s.new_client("client1")
        client.mine(b"\x69\x6a", 2)  # the only worker is dead: the Mine errors
        r = client.notify_queue.get(timeout=10.0)
        assert r.secret is None and r.error is not None
        deadline = time.time() + 5
        while s.coordinator.handler._tasks and time.time() < deadline:
            time.sleep(0.05)
        assert s.coordinator.handler._tasks == {}
    finally:
        s.close()


def test_mesh_backend_worker_serves_through_the_protocol():
    """``Backend: "pallas-mesh"`` on four logical CPU shards: the mesh
    kernels' wrapper (its plain version here) serves a Mine end to end."""
    s = Stack(1, worker_extra={"Backend": "pallas-mesh", "MeshDevices": 4})
    try:
        assert type(s.workers[0].handler.backend).__name__ == "CudaMeshBackend"
        client = s.new_client("client1")
        res = mine_and_wait(client, b"\x6a\x6b", 3)
        assert res.error is None
        assert res.secret == ref_puzzle.python_search(b"\x6a\x6b", 3, list(range(256)))
    finally:
        s.close()


def test_golden_trace_demo_replay_with_port_worker():
    """The reference demo's four requests, sequentially (the scenario of
    ``tests/test_trace_parity.py::test_golden_trace_demo_replay``), with
    ``worker1`` the port's: every node's action sequence equals the golden
    file's."""
    s = Stack(1)
    try:
        c1 = s.new_client("client1")
        c2 = s.new_client("client2")
        mine_and_wait(c1, bytes([1, 2, 3, 4]), 4)
        mine_and_wait(c1, bytes([5, 6, 7, 8]), 2)
        mine_and_wait(c2, bytes([2, 2, 2, 2]), 2)
        mine_and_wait(c2, bytes([2, 2, 2, 2]), 4)  # dominance supersede
        with open(os.path.join(HERE, "golden_trace.json")) as fh:
            golden = json.load(fh)
        for node in ("client1", "client2", "coordinator", "worker1"):
            assert _node_sequence(s.sinks[node]) == golden[node], node
    finally:
        s.close()


# -- the worker's RPCs --------------------------------------------------------

def _rpc_worker(**extra):
    """One port worker whose results go to a stand-in coordinator that
    queues them; returns (worker, client to it, results queue, stop)."""
    from distpow_tpu_torch.runtime.rpc import RPCServer

    results = queue.Queue()

    class CoordRPCHandler:
        def Result(self, params):
            results.put(params)
            return {}

    coord = RPCServer()
    coord.register("CoordRPCHandler", CoordRPCHandler())
    addr = coord.listen("127.0.0.1:0")
    coord.serve_in_background()
    w = Worker(WorkerConfig(WorkerID="worker1", ListenAddr="127.0.0.1:0", CoordAddr=addr,
                            **{**CPU_WORKER, **extra}),
               sink=MemorySink(), device="cpu")
    waddr = w.initialize_rpcs()
    w.start_forwarder()
    client = RefRPCClient(waddr)

    def stop():
        client.close()
        w.shutdown()
        coord.shutdown()

    return w, client, results, stop


def _mine_params(w, nonce, ntz, **extra):
    from distpow_tpu_torch.runtime.tracing import wire_token

    tr = w.tracer.create_trace()
    return {"nonce": list(nonce), "num_trailing_zeros": ntz, "worker_byte": 0,
            "worker_bits": 0, "token": wire_token(tr.generate_token()), **extra}


@pytest.mark.parametrize("tb_lo,tb_count", [(0, 0), (-1, 4), (256, 1), (200, 57), (0, 257)])
def test_invalid_explicit_range_is_refused_in_the_rpc(tb_lo, tb_count):
    w, client, results, stop = _rpc_worker()
    try:
        with pytest.raises(RefRPCError, match="invalid weighted shard range"):
            client.call("WorkerRPCHandler.Mine",
                        _mine_params(w, b"\x01\x02", 2, tb_lo=tb_lo, tb_count=tb_count))
        assert w.handler._tasks == {}
        assert results.empty()
    finally:
        stop()


def test_explicit_range_serves_its_slice():
    w, client, results, stop = _rpc_worker()
    try:
        nonce = b"\x71\x72"
        client.call("WorkerRPCHandler.Mine", _mine_params(w, nonce, 2, tb_lo=64, tb_count=32))
        res = results.get(timeout=60)
        secret = bytes(res["secret"])
        assert secret == ref_puzzle.python_search(nonce, 2, list(range(64, 96)))
        client.call("WorkerRPCHandler.Found", {**_mine_params(w, nonce, 2), "secret": secret})
        ack = results.get(timeout=10)
        assert ack["secret"] is None
    finally:
        stop()


@pytest.mark.parametrize("model,refusal", [
    ("nope", "unknown hash_model"),
    ("sha512", "never admitted"),
    ("sha1", "no batching scheduler"),
])
def test_mixed_hash_refusals_in_the_rpc(model, refusal):
    # sha1 is refused by a worker without the scheduler; the others by one with it
    extra = {} if model == "sha1" else {"Scheduler": "batching", "SchedLane": "torch"}
    w, client, results, stop = _rpc_worker(**extra)
    try:
        with pytest.raises(RefRPCError, match=refusal):
            client.call("WorkerRPCHandler.Mine",
                        _mine_params(w, b"\x01\x02", 2, hash_model=model))
        assert w.handler._tasks == {}
    finally:
        stop()


def test_mixed_hash_mine_through_the_batching_scheduler():
    s = Stack(1, worker_extra={"Scheduler": "batching", "SchedLane": "torch",
                               "SchedHashModels": ["sha1"]})
    try:
        client = s.new_client("client1")
        for model, nonce in (("sha1", b"\x81\x82"), ("md5", b"\x83\x84")):
            res = mine_and_wait(client, nonce, 2, hash_model=model)
            assert res.error is None
            assert res.secret == ref_puzzle.python_search(nonce, 2, list(range(256)),
                                                          algo=model)
        w = s.workers[0]
        assert w.scheduler is not None and w.scheduler.lane == "torch"
        stats = RefRPCClient(w.bound_addr)
        try:
            snap = stats.call("WorkerRPCHandler.Stats", {})
        finally:
            stats.close()
        assert snap["scheduler"] == "batching"
        assert snap["counters"].get("sched.lane_launches.torch", 0) > 0
    finally:
        s.close()


def test_stats_rpc():
    w, client, results, stop = _rpc_worker(DeviceHangTimeoutS=30.0)
    try:
        snap = client.call("WorkerRPCHandler.Stats", {})
        assert snap["role"] == "worker" and snap["backend"] == "CudaBackend"
        assert snap["device"] == "cpu" and snap["scheduler"] == "off"
        assert snap["watchdog_armed"] is True
        assert snap["active_tasks"] == 0 and snap["cache_entries"] == 0
        assert "proc.rss_bytes" in snap["gauges"]
        # the role-agnostic alias the fleet scraper uses
        assert client.call("Node.Stats", {})["role"] == "worker"
        assert client.call("WorkerRPCHandler.Ping", {}) == {"worker_tasks": 0}
    finally:
        stop()


# -- construction ---------------------------------------------------------------

def test_worker_without_device_raises_on_a_host_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the worker runs on it")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        Worker(WorkerConfig(**CPU_WORKER))
    with pytest.raises(RuntimeError, match="needs a GPU"):
        Worker(WorkerConfig(Backend="python"))


def test_jax_coordinator_raises_naming_the_multi_host_item():
    with pytest.raises(ValueError, match="Queue 1 item 6"):
        Worker(WorkerConfig(JaxCoordinator="127.0.0.1:1234", JaxNumProcesses=2,
                            **CPU_WORKER), device="cpu")


@pytest.mark.parametrize("name", ["auto", "pallas", "jax", "cuda"])
def test_reference_backend_names_give_the_kernel_backend(name):
    w, client, results, stop = _rpc_worker(Backend=name)
    try:
        assert type(w.handler.backend) is CudaBackend
        assert w.handler.backend.device.type == "cpu"
    finally:
        stop()


def test_compilation_cache_dir_is_the_kernel_build_dir(tmp_path):
    before = _build.BUILD_DIR
    try:
        w, client, results, stop = _rpc_worker(CompilationCacheDir=str(tmp_path / "kernels"))
        stop()
        assert _build.BUILD_DIR == str(tmp_path / "kernels")
        assert os.path.dirname(_build.library_path("sha1_search")) == str(tmp_path / "kernels")
    finally:
        _build.set_build_dir(before)


def test_boot_warmup_runs_in_the_background():
    w, client, results, stop = _rpc_worker(WarmupNonceLens=[2], WarmupWidths=[0, 1, 2])
    try:
        assert w.warmed.wait(60)
        assert w.warmup_error is None and w.warmup_s > 0
    finally:
        stop()


def test_failed_warmup_is_counted_and_the_first_mine_raises(monkeypatch):
    """A warm-up failure does not stop the boot; it is logged and counted,
    and the Mine path raises the error itself instead of swallowing it."""
    def broken(self, *a, **k):
        raise RuntimeError("nvcc failed (1): stand-in build error")

    monkeypatch.setattr(CudaBackend, "warmup", broken)
    monkeypatch.setattr(CudaBackend, "search", broken)
    failures = REGISTRY.get("worker.warmup_failures")
    w, client, results, stop = _rpc_worker(WarmupNonceLens=[2], WarmupWidths=[0])
    try:
        assert w.warmed.wait(10)
        assert "stand-in build error" in str(w.warmup_error)
        assert REGISTRY.get("worker.warmup_failures") == failures + 1
        errors = []
        hook = threading.excepthook
        threading.excepthook = lambda args: errors.append(args.exc_value)
        try:
            client.call("WorkerRPCHandler.Mine", _mine_params(w, b"\x01", 2))
            deadline = time.time() + 10
            while not errors and time.time() < deadline:
                time.sleep(0.02)
        finally:
            threading.excepthook = hook
        assert errors and "stand-in build error" in str(errors[0])
        assert results.empty()
    finally:
        stop()


# -- the fleet -------------------------------------------------------------------

def test_fleet_register_with_the_reference_coordinator():
    """Two port workers join a reference coordinator's fleet by
    ``Fleet.Register`` at advertised rates 8 and 2 MH/s; the weighted round
    ships explicit ranges and the fast worker owns the larger one."""
    s = Stack(0, failure_policy="reassign")
    joined = []
    try:
        for wid, mhs in (("fast", 8.0), ("slow", 2.0)):
            w = Worker(WorkerConfig(WorkerID=wid, ListenAddr="127.0.0.1:0",
                                    CoordAddr=s.worker_api_addr, FleetRegister=True,
                                    FleetHeartbeatS=0.2, FleetCalibrationS=0.0, FleetMHS=mhs,
                                    **CPU_WORKER),
                       sink=MemorySink(), device="cpu")
            joined.append(w)
            w.initialize_rpcs()
            w.start_forwarder()
            w.start_fleet_agent()
            assert w.fleet_agent.wait_registered(timeout=10.0)
        calls = {}
        for w in joined:
            orig = w.handler.Mine

            def wrapped(params, _orig=orig, _id=w.config.WorkerID):
                calls.setdefault(_id, []).append(dict(params))
                return _orig(params)

            w.handler.Mine = wrapped
        members = s.coordinator.handler.fleet.members()
        assert sorted(m["worker_id"] for m in members) == ["fast", "slow"]
        client = s.new_client("client1")
        res = mine_and_wait(client, b"\x41\x02", 2)
        assert res.error is None and ref_puzzle.check_secret(res.nonce, res.secret, 2)
        f, sl = calls["fast"][0], calls["slow"][0]
        assert f["tb_count"] >= 3 * sl["tb_count"]
        assert f["tb_count"] + sl["tb_count"] == 256
    finally:
        for w in joined:
            w.shutdown()
        s.close()
