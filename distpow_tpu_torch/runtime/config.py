"""Per-node JSON configuration (SURVEY.md section 2 component 14).

Field names match the reference's config JSON exactly
(config/client_config.json, config/coordinator_config.json,
config/worker_config.json, config/tracing_server_config.json via
``ReadJSONConfig``, config.go:8-18) so existing reference config files
load unchanged.  TPU-specific extensions are additive with defaults:

* ``WorkerConfig.Backend``   — miner backend: ``jax`` (single device,
  default), ``jax-mesh`` (shard_map over all local devices), ``pallas``
  / ``pallas-mesh`` (the hand-written TPU kernels), ``python``
  (hashlib loop, the CPU-parity baseline), ``native`` (C++ miner), or
  ``auto`` (resolve from the hardware at boot — the kernels on TPU,
  mesh when multi-device; backends/__init__.py ``get_backend``).
* ``WorkerConfig.HashModel`` — any registry model
  (models/registry.py): ``md5`` (reference parity, default),
  ``sha256`` (north-star variant), ``sha1``, ``ripemd160``,
  ``sha512``, ``sha384``, ``sha3_256``, ``blake2b_256``, or
  ``sha256d`` (double SHA-256, Bitcoin's PoW digest).
* ``WorkerConfig.BatchSize`` — candidates per device launch.

Unknown JSON fields are ignored (forward compatibility); missing fields
take dataclass defaults.

The port's own copy of the reference's ``runtime/config.py``
(``distpow_tpu/runtime/config.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Type, TypeVar

T = TypeVar("T")


def _decode_secret(v) -> bytes:
    """Reference configs store TracerSecret as a base64-ish JSON string
    (Go unmarshals ``string`` -> ``[]byte`` via base64); accept str, list
    of ints, or empty."""
    if v is None or v == "":
        return b""
    if isinstance(v, str):
        try:
            return base64.b64decode(v)
        except ValueError:  # binascii.Error — not base64: raw-string secret
            return v.encode()
    return bytes(v)


@dataclass
class ClientConfig:
    ClientID: str = "client1"
    CoordAddr: str = ""
    TracerServerAddr: str = ""
    TracerSecret: bytes = b""
    ChCapacity: int = 10  # client.go:9
    # --- TPU-native extensions -------------------------------------------
    # Coordinator-outage resilience (nodes/powlib.py): a transport-level
    # Mine failure is retried with jittered exponential backoff and a
    # shared coordinator re-dial.  Each failed attempt consumes one unit
    # of MineRetries; a successful re-dial restores the full budget; an
    # exhausted budget delivers a terminal "degraded: ..." error result.
    MineRetries: int = 4
    MineBackoffS: float = 0.2
    MineBackoffMaxS: float = 2.0
    # Per-attempt bound on waiting for the Mine response.  0 = wait
    # forever (the default — a legitimate mine can run arbitrarily long,
    # so only chaos/ops configs that must detect silently-dropped frames
    # should set this).
    MineAttemptTimeoutS: float = 0.0
    # --- coordinator pool (distpow_tpu/cluster/, docs/CLUSTER.md) --------
    # Client-facing addresses of the WHOLE coordinator pool, in shard
    # order — the ring seeds.  Non-empty with >= 2 entries flips powlib
    # into cluster mode: consistent-hash owner routing, hedged sibling
    # retry on RETRY_AFTER, ring-guided failover.  Empty (default)
    # keeps the single-coordinator behavior byte-identical.
    CoordAddrs: List[str] = field(default_factory=list)
    # Deterministic fault-injection plan (runtime/faults.py); empty = no
    # injection.  Also reachable via $DISTPOW_FAULTS and --faults.
    FaultPlanFile: str = ""


@dataclass
class CoordinatorConfig:
    ClientAPIListenAddr: str = ""
    WorkerAPIListenAddr: str = ""
    Workers: List[str] = field(default_factory=list)
    TracerServerAddr: str = ""
    TracerSecret: bytes = b""
    # --- TPU-native extensions -------------------------------------------
    # Checkpoint/resume: JSONL journal for the dominance result cache; a
    # restarted coordinator resumes warm (the reference starts cold,
    # coordinator.go:105-108).  Empty = in-memory only.
    CacheFile: str = ""
    # Failure handling for worker RPC errors mid-protocol:
    #   "error"    — reference parity: the Mine RPC fails on any worker
    #                error, no retry (coordinator.go:196-198, 227-229).
    #   "reassign" — failure recovery: dead workers are detected (failed
    #                calls + liveness probes while waiting) and their
    #                search-space shard is reassigned to a live worker;
    #                the ack ledger drops expectations from the dead.
    FailurePolicy: str = "error"
    # Probe cadence (seconds) while blocked on worker results in
    # "reassign" mode.
    FailureProbeSecs: float = 1.0
    # Deterministic fault-injection plan (runtime/faults.py); empty = no
    # injection.  Also reachable via $DISTPOW_FAULTS and --faults.
    FaultPlanFile: str = ""
    # Flight-recorder directory (runtime/telemetry.py): periodic
    # append-only JSONL journal of recent annotated events plus
    # dump-on-fault snapshots land here.  Empty = memory-only ring.
    # Also reachable via $DISTPOW_TELEMETRY_DIR.
    TelemetryDir: str = ""
    # --- scheduler plane (distpow_tpu/sched/, docs/SCHEDULER.md) ---------
    # Admission control: maximum concurrently fanned-out miss rounds.
    # A Mine arriving beyond the bound is rejected with a typed
    # RETRY_AFTER reply (sched/admission.py) that powlib's backoff
    # machinery consumes as a server-paced, non-counting retry.
    # 0 = unbounded (reference-parity default).
    SchedMaxInflight: int = 0
    # Retry-after hint (seconds) carried by admission rejections.
    SchedRetryAfterS: float = 0.5
    # In-flight coalescing of identical (nonce, ntz) Mine requests into
    # one fan-out round with a multi-waiter reply (sched/coalesce.py).
    # On by default: it is a scheduling upgrade of the documented
    # per-key-mutex duplicate fix with identical trace shapes.
    SchedCoalesce: bool = True
    # --- elastic fleet (distpow_tpu/fleet/, docs/FLEET.md) ---------------
    # Lease TTL for Fleet.Register members: a worker whose heartbeats
    # stop for this long is retired from membership and its shards ride
    # the existing orphan-reassignment path.  Static config workers are
    # permanent leases and never expire.
    FleetLeaseTTLS: float = 10.0
    # Straggler hedging: while a round waits for its first result, a
    # shard whose heartbeat-lease owner has been silent for longer than
    # FleetHedgeMultiple x the fleet's median heartbeat interval gets a
    # duplicate Mine on the least-loaded live worker (first result
    # wins).  Only heartbeat leases can trip it, so static fleets are
    # unaffected.
    FleetHedge: bool = True
    FleetHedgeMultiple: float = 3.0
    # Bound on how long one Fleet.Drain call may wait for the leaving
    # worker's in-flight rounds to finish before releasing the lease
    # anyway.
    FleetDrainTimeoutS: float = 20.0
    # --- request forensics (runtime/spans.py, docs/FORENSICS.md) ---------
    # Slow-request auto-capture: a completed Mine miss slower than this
    # fixed budget (seconds) captures its span tree into the flight
    # recorder.  0 = arm the fixed-threshold trigger off.
    ForensicsSlowS: float = 0.0
    # Rolling-p99 exceedance arm: a miss slower than this multiple of
    # the rolling p99 over recent misses is captured even when the
    # fixed budget is generous.  0 = off.  Both arms off (the default)
    # disables the trigger entirely.
    ForensicsSlowP99X: float = 0.0
    # --- coordinator pool (distpow_tpu/cluster/, docs/CLUSTER.md) --------
    # Client-facing addresses of the whole pool in shard order (this
    # coordinator's own entry included) — the consistent-hash ring is a
    # pure function of this list, so every member and every client
    # computes the identical ring.  Empty (default) = single
    # coordinator, byte-identical to every earlier version.
    ClusterPeers: List[str] = field(default_factory=list)
    # This coordinator's index into ClusterPeers (its ring member id is
    # "c<index>").  Required (>= 0) when ClusterPeers is set.
    ClusterSelf: int = -1
    # --- cache replication / HA (cluster/replication.py) -----------------
    # Ring successors each dominance-cache entry is write-behind
    # replicated to (docs/CLUSTER.md "Replication & HA").  0 disables
    # the write-behind pushes and anti-entropy (warm handoff on ring
    # change still runs — it is an ownership-move, not a replica,
    # concern).  Only meaningful when ClusterPeers is set; single
    # coordinators never replicate.
    ClusterCacheReplicas: int = 1
    # Bound on the write-behind push queue: replication stays off the
    # Mine critical path, so a slower-than-traffic successor overflows
    # the queue and the overflow is DROPPED (counted in
    # repl.push_failures; anti-entropy heals it later).
    ClusterReplQueueDepth: int = 1024
    # Anti-entropy cadence (seconds): each sweep exchanges per-ring-
    # range digests with the successors and pushes only diverged
    # ranges.  0 = off.
    ClusterAntiEntropyS: float = 5.0
    # Bound on one warm shard handoff (seconds): a frozen recipient
    # costs at most this before the ring change proceeds without it
    # (anti-entropy backfills what the deadline cut off).
    ClusterHandoffDeadlineS: float = 5.0


@dataclass
class WorkerConfig:
    WorkerID: str = "worker1"
    ListenAddr: str = ""
    CoordAddr: str = ""
    TracerServerAddr: str = ""
    TracerSecret: bytes = b""
    # --- TPU-native extensions -------------------------------------------
    Backend: str = "jax"
    HashModel: str = "md5"
    BatchSize: int = 1 << 20
    MeshDevices: int = 0  # 0 = all local devices (jax-mesh backend)
    # Candidates one device dispatch should cover (sub-batches of
    # BatchSize run in an on-device loop).  Dispatch+result-fetch costs a
    # host<->device round trip, so this bounds both the amortization of
    # that cost and the cancellation latency (one launch).  0 = framework
    # default: 2^30 scaled down by the model's measured cost so one
    # launch is ~0.1-0.25 s of device work for EVERY hash model
    # (parallel/search.py scaled_launch_candidates).
    MaxLaunchCandidates: int = 0
    # Pre-compile the layout-keyed search programs for these nonce byte
    # lengths at boot (background thread), so the first Mine RPC is pure
    # dispatch.  The compiled programs are nonce-content-, difficulty- and
    # partition-independent (ops/search_step.py dynamic regime); only the
    # nonce *length* and chunk width key the compile.  Empty list = no
    # warmup.
    WarmupNonceLens: List[int] = field(default_factory=lambda: [2, 4])
    WarmupWidths: List[int] = field(default_factory=lambda: [0, 1, 2, 3, 4])
    # Checkpoint/resume: JSONL journal for the worker's dominance cache
    # (the reference's worker cache is memory-only, worker.go:98-101).
    # Empty = in-memory only.
    CacheFile: str = ""
    # Persistent XLA compilation cache directory: warmup compiles
    # (~10-12s for the full width set on TPU) are paid once per machine
    # instead of once per boot.  Empty = no persistent cache.
    CompilationCacheDir: str = ""
    # Device-hang watchdog (runtime/watchdog.py): if a device-driving
    # section (search launch/drain, a warmup compile) makes no progress
    # for this many seconds, the worker exits with a distinctive code
    # (EXIT_CODE 43) so the coordinator's FailurePolicy="reassign" can
    # redirect its shards — a hung accelerator dispatch otherwise leaves
    # a zombie that still answers liveness probes.  Must exceed the
    # worst-case single compile (20-60s cold), not one launch; 300 is a
    # conservative floor.  0 = disabled (reference parity).
    DeviceHangTimeoutS: float = 0.0
    # Multi-host mesh: when JaxCoordinator is set,
    # jax.distributed.initialize runs before the backend is built, so a
    # jax-mesh worker's shard_map spans every chip of a multi-host slice
    # (collectives over ICI within a host, DCN across).  The --jax-*
    # worker CLI flags override these.
    JaxCoordinator: str = ""
    JaxNumProcesses: int = 1
    JaxProcessId: int = 0
    # Serving loop for the single-device XLA backend (docs/SERVING.md):
    # "persistent" (default) drives the multi-segment on-device search
    # loop with a polling drain — the host never blocks inside a
    # per-launch result fetch; "serial" keeps the pre-persistent
    # launch/fetch/relaunch loop (the bench.py --serving-loop baseline
    # and the escape hatch).
    SearchLoop: str = "persistent"
    # Dev-only: run the pallas/pallas-mesh kernels in interpret mode so
    # kernel-backed workers can serve off-TPU (CI, the CPU mesh demo).
    # Orders of magnitude slower than the XLA step on CPU — never set in
    # production.
    PallasInterpret: bool = False
    # Deterministic fault-injection plan (runtime/faults.py); empty = no
    # injection.  Also reachable via $DISTPOW_FAULTS and --faults.
    FaultPlanFile: str = ""
    # Flight-recorder directory (runtime/telemetry.py): periodic
    # append-only JSONL journal of recent annotated events plus
    # dump-on-fault snapshots land here.  Empty = memory-only ring.
    # Also reachable via $DISTPOW_TELEMETRY_DIR.
    TelemetryDir: str = ""
    # --- scheduler plane (distpow_tpu/sched/, docs/SCHEDULER.md) ---------
    # "batching" multiplexes concurrent Mine searches onto shared
    # batched device launches through the continuous-batching engine
    # (sched/engine.py slot table over the ops/search_step.py batch
    # axis); "off" keeps one-launch-per-request reference behavior.
    # Searches the packed step cannot express (non-power-of-two
    # partitions, unsatisfiable difficulties) fall back to Backend.
    Scheduler: str = "off"
    # Slot-table width: maximum searches packed into one device launch
    # (also the preemption bound — requests beyond it wait in the run
    # queue under deterministic weighted-fair rotation).
    SchedMaxSlots: int = 8
    # Extra hash models the batching scheduler admits to its packed
    # step BEYOND HashModel: slots of different models then share one
    # mixed-hash launch (per-model sub-batches inside one compiled
    # program — docs/SERVING.md).  A Mine carrying a "hash_model" param
    # outside this set (or an XLA-serving-impractical model) routes to
    # the solo path instead.  Empty = HashModel only (any other
    # hash forfeits batching).
    SchedHashModels: List[str] = field(default_factory=list)
    # Launch-lane override for the batching scheduler (sched/lanes.py):
    # "auto" ranks by hardware capability (pallas on TPU, mesh on any
    # multi-device host, xla otherwise); "pallas"/"mesh"/"xla" pins that
    # lane first (a pinned lane that fails to compile still demotes to
    # xla — the override is a ranking, not a correctness gate).
    SchedLane: str = "auto"
    # --- elastic fleet (distpow_tpu/fleet/, docs/FLEET.md) ---------------
    # Join the coordinator's fleet via Fleet.Register instead of (not in
    # addition to) being a static entry in the coordinator's Workers
    # list.  Off by default: static config workers must not
    # double-register.
    FleetRegister: bool = False
    # Heartbeat cadence in seconds; 0 = use the coordinator's hint from
    # the Register reply (lease TTL / 3).
    FleetHeartbeatS: float = 0.0
    # Budget for the boot-time MH/s self-calibration the capability
    # advertisement carries; 0 = skip (advertise unknown, which keeps
    # the fleet on the reference equal split).
    FleetCalibrationS: float = 0.2
    # Explicit advertised MH/s override (> 0 skips calibration):
    # deterministic weights for tests and benches, or an operator who
    # knows the hardware better than a 200 ms sample does.
    FleetMHS: float = 0.0
    # Bound on the graceful-drain wait at shutdown (mirrors the
    # coordinator-side FleetDrainTimeoutS).
    FleetDrainTimeoutS: float = 20.0


@dataclass
class TracingServerConfig:
    ServerBind: str = ""
    Secret: bytes = b""
    OutputFile: str = "trace_output.log"
    ShivizOutputFile: str = "shiviz_output.log"


def from_dict(cls: Type[T], data: dict) -> T:
    known = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        f = known.get(k)
        if f is None:
            continue
        if f.type in ("bytes",) or k in ("TracerSecret", "Secret"):
            v = _decode_secret(v)
        kwargs[k] = v
    return cls(**kwargs)


def read_json_config(path: str, cls: Type[T]) -> T:
    """ReadJSONConfig equivalent (config.go:8-18)."""
    with open(path) as f:
        return from_dict(cls, json.load(f))


def write_json_config(path: str, cfg) -> None:
    data = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, bytes):
            v = base64.b64encode(v).decode()
        data[f.name] = v
    with open(path, "w") as fp:
        json.dump(data, fp, indent="\t")
        fp.write("\n")
