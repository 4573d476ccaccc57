"""Config-gen utility (cmd/config-gen/main.go equivalent).

Rewrites the ``config/*.json`` set with pseudo-random local ports
(1024-35534) while keeping cross-references consistent: the tracing server
address lands in every node config, the coordinator's client/worker listen
addresses land in the client/worker configs, and each coordinator worker
slot gets a fresh port.  Keeps the worker list length from the existing
coordinator config (cmd/config-gen/main.go:51-88).

    python -m distpow_tpu_torch.cli.config_gen [--config-dir DIR] [--host HOST]
        [--workers N] [--elastic] [--coordinators N]

Emitted configs carry the full dataclass field set, so the fleet
membership knobs (``FleetLeaseTTLS`` / ``FleetHedge`` /
``FleetHedgeMultiple`` / ``FleetDrainTimeoutS`` on the coordinator;
``FleetRegister`` / ``FleetHeartbeatS`` / ``FleetCalibrationS`` /
``FleetMHS`` / ``FleetDrainTimeoutS`` on the worker — docs/FLEET.md)
appear with their defaults and round-trip through
``runtime/config.py`` (the config-key-sync lint rule keeps consumer
code honest against those fields).  ``--elastic`` flips the emitted
worker config to ``FleetRegister: true``, the shape an elastic worker
boots from (``--listen 127.0.0.1:0`` then works: the worker registers
its real bound port with the coordinator instead of needing a
pre-agreed one).

``--coordinators N`` (docs/CLUSTER.md) emits an N-member coordinator
POOL: shard 0 keeps ``coordinator_config.json`` (back-compat) and
shard ``i>0`` lands in ``coordinator{i}_config.json``; every member
carries the full ``ClusterPeers`` ring-seed list (all client-facing
addresses, shard order), its own ``ClusterSelf`` index, its own
listen ports, and the SAME shared ``Workers`` list.  The client
config gains ``CoordAddrs`` (the same seed list — powlib cluster
mode) while ``CoordAddr`` still points at shard 0 for pre-cluster
tools; the worker config's ``CoordAddr`` points at shard 0's worker
API (pooled rounds stamp their own reply-to, so the default only
matters for which coordinator a static worker appears under).

The port's own copy of the reference's ``cli/config_gen.py``
(``distpow_tpu/cli/config_gen.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import random

from ..runtime.config import (
    ClientConfig,
    CoordinatorConfig,
    TracingServerConfig,
    WorkerConfig,
    read_json_config,
    write_json_config,
)


def gen_port(rng: random.Random) -> int:
    return rng.randrange(1024, 35535)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="randomize distpow config ports")
    ap.add_argument("--config-dir", default="config")
    ap.add_argument("--host", default="127.0.0.1",
                    help="host part written into addresses ('' for bare :port)")
    ap.add_argument("--workers", type=int, default=0,
                    help="override worker count (default: keep existing)")
    ap.add_argument("--elastic", action="store_true",
                    help="emit the worker config with FleetRegister=true "
                         "(lease-based membership, docs/FLEET.md)")
    ap.add_argument("--coordinators", type=int, default=1,
                    help="coordinator pool size (docs/CLUSTER.md): >1 "
                         "emits per-shard coordinator configs with ring "
                         "seeds and flips the client to CoordAddrs")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)
    rng = random.Random(args.seed)

    def addr() -> str:
        return f"{args.host}:{gen_port(rng)}"

    d = args.config_dir
    os.makedirs(d, exist_ok=True)

    def load(name, cls):
        path = os.path.join(d, name)
        return read_json_config(path, cls) if os.path.exists(path) else cls()

    n_coords = max(1, int(args.coordinators))
    tracer_addr = addr()
    client_addrs = [addr() for _ in range(n_coords)]
    worker_api_addrs = [addr() for _ in range(n_coords)]
    coord_client_addr = client_addrs[0]
    coord_worker_addr = worker_api_addrs[0]

    ts = load("tracing_server_config.json", TracingServerConfig)
    ts.ServerBind = tracer_addr
    write_json_config(os.path.join(d, "tracing_server_config.json"), ts)

    def coord_path(i: int) -> str:
        # shard 0 keeps the historical name so pre-cluster tooling
        # (cli.coordinator default --config, the reference scripts)
        # still finds a coordinator
        return os.path.join(
            d, "coordinator_config.json" if i == 0
            else f"coordinator{i}_config.json")

    coord = load("coordinator_config.json", CoordinatorConfig)
    n = args.workers or len(coord.Workers) or 4
    shared_workers = [addr() for _ in range(n)]
    for i in range(n_coords):
        c = load("coordinator_config.json", CoordinatorConfig) \
            if i else coord
        c.Workers = list(shared_workers)  # ONE fleet, shared by the pool
        c.TracerServerAddr = tracer_addr
        c.ClientAPIListenAddr = client_addrs[i]
        c.WorkerAPIListenAddr = worker_api_addrs[i]
        if n_coords > 1:
            c.ClusterPeers = list(client_addrs)
            c.ClusterSelf = i
            if i and c.CacheFile:
                # per-process paths: two shards appending one cache
                # journal (and deriving one restart epoch) would
                # corrupt both — suffix everything i>0 inherits
                c.CacheFile = f"{c.CacheFile}.c{i}"
            if i and c.TelemetryDir:
                c.TelemetryDir = os.path.join(c.TelemetryDir, f"c{i}")
        else:
            c.ClusterPeers = []
            c.ClusterSelf = -1
        write_json_config(coord_path(i), c)

    for name in ("client_config.json", "client2_config.json"):
        c = load(name, ClientConfig)
        if name == "client2_config.json" and c.ClientID == "client1":
            c.ClientID = "client2"
        c.TracerServerAddr = tracer_addr
        c.CoordAddr = coord_client_addr
        c.CoordAddrs = list(client_addrs) if n_coords > 1 else []
        write_json_config(os.path.join(d, name), c)

    w = load("worker_config.json", WorkerConfig)
    w.TracerServerAddr = tracer_addr
    w.CoordAddr = coord_worker_addr
    w.ListenAddr = "PASS VIA COMMAND-LINE"
    if args.elastic:
        w.FleetRegister = True
    write_json_config(os.path.join(d, "worker_config.json"), w)

    pool = (f" pool={n_coords} coordinators, ring seeds {client_addrs}"
            if n_coords > 1 else "")
    print(f"wrote configs to {d}: tracer={tracer_addr} "
          f"coordinator client={coord_client_addr} worker={coord_worker_addr} "
          f"workers={shared_workers}{pool} "
          f"(fleet: lease ttl {coord.FleetLeaseTTLS}s, hedge "
          f"{'on' if coord.FleetHedge else 'off'}, elastic worker "
          f"{'yes' if w.FleetRegister else 'no'})")


if __name__ == "__main__":
    main()
