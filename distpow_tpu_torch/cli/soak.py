"""Long-haul soak gate (``load/soak.py``; docs/SOAK.md).

    python -m distpow_tpu_torch.cli.soak --config config/slo.json \
        [--minutes 2] [--compress 320] [--base-hz 6 --amplitude-hz 4] \
        [--spike-hz 20 --spike-frac 0.6 --spike-width-frac 0.1] \
        [--chaos] [--spool PATH] [--json] [--device {cuda,cuda:<i>,cpu}]
    python -m distpow_tpu_torch.cli.soak --config ... --addr COORD [...]

Default mode boots an in-process cluster and replays a COMPRESSED
diurnal-plus-flash-crowd shape against it — the canonical soak:
``--minutes`` of wall clock standing in for one ``--compress``-times-
longer "day".  Its workers serve on the card (``cuda``-backend workers
on ``--device``, ``cuda`` by default, as ``cli/worker.py``'s flag);
``--device cpu`` boots ``python``-backend workers instead.  Without a
GPU and without ``--device cpu`` the cluster does not boot and the soak
exits 2.  ``--addr``/``--discover`` instead attaches to already-running
node processes: the FIRST address must be a coordinator client-API
address (it takes the mine traffic and the judged scrape; the soak
sweeps only that node's Stats — merged registries of separate processes
are per-node, so one coordinator's snapshot is the conservative judged
view unless you front it with the pool's own merge via --discover
ordering).  Attached, the soak imports no ``torch``.

Exit code contract (the SLO CLI's, extended):

* ``0`` — green: every shape phase held the SLO, zero leak suspects,
  ring drops and generator lag within budget (warn-only phases stay 0);
* ``1`` — the soak verdict failed any of those;
* ``2`` — config error (malformed/unknown-metric SLO JSON, bad shape
  parameters), or an in-process cluster that could not boot: refuses to
  run rather than pass vacuously.

The port's own copy of the reference's ``cli/soak.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..load.harness import InProcCluster
from ..load.loadgen import LoadMix
from ..load.shapes import Diurnal, FlashCrowd, Sum, compress
from ..load.soak import run_soak
from ..obs.scrape import NodeTarget
from ..obs.slo import SLOConfigError, load_slo_config

#: seeded server-side delay chaos on the worker Mine path — enough to
#: shake the retry/hedge machinery without sinking a green run
CHAOS_SPEC = {"seed": 905, "rules": [
    {"kind": "delay", "side": "server",
     "method": "WorkerRPCHandler.Mine", "delay_s": 0.05, "prob": 0.2},
    {"kind": "drop", "side": "server",
     "method": "WorkerRPCHandler.Mine", "prob": 0.02, "max": 5},
]}


class AttachedCluster:
    """Duck-typed stand-in for ``InProcCluster`` over real processes:
    a powlib client bound to the first address, scrape targets over
    all of them."""

    def __init__(self, addrs, role: str, deadline_s: float):
        from ..nodes import Client
        from ..runtime.config import ClientConfig

        self._targets = [NodeTarget(addr=a, role=role) for a in addrs]
        self.client = Client(ClientConfig(
            ClientID="soak", CoordAddr=addrs[0],
            CoordAddrs=list(addrs) if len(addrs) > 1 else [],
            ChCapacity=100_000,
        ))
        self.client.initialize()

    def scrape_targets(self, include_workers: bool = False):
        return list(self._targets)

    def close(self) -> None:
        self.client.close()


def build_shape(args):
    """The canonical soak shape from CLI knobs: one diurnal "day" of
    ``minutes * compress`` uncompressed seconds plus a flash crowd at
    ``spike_frac`` of the day, all compressed back into ``minutes`` of
    wall clock."""
    day_s = args.minutes * 60.0 * args.compress
    parts = [Diurnal(base=args.base_hz / args.compress,
                     amplitude=args.amplitude_hz / args.compress,
                     period_s=day_s)]
    if args.spike_hz > 0:
        parts.append(FlashCrowd(
            extra_hz=args.spike_hz / args.compress,
            at_s=day_s * args.spike_frac,
            width_s=day_s * args.spike_width_frac,
            duration_s=day_s,
        ))
    shape = Sum(parts=tuple(parts)) if len(parts) > 1 else parts[0]
    return compress(shape, args.compress)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="replay a shaped soak and judge the typed verdict")
    ap.add_argument("--config", required=True,
                    help="SLO config JSON (see config/slo.json)")
    ap.add_argument("--addr", action="append", default=None,
                    help="attach to running nodes (first = coordinator "
                         "client API; repeatable, comma lists ok)")
    ap.add_argument("--discover", metavar="COORD_ADDR", action="append",
                    default=None,
                    help="pull the node list from the coordinators' "
                         "live membership tables (docs/CLUSTER.md)")
    ap.add_argument("--role", choices=["auto", "coordinator", "worker"],
                    default="auto")
    ap.add_argument("--workers", type=int, default=2,
                    help="in-process cluster size (ignored with --addr)")
    ap.add_argument("--minutes", type=float, default=1.5,
                    help="wall-clock soak length")
    ap.add_argument("--compress", type=float, default=320.0,
                    help="wall-clock compression factor (docs/SOAK.md)")
    ap.add_argument("--base-hz", type=float, default=6.0,
                    help="diurnal base rate (compressed, requests/s)")
    ap.add_argument("--amplitude-hz", type=float, default=4.0,
                    help="diurnal swing (compressed, requests/s)")
    ap.add_argument("--spike-hz", type=float, default=18.0,
                    help="flash-crowd extra rate (compressed; 0 = off)")
    ap.add_argument("--spike-frac", type=float, default=0.55,
                    help="where in the day the flash crowd lands (0..1)")
    ap.add_argument("--spike-width-frac", type=float, default=0.08,
                    help="flash-crowd width as a fraction of the day")
    ap.add_argument("--seed", type=int, default=1805)
    ap.add_argument("--interval", type=float, default=1.0,
                    help="fleet sweep cadence (seconds)")
    ap.add_argument("--deadline", type=float, default=5.0,
                    help="shared sweep deadline (seconds)")
    ap.add_argument("--chaos", action="store_true",
                    help="install the canned fault plan for the run")
    ap.add_argument("--spool", default=None,
                    help="append sweeps to this JSONL spool (rotated; "
                         "replayable via obs.timeseries.replay_spool)")
    ap.add_argument("--lag-budget", type=float, default=1.0,
                    help="generator lag p99 budget (seconds)")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the in-process cluster's workers compute: "
                         "cuda (default), cuda:<index>, or cpu (python-"
                         "backend workers); ignored with --addr")
    args = ap.parse_args(argv)

    addrs = [a for flag in (args.addr or []) for a in flag.split(",") if a]
    if args.discover:
        from ..runtime.rpc import RPCError
        from .stats import discover_cluster_addrs

        try:
            discovered = discover_cluster_addrs(args.discover,
                                                timeout=args.deadline)
        except (OSError, RPCError, RuntimeError) as exc:
            print(f"error: membership discovery against "
                  f"{','.join(args.discover)} failed: {exc}",
                  file=sys.stderr)
            return 2
        addrs = discovered + [a for a in addrs if a not in discovered]

    if args.minutes <= 0 or args.compress <= 0:
        print("error: --minutes and --compress must be positive",
              file=sys.stderr)
        return 2
    try:
        shape = build_shape(args)
    except ValueError as exc:
        print(f"shape error: {exc}", file=sys.stderr)
        return 2
    mix = LoadMix(rate_hz=1.0, duration_s=1.0,  # placeholders: shape rules
                  seed=args.seed, n_keys=24, zipf_s=1.1,
                  difficulties=((1, 0.7), (2, 0.3)))

    cluster = None
    try:
        if addrs:
            cluster = AttachedCluster(addrs, args.role, args.deadline)
        try:
            # the config is judged before a cluster boots, as run_soak
            # judges it before booting its own
            slo_config = load_slo_config(args.config)
            if cluster is None:
                # the in-process cluster: CUDA-backend workers on the
                # card, python-backend ones with --device cpu
                cluster = InProcCluster(
                    n_workers=args.workers, device=args.device,
                    backend="python" if args.device == "cpu" else "cuda")
            report, verdict = run_soak(
                shape, mix, slo_config,
                cluster=cluster, n_workers=args.workers,
                scrape_interval_s=args.interval,
                scrape_deadline_s=args.deadline,
                fault_spec=CHAOS_SPEC if args.chaos else None,
                spool_path=args.spool,
                lag_budget_s=args.lag_budget,
            )
        except SLOConfigError as exc:
            print(f"slo config error: {exc}", file=sys.stderr)
            return 2
        except (OSError, RuntimeError, ValueError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
    finally:
        if cluster is not None:
            cluster.close()
    print(json.dumps(report, indent=2) if args.json
          else verdict.render(), flush=True)
    return verdict.exit_code()


if __name__ == "__main__":
    sys.exit(main())
