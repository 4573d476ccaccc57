"""The runtime lock-order audit over the in-process cluster.

    python -m distpow_tpu_torch.tools.lock_audit [--backend cuda] [--device cuda]
        [--workers 4] [--concurrent NONCE_HEX:D ...] [--sequential NONCE_HEX:D ...]
        [--duration-s 5] [--difficulty D:WEIGHT ...]

Loads the port's ``runtime/lockcheck.py`` by file path and installs it
before anything of the port is imported (the package ``__init__`` files
above this module hold no code), so every lock the port builds, its
module-level singletons' included, is tagged with its construction site.
Then it boots ``InProcCluster`` (the coordinator, ``--workers`` workers
and a client, all in this process; by default on the card, with no CPU
fallback) and drives it, in the order ``chip_smoke.py``'s ``load`` does,
so that the requests find the cluster warm there as here:

* ``run_load_slo`` judged by ``config/slo.json`` at ``chip_smoke.py``'s
  ``load`` mix (10 req/s, seed 1, 64 keys, zipf 1.1) for ``--duration-s``
  (default 5 s) at the ``--difficulty`` blend (default: 5 and 7 half
  each), every drained secret checked, no errors allowed;
* the ``--concurrent`` requests at once through the cluster's client and
  coordinator (default: the reference demo client's four, difficulties 7,
  5, 5, 7), then the ``--sequential`` ones one at a time, each secret
  checked with hashlib.

It prints one JSON line: the audit's verdict (``cycles``, the edge count,
the sites held at least once and how many of them are the port's), the
five sites with the most total held seconds and the five with the
longest single hold (``path:line``), the requests' latencies, the load
run's report and SLO verdict, and the launches of each CUDA kernel form
in this process.  Exit 1 when the audit saw a lock-order inversion (its
report goes to stderr), when no site of the port was instrumented, or
when a request failed or returned a wrong secret.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
LOCKCHECK = "distpow_tpu_torch.runtime.lockcheck"
SLO_CONFIG = os.path.join(REPO, "config", "slo.json")
RATE_HZ, SEED, N_KEYS = 10.0, 1, 64
TIMEOUT_S = 300.0

# the reference demo client's requests (its default difficulty 5; the
# repeated nonce at 5 + 2), then four more one at a time
DEMO_CONCURRENT = ("01020304:7", "05060708:5", "02020202:5", "02020202:7")
DEMO_SEQUENTIAL = ("01020305:5", "01020306:7", "05060709:5", "02020203:7")
TOP = 5


def load_lockcheck():
    """The port's audit, loaded by path under its own module name (a later
    ordinary import gets this instance) and installed."""
    spec = importlib.util.spec_from_file_location(
        LOCKCHECK, os.path.join(PKG, "runtime", "lockcheck.py"))
    lockcheck = importlib.util.module_from_spec(spec)
    sys.modules[LOCKCHECK] = lockcheck
    spec.loader.exec_module(lockcheck)
    lockcheck.install()
    return lockcheck


def request(text: str):
    nonce, d = text.split(":")
    return bytes.fromhex(nonce), int(d)


def weighted(text: str):
    d, w = text.split(":")
    return int(d), float(w)


def solved(res) -> bool:
    return res.error is None and res.secret is not None and hashlib.md5(
        bytes(res.nonce) + bytes(res.secret)).hexdigest().endswith(
            "0" * res.num_trailing_zeros)


def drive_requests(cluster, requests, together: bool):
    """Mine ``requests`` through the cluster's client: all submitted, then
    all drained (``together``), or each drained before the next.  Each
    latency runs from the last submit before its drain."""
    ms = []
    for i, (nonce, d) in enumerate(requests):
        t1 = time.monotonic()
        cluster.client.mine(nonce, d)
        if together and i < len(requests) - 1:
            continue
        for _ in range(len(requests) if together else 1):
            res = cluster.client.notify_queue.get(timeout=TIMEOUT_S)
            if not solved(res):
                raise AssertionError(f"{res.nonce.hex()} d{res.num_trailing_zeros}: "
                                     f"{res.secret!r} {res.error}")
            ms.append((time.monotonic() - t1) * 1e3)
    return ms


def top_sites(stats, key: str):
    ranked = sorted(stats.items(), key=lambda kv: (-kv[1][key], kv[0]))[:TOP]
    return [{"site": site, **rec} for site, rec in ranked]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--concurrent", nargs="*", default=list(DEMO_CONCURRENT))
    ap.add_argument("--sequential", nargs="*", default=list(DEMO_SEQUENTIAL))
    ap.add_argument("--duration-s", type=float, default=5.0)
    ap.add_argument("--difficulty", nargs="*", default=["5:0.5", "7:0.5"],
                    help="the load mix's difficulty blend, D:WEIGHT each")
    args = ap.parse_args(argv)

    lockcheck = load_lockcheck()
    t_start = time.monotonic()
    # the port, only now that every lock it builds is tagged
    from distpow_tpu_torch.load import InProcCluster, LoadMix, run_load_slo
    from distpow_tpu_torch.load.harness import keeping_results
    from distpow_tpu_torch.ops.hash_cuda import LAUNCHES

    out = {"backend": args.backend, "device": args.device, "workers": args.workers}
    cluster = None
    try:
        with keeping_results() as trackers:
            t0 = time.monotonic()
            cluster = InProcCluster(n_workers=args.workers, backend=args.backend,
                                    device=args.device)
            out["boot_s"] = time.monotonic() - t0
            for counter in LAUNCHES.values():
                counter.reset()
            mix = LoadMix(rate_hz=RATE_HZ, duration_s=args.duration_s, seed=SEED,
                          n_keys=N_KEYS,
                          difficulties=tuple(weighted(d) for d in args.difficulty))
            t0 = time.monotonic()
            report, verdict = run_load_slo(mix, SLO_CONFIG, cluster=cluster)
            wall_s = time.monotonic() - t0
            results = trackers[-1].results
            bad = [r for r in results if not solved(r)]
            issued = report["load"]["issued"]
            if bad or report["request_errors"] or report["completed"] != issued or \
                    len(results) != issued:
                raise AssertionError(
                    f"load: {issued} offered, {report['completed']} completed, "
                    f"{report['request_errors']} errors ({report['error_samples']}), "
                    f"wrong: {[(r.nonce.hex(), r.num_trailing_zeros, r.error) for r in bad]}")
            out["load"] = {"offered": issued, "completed": report["completed"],
                           "errors": 0, "wall_s": wall_s, "verdict": verdict.status,
                           "client_latency_ms": report["client_latency_ms"],
                           "generator_max_lag_s": report["load"]["max_lag_s"]}
            out["demo_requests"] = {
                "concurrent": {"client_ms": drive_requests(
                    cluster, [request(r) for r in args.concurrent], True)},
                "sequential": {"client_ms": drive_requests(
                    cluster, [request(r) for r in args.sequential], False)}}
            out["kernel_launches"] = {k: c.value for k, c in LAUNCHES.items() if c.value}
    finally:
        if cluster is not None:
            cluster.close()
    out["wall_s"] = time.monotonic() - t_start

    audit = lockcheck.check()
    stats = lockcheck.stats()
    port_sites = sorted(s for s in stats if s.startswith("distpow_tpu_torch/"))
    out["audit"] = {"cycles": audit.cycles, "edges": len(audit.edges),
                    "sites_held": len(stats), "port_sites_held": len(port_sites),
                    "top_total_s": top_sites(stats, "total_s"),
                    "top_max_s": top_sites(stats, "max_s")}
    print(json.dumps(out), flush=True)
    if audit.cycles:
        print(lockcheck.format_report(audit), file=sys.stderr)
        return 1
    if not port_sites:
        print("lock_audit: no lock of the port was instrumented", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
