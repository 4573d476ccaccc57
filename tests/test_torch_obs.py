"""The port's observability plane (``distpow_tpu_torch/obs/``) held against
the reference's (``distpow_tpu/obs/``) on the same seeded inputs.

* Merge: ``merge_histograms``, ``merged_percentile``, ``delta_histogram``
  and ``merge_snapshots`` over histograms filled from one seeded stream in
  both packages' registries; the dicts are equal but for ``ts``.
* Time series: ``TimeSeriesStore`` on scripted timestamps (``tier_points``,
  ``window``, ``range_window``, ``counter_rate``, ``gauge_series``), and a
  spool written by each package read back by the other's ``replay_spool``.
* SLO config: ``load_slo_config`` on ``config/slo.json`` and on every
  malformed case of ``tests/test_obs.py``; both accept and reject alike.
* SLO verdicts: ``SLOEngine`` verdicts (``to_dict``) on the same snapshot
  sequences; the breach dump's critical path from the port's own profiler.
* Scrape: ``FleetScraper`` over a port stack whose nodes are processes
  (each its own registry), a SIGSTOPped worker marked stale within the
  deadline, and mixed stacks scraped by either package's scraper.
* Forensics: one request's timeline stitched from port nodes and from
  reference nodes by either package.

Every comparison is exact unless it says otherwise.
"""

from __future__ import annotations

import json
import os
import random
import signal
import time

import pytest

from distpow_tpu.obs import merge as ref_merge
from distpow_tpu.obs import forensics as ref_forensics
from distpow_tpu.obs import scrape as ref_scrape
from distpow_tpu.obs import slo as ref_slo
from distpow_tpu.obs import timeseries as ref_ts
from distpow_tpu.runtime import metrics as ref_metrics
from distpow_tpu_torch.obs import forensics, merge, scrape, slo, timeseries
from distpow_tpu_torch.runtime import metrics
from distpow_tpu_torch.runtime.telemetry import RECORDER
from tests.test_torch_cli import PortProcStack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLO_JSON = os.path.join(REPO, "config", "slo.json")
T0 = 1_000_000.0


def seeded_samples(seed, n=400):
    rng = random.Random(seed)
    return [rng.choice((rng.lognormvariate(-3.0, 1.5), rng.uniform(0.0, 2.0), 0.0))
            for _ in range(n)]


def hists(samples, trace_every=0):
    """The same stream into a port and a reference histogram, with trace
    ids every ``trace_every`` samples (exemplars)."""
    port, ref = metrics.Histogram(), ref_metrics.Histogram()
    for i, v in enumerate(samples):
        tid = i + 1 if trace_every and i % trace_every == 0 else None
        port.observe(v, tid)
        ref.observe(v, tid)
    return port.to_dict(), ref.to_dict()


def strip_exemplar_ts(h):
    """Exemplars carry the wall-clock second of their observe call."""
    h = dict(h)
    if "exemplars" in h:
        h["exemplars"] = [e[:3] for e in h["exemplars"]]
    return h


# -- merge --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [905, 17, 3])
def test_merge_histograms_and_percentiles_match(seed):
    parts = [hists(seeded_samples(seed + k, 100 + 50 * k), trace_every=7) for k in range(3)]
    ports, refs = [p for p, _ in parts], [r for _, r in parts]
    assert [strip_exemplar_ts(p) for p in ports] == [strip_exemplar_ts(r) for r in refs]
    got, want = merge.merge_histograms(refs), ref_merge.merge_histograms(refs)
    assert got == want
    assert strip_exemplar_ts(merge.merge_histograms(ports)) == strip_exemplar_ts(want)
    oracle, _ = hists([v for k in range(3) for v in seeded_samples(seed + k, 100 + 50 * k)])
    assert {k: v for k, v in got.items() if k != "exemplars"} == oracle
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        args = (got["buckets"], got["count"], got["min"], got["max"], q)
        assert merge.merged_percentile(*args) == ref_merge.merged_percentile(*args)
    assert merge.merge_histograms([None, {}]) == ref_merge.merge_histograms([None, {}])


def test_delta_histogram_matches_including_resets():
    old, _ = hists(seeded_samples(5, 200))
    new, _ = hists(seeded_samples(5, 200) + seeded_samples(6, 150))
    for a, b in ((new, old), (old, new), (new, None), (None, old), (new, new)):
        assert merge.delta_histogram(a, b) == ref_merge.delta_histogram(a, b)


def node_snapshot(seed, role):
    """A ``Stats``-shaped snapshot from a seeded port registry."""
    rng = random.Random(seed)
    m = metrics.Metrics()
    m.inc("coord.mine_rpcs", rng.randrange(1, 50))
    m.inc("rpc.handler_errors", rng.randrange(0, 3))
    m.gauge("proc.threads", rng.randrange(5, 40))
    for v in seeded_samples(seed, 120):
        m.observe("coord.mine_s.miss", v)
        m.observe("worker.solve_s.md5" if seed % 2 else "worker.solve_s.sha1", v / 3)
    snap = m.snapshot()
    snap["role"] = role
    return snap


def without_ts(d):
    return {k: v for k, v in d.items() if k != "ts"}


def test_merge_snapshots_and_delta_merged_match():
    snaps = {"c": node_snapshot(1, "coordinator"), "w1": node_snapshot(2, "worker"),
             "w2": node_snapshot(3, "worker")}
    stale = {"w2": {"status": "stale", "age_s": 3.5, "error": "deadline"}}
    got, want = merge.merge_snapshots(snaps, stale), ref_merge.merge_snapshots(snaps, stale)
    assert without_ts(got) == without_ts(want)
    assert set(got["per_model"]) == {"md5", "sha1"} and got["stale_nodes"] == ["w2"]
    older = merge.merge_snapshots({"c": node_snapshot(1, "coordinator")})
    older["ts"], got["ts"] = 10.0, 70.0
    assert merge.delta_merged(got, older) == ref_merge.delta_merged(got, older)
    assert merge.delta_merged(got, None) == ref_merge.delta_merged(got, None)


# -- time series --------------------------------------------------------------

def cum_snap(i, hist_samples):
    h, _ = hists(hist_samples)
    return {"ts": T0 + i, "nodes": 1, "counters": {"x": 3 * i, "coord.mine_rpcs": i},
            "gauges": {"proc.threads": 10 + (i % 4)},
            "histograms": {"worker.solve_s": h},
            "per_node": {"a": {"gauges": {"proc.threads": i}}}, "per_model": {},
            "stale_nodes": []}


def fill(store_cls, tier_cls, spool=None):
    store = store_cls(tiers=(tier_cls(0.0, 40.0), tier_cls(10.0, 400.0), tier_cls(60.0, 4000.0)),
                      spool_path=spool)
    stream = seeded_samples(41, 2000)
    for i in range(0, 300, 3):
        store.append(cum_snap(i, stream[:5 * i]))
    return store


def test_timeseries_queries_match():
    port, ref = fill(timeseries.TimeSeriesStore, timeseries.Tier), fill(ref_ts.TimeSeriesStore,
                                                                        ref_ts.Tier)
    assert len(port) == len(ref)
    for i in range(3):
        assert port.tier_points(i) == ref.tier_points(i)
    assert port.latest() == ref.latest()
    for w in (5.0, 30.0, 100.0, 1000.0):
        assert port.window(w) == ref.window(w)
        assert port.counter_rate("x", w) == ref.counter_rate("x", w)
    for start, end in ((T0 + 10, T0 + 200), (T0 - 5, T0 + 50), (T0 + 250, T0 + 100)):
        assert port.range_window(start, end) == ref.range_window(start, end)
        assert port.snapshot_at(end) == ref.snapshot_at(end)
    for kw in ({}, {"window_s": 60.0}, {"node": "a"}, {"window_s": 20.0, "node": "a"}):
        assert port.gauge_series("proc.threads", **kw) == ref.gauge_series("proc.threads", **kw)
    assert port.gauge_names() == ref.gauge_names()
    assert timeseries.DEFAULT_TIERS == tuple(timeseries.Tier(t.resolution_s, t.retention_s)
                                             for t in ref_ts.DEFAULT_TIERS)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_spools_are_read_by_either_package(tmp_path, writer):
    spool = str(tmp_path / "spool.jsonl")
    store_cls, tier_cls = ((timeseries.TimeSeriesStore, timeseries.Tier) if writer == "port"
                           else (ref_ts.TimeSeriesStore, ref_ts.Tier))
    store = store_cls(tiers=(tier_cls(0.0, 1e9),), spool_path=spool, spool_max_bytes=20_000,
                      spool_keep=50)
    for i in range(60):
        store.append(cum_snap(i, seeded_samples(i, 40)))
    assert os.path.exists(spool + ".1")  # rotated
    with open(spool, "a") as fh:
        fh.write('{"ts": 1, "merged"\n')  # a torn tail line
    got, want = list(timeseries.replay_spool(spool)), list(ref_ts.replay_spool(spool))
    assert got == want and [t for t, _ in got] == [T0 + i for i in range(60)]


# -- SLO config ---------------------------------------------------------------

MALFORMED = [
    {"objectives": [{"name": "x", "histogram": "coord.mine_s.typo", "max": 1}]},
    {"objectives": [{"name": "x", "max": 1, "ratio": {"num": "rpc.handler_errorz",
                                                      "den": "coord.mine_rpcs"}}]},
    {"objectives": [{"name": "x", "histogram": "powlib.mine_s", "max": 1},
                    {"name": "x", "histogram": "powlib.mine_s", "max": 2}]},
    {"objectives": [{"name": "x", "max": 1}]},
    {"objectives": [{"name": "x", "histogram": "powlib.mine_s", "stat": "p42", "max": 1}]},
    {"objectives": [{"name": "x", "histogram": "powlib.mine_s", "max": 0}]},
    {"objectives": [{"name": "x", "histogram": "powlib.mine_s", "max": 1, "per_model": True}]},
    {"windows": {"fast_s": 100.0, "slow_s": 10.0},
     "objectives": [{"name": "x", "histogram": "powlib.mine_s", "max": 1}]},
    {"objectives": []},
    [],
    {"objectives": ["x"]},
    {"objectives": [{"histogram": "powlib.mine_s", "max": 1}]},
    {"objectives": [{"name": "x", "histogram": "powlib.mine_s", "max": "big"}]},
    {"objectives": [{"name": "x", "max": 1, "ratio": {"num": "coord.mine_rpcs"}}]},
    {"objectives": [{"name": "x", "histogram": "worker.solve_s", "max": 1, "per_model": True,
                     "models": {"": 2.0}}]},
    {"objectives": [{"name": "x", "histogram": "powlib.mine_s", "max": 1,
                     "models": {"md5": 2.0}}]},
]
ACCEPTED = [
    {"objectives": [{"name": "m", "histogram": "worker.solve_s.sha1", "max": 1},
                    {"name": "r", "histogram": "rpc.server.dispatch_s.C.Mine", "max": 1}]},
    {"windows": {"fast_s": 5, "slow_s": 5},
     "objectives": [{"name": "s", "histogram": "worker.solve_s", "per_model": True,
                     "max": 2, "models": {"sha3_256": 30}, "stat": "mean"}]},
    {"objectives": [{"name": "lag", "histogram": "load.lag_s", "max": 1},
                    {"name": "sweep", "histogram": "obs.sweep_s", "stat": "p99", "max": 1},
                    {"name": "fails", "max": 0.5,
                     "ratio": {"num": "obs.scrape_failures", "den": "obs.scrapes"}},
                    {"name": "breaches", "max": 0.5,
                     "ratio": {"num": "slo.breaches", "den": "slo.evaluations"}},
                    {"name": "soak", "max": 0.5,
                     "ratio": {"num": "soak.phase_breaches", "den": "soak.sweeps"}},
                    {"name": "fetch", "max": 0.5,
                     "ratio": {"num": "forensics.fetch_failures",
                               "den": "forensics.fetches"}}]},
]


def config_outcome(load, err, cfg):
    try:
        return ("ok", load(cfg))
    except err as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("cfg", MALFORMED + ACCEPTED + [SLO_JSON, "/nonexistent/slo.json"],
                         ids=[f"malformed{i}" for i in range(len(MALFORMED))]
                         + [f"accepted{i}" for i in range(len(ACCEPTED))]
                         + ["slo.json", "missing"])
def test_slo_config_accepted_and_rejected_alike(cfg):
    got = config_outcome(slo.load_slo_config, slo.SLOConfigError, cfg)
    want = config_outcome(ref_slo.load_slo_config, ref_slo.SLOConfigError, cfg)
    assert got[0] == want[0]
    if got[0] == "error":
        assert got[1] == want[1]
    else:
        assert repr(got[1]) == repr(want[1]).replace("distpow_tpu.obs", "distpow_tpu_torch.obs")
    if cfg == SLO_JSON:
        assert got[0] == "ok" and len(got[1].objectives) == 5
    assert (got[0] == "error") == (cfg in MALFORMED or cfg == "/nonexistent/slo.json")


# -- SLO verdicts -------------------------------------------------------------

def merged_at(ts, miss=(), errors=0, mines=0, models=None):
    port_h, _ = hists(list(miss))
    out = {"ts": ts, "counters": {"rpc.handler_errors": errors, "coord.mine_rpcs": mines},
           "histograms": {"coord.mine_s.miss": port_h}, "stale_nodes": []}
    for model, samples in (models or {}).items():
        out["histograms"][f"worker.solve_s.{model}"] = hists(samples)[0]
    return out


LAT_CFG = {"windows": {"fast_s": 60, "slow_s": 300},
           "objectives": [{"name": "p95", "histogram": "coord.mine_s.miss", "stat": "p95",
                           "max": 1.0}]}
ERR_CFG = {"windows": {"fast_s": 60, "slow_s": 300},
           "objectives": [{"name": "err", "max": 0.1,
                           "ratio": {"num": "rpc.handler_errors", "den": "coord.mine_rpcs"}}]}
MODEL_CFG = {"objectives": [{"name": "serving", "histogram": "worker.solve_s", "stat": "p95",
                             "max": 1.0, "per_model": True, "models": {"sha3_256": 30.0}}]}
t = 10_000.0
SEQUENCES = {
    "pass": (LAT_CFG, [merged_at(1000.0, [0.1, 0.2])], "pass"),
    "cumulative_breach": (LAT_CFG, [merged_at(1000.0, [5.0] * 20)], "breach"),
    "fast_spike_warn": (ERR_CFG, [merged_at(t - 400, mines=1000),
                                  merged_at(t - 90, errors=5, mines=5000),
                                  merged_at(t, errors=155, mines=5500)], "warn"),
    "sustained_burn": (ERR_CFG, [merged_at(t - 400, mines=1000),
                                 merged_at(t - 90, errors=800, mines=3000),
                                 merged_at(t, errors=1400, mines=5000)], "breach"),
    "recovering": (ERR_CFG, [merged_at(t - 400, mines=1000),
                             merged_at(t - 90, errors=900, mines=3000),
                             merged_at(t, errors=900, mines=5000)], "warn"),
    "no_data": (ERR_CFG, [merged_at(1000.0, mines=0)], "no_data"),
    "per_model": (MODEL_CFG, [merged_at(1.0, models={"md5": [5.0] * 10,
                                                     "sha3_256": [5.0] * 10})], "breach"),
    "per_model_none": (MODEL_CFG, [merged_at(1.0)], "no_data"),
    "slo_json_mixed": (SLO_JSON, [merged_at(t - 200, [0.3] * 5, mines=10,
                                            models={"md5": [0.2]}),
                                  merged_at(t, [0.3] * 50 + [12.0] * 9, errors=1, mines=80,
                                            models={"md5": [0.2] * 40})], "breach"),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_slo_verdicts_match(name):
    cfg, seq, status = SEQUENCES[name]
    port = slo.SLOEngine(slo.load_slo_config(cfg))
    ref = ref_slo.SLOEngine(ref_slo.load_slo_config(cfg))
    for snap in seq[:-1]:
        port.observe(snap, ts=snap["ts"])
        ref.observe(snap, ts=snap["ts"])
    got = port.evaluate(seq[-1], ts=seq[-1]["ts"], breach_hooks=False)
    want = ref.evaluate(seq[-1], ts=seq[-1]["ts"], breach_hooks=False)
    assert got.to_dict() == want.to_dict()
    assert got.render() == want.render()
    assert got.status == status and got.exit_code() == want.exit_code()
    for start, end in ((seq[0]["ts"], seq[-1]["ts"]), (seq[-1]["ts"] - 100, seq[-1]["ts"])):
        assert port.judge_range(start, end).to_dict() == ref.judge_range(start, end).to_dict()


def test_breach_dump_carries_the_ports_own_critical_path(tmp_path):
    """The breach dump's critical path comes from the port's own profiler
    (``obs/trace_profile.py``), with the reference script's rows."""
    import importlib.util

    journal = tmp_path / "coordinator.telemetry.jsonl"
    events = [
        {"seq": 1, "ts": 100.0, "kind": "coord.fanout", "round": "r1", "nonce": "aa", "ntz": 2},
        {"seq": 2, "ts": 100.1, "kind": "coord.first_result", "round": "r1", "nonce": "aa",
         "ntz": 2, "worker_byte": 0, "latency_s": 0.1},
        {"seq": 3, "ts": 100.4, "kind": "coord.cancel_complete", "round": "r1", "nonce": "aa",
         "ntz": 2, "late_results": 0, "latency_s": 0.4},
        {"seq": 4, "ts": 101.0, "kind": "coord.fanout", "round": "r2", "nonce": "bb", "ntz": 2},
        {"seq": 5, "ts": 103.0, "kind": "coord.cancel_complete", "round": "r2", "nonce": "bb",
         "ntz": 2, "late_results": 1, "latency_s": 2.0},
        {"seq": 6, "ts": 103.5, "kind": "fleet.join", "round": "r3"},
    ]
    journal.write_text("".join(json.dumps(e) + "\n" for e in events) + "not json\n")
    spec = importlib.util.spec_from_file_location("ref_trace_profile",
                                                  os.path.join(REPO, "scripts",
                                                               "trace_profile.py"))
    ref_profile = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_profile)
    from distpow_tpu_torch.obs import trace_profile

    assert trace_profile.profile_journal(str(journal)) == \
        ref_profile.profile_journal(str(journal))
    RECORDER.reset()
    RECORDER.configure(dump_dir=str(tmp_path))
    try:
        engine = slo.SLOEngine(slo.load_slo_config(LAT_CFG), journal_path=str(journal))
        v = engine.evaluate(merged_at(1000.0, [5.0] * 20), ts=1000.0)
        assert v.status == "breach" and v.dump_path
        with open(v.dump_path) as fh:
            extra = json.load(fh)["extra"]
        assert [r["round"] for r in extra["critical_path"]] == ["r2", "r1"]
        assert extra["critical_path"][0]["cancel_propagation_s"] == 2.0
        assert extra["verdict"]["status"] == "breach"
        assert [e["objective"] for e in RECORDER.recent() if e["kind"] == "slo.breach"] == ["p95"]
    finally:
        RECORDER.reset()


# -- scrape -------------------------------------------------------------------

def stable(merged):
    """The series of a merged sweep that the sweeps themselves do not move
    (each Stats call adds RPC counts and histogram samples)."""
    c = merged["counters"]
    return ({k: c.get(k) for k in ("coord.mine_rpcs", "coord.fanouts", "worker.mine_rpcs",
                                   "worker.results_sent", "cache.add")},
            {k: merged["histograms"].get(k) for k in ("coord.mine_s.miss", "worker.solve_s",
                                                      "powlib.mine_s")},
            {n: m["role"] for n, m in merged["per_node"].items()},
            merged["stale_nodes"], sorted(merged["per_model"]))


@pytest.fixture(scope="module")
def port_stack(tmp_path_factory):
    """A port stack of processes (each node its own registry): tracing
    server, coordinator, two python-backend workers; the demo client has
    run at 8 difficulty bits."""
    tmp = tmp_path_factory.mktemp("port_stack")
    stack = PortProcStack(tmp, workers=2, seed=321)
    try:
        stack.boot_core()
        stack.worker_procs = [stack.boot_port_worker(i) for i in range(2)]
        client = stack.spawn("-m", "distpow_tpu_torch.cli.client",
                             "--config", stack.config("client_config.json"),
                             "--config2", stack.config("client2_config.json"),
                             "--difficulty-bits", "8")
        out, _ = client.communicate(timeout=120)
        assert client.returncode == 0, out
        yield stack
    finally:
        stack.close()


def targets(stack, mod):
    return [mod.NodeTarget(stack.coord_cfg["ClientAPIListenAddr"], "coordinator", "coordinator"),
            *(mod.NodeTarget(a, f"worker{i + 1}", "worker")
              for i, a in enumerate(stack.coord_cfg["Workers"]))]


def test_scraper_merges_the_port_stacks_registries(port_stack):
    scraper = scrape.FleetScraper(targets(port_stack, scrape), deadline_s=10.0)
    try:
        merged = scraper.sweep()
        nodes = scraper.last_snapshots()
    finally:
        scraper.close()
    assert merged["stale_nodes"] == [] and merged["nodes"] == 3
    # the merge of the nodes' own snapshots, series by series
    want = merge.merge_snapshots(nodes)
    assert stable(merged) == stable(want)
    assert merged["counters"]["worker.mine_rpcs"] == sum(
        n["counters"].get("worker.mine_rpcs", 0) for n in nodes.values()) > 0
    assert nodes["worker1"]["device"] == "cpu" and "kernel_launches" in nodes["worker1"]
    assert merged["per_model"]["md5"]["solve_s"]["count"] == sum(
        (n["histograms"].get("worker.solve_s.md5") or {}).get("count", 0)
        for n in nodes.values())


@pytest.mark.parametrize("scraper_pkg", ["port", "reference"])
def test_a_sigstopped_worker_goes_stale_within_the_deadline(port_stack, scraper_pkg):
    mod = scrape if scraper_pkg == "port" else ref_scrape
    scraper = mod.FleetScraper(targets(port_stack, mod), deadline_s=10.0)
    frozen = port_stack.worker_procs[1]
    try:
        first = scraper.sweep()
        assert first["stale_nodes"] == []
        os.kill(frozen.pid, signal.SIGSTOP)
        try:
            time.sleep(0.2)
            t0 = time.monotonic()
            snap = scraper.sweep(deadline_s=1.0)
            wall = time.monotonic() - t0
            assert wall < 3.0, wall
            assert snap["stale_nodes"] == ["worker2"]
            assert snap["per_node"]["worker2"]["status"] == "stale"
            assert snap["per_node"]["worker2"]["age_s"] >= 0.9
            assert snap["per_node"]["coordinator"]["status"] == "ok"
            # its last snapshot still counts, flagged
            assert snap["counters"]["worker.mine_rpcs"] >= first["counters"]["worker.mine_rpcs"]
            verdict = slo.SLOEngine(slo.load_slo_config(SLO_JSON)).evaluate(
                snap, breach_hooks=False)
            assert verdict.stale_nodes == ["worker2"] and verdict.exit_code() == 0
        finally:
            os.kill(frozen.pid, signal.SIGCONT)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if not scraper.sweep(deadline_s=2.0)["stale_nodes"]:
                break
        else:
            raise AssertionError("the worker did not come back after SIGCONT")
    finally:
        scraper.close()


def test_both_scrapers_read_the_port_stack_alike(port_stack):
    port = scrape.FleetScraper(targets(port_stack, scrape), deadline_s=10.0)
    ref = ref_scrape.FleetScraper(targets(port_stack, ref_scrape), deadline_s=10.0)
    try:
        assert stable(port.sweep()) == stable(ref.sweep())
    finally:
        port.close()
        ref.close()


@pytest.fixture
def reference_stack():
    """The reference's coordinator, one python-backend worker and a client in
    this process; one Mine served."""
    from distpow_tpu.nodes import Client, Coordinator, Worker
    from distpow_tpu.runtime.config import ClientConfig, CoordinatorConfig, WorkerConfig

    coordinator = Coordinator(CoordinatorConfig(ClientAPIListenAddr="127.0.0.1:0",
                                                WorkerAPIListenAddr="127.0.0.1:0",
                                                Workers=["pending:0"]))
    client_addr, worker_api = coordinator.initialize_rpcs()
    worker = Worker(WorkerConfig(WorkerID="refw", ListenAddr="127.0.0.1:0", CoordAddr=worker_api,
                                 Backend="python", WarmupNonceLens=[], WarmupWidths=[]))
    worker_addr = worker.initialize_rpcs()
    worker.start_forwarder()
    coordinator.set_worker_addrs([worker_addr])
    client = Client(ClientConfig(ClientID="refc", CoordAddr=client_addr))
    client.initialize()
    try:
        client.mine(b"\x0e\x01\x02", 2)
        res = client.notify_queue.get(timeout=60)
        assert res.error is None, res.error
        yield client_addr, worker_addr
    finally:
        client.close()
        worker.shutdown()
        coordinator.shutdown()


def test_both_scrapers_read_reference_nodes_alike(reference_stack):
    client_addr, worker_addr = reference_stack
    mods = (scrape, ref_scrape)
    scrapers = [m.FleetScraper([m.NodeTarget(client_addr, "c"), m.NodeTarget(worker_addr, "w")],
                               deadline_s=10.0) for m in mods]
    try:
        got, want = (s.sweep() for s in scrapers)
    finally:
        for s in scrapers:
            s.close()
    assert stable(got) == stable(want)
    assert got["per_node"]["c"]["role"] == "coordinator" and got["per_node"]["w"]["role"] == \
        "worker"
    assert got["stale_nodes"] == [] and got["counters"]["coord.mine_rpcs"] >= 2  # one each node


def test_scrape_cluster_of_a_dead_address_is_stale():
    for mod in (scrape, ref_scrape):
        snap = mod.scrape_cluster(["127.0.0.1:1"], deadline_s=1.0)
        assert snap["stale_nodes"] == ["127.0.0.1:1"]
        assert snap["per_node"]["127.0.0.1:1"]["age_s"] is None
    with pytest.raises(ValueError):
        scrape.FleetScraper([])
    with pytest.raises(ValueError):
        scrape.FleetScraper([scrape.NodeTarget("a:1", "x"), scrape.NodeTarget("b:2", "x")])
    with pytest.raises(ValueError):
        scrape.NodeTarget("a:1", role="router")


# -- forensics ----------------------------------------------------------------

def stitched(addrs):
    """The slowest trace's timeline from either package's forensics."""
    out = []
    for mod in (forensics, ref_forensics):
        summaries = mod.fetch_spans(addrs, deadline_s=10.0)
        tid = mod.slowest_trace_id(summaries)
        out.append((tid, mod.stitch_timeline(mod.fetch_spans(addrs, trace_id=tid,
                                                             deadline_s=10.0), tid)))
    return out


def test_forensics_stitches_a_port_request_alike(port_stack):
    addrs = [port_stack.coord_cfg["ClientAPIListenAddr"], *port_stack.coord_cfg["Workers"]]
    (tid, got), (ref_tid, want) = stitched(addrs)
    assert tid == ref_tid and got == want
    assert "coordinator" in got["nodes"] and any(n.startswith("worker") for n in got["nodes"])
    assert forensics.render_timeline(got) == ref_forensics.render_timeline(want)
    assert got["slowest"]["name"] not in forensics.UMBRELLA_SPANS


def test_forensics_stitches_a_reference_request_alike(reference_stack):
    (tid, got), (ref_tid, want) = stitched(list(reference_stack))
    assert tid == ref_tid and got == want and got["spans"]
    assert forensics.render_timeline(got) == ref_forensics.render_timeline(want)
    for span in got["spans"]:
        assert forensics.shard_of(span) == ref_forensics.shard_of(span)
    # a reply from an unreachable node is reported, never waited for
    fetched = forensics.fetch_spans(["127.0.0.1:1"], trace_id=tid, deadline_s=1.0)
    assert list(fetched["unreachable"]) == ["127.0.0.1:1"]
