"""The port's load plane (``distpow_tpu_torch/load/``) held against the
reference's (``distpow_tpu/load/``).

* Load generation: ``build_schedule`` and ``build_shaped_schedule`` give
  equal ``Arrival`` lists per seed; every shape's rate, peak and phases are
  equal at sampled times, as are ``compress`` and ``exact_percentile``.
* The open-loop runner fires a schedule without waiting for completions.
* Load and soak runs: ``run_load_slo`` and a green ``run_soak`` on
  ``InProcCluster(n_workers=1, backend="python", device="cpu")`` give the
  reference harness's secrets per nonce (one difficulty per mix, one
  worker: every request of a nonce gets its first hit), and both exit 0.
  They run in a fresh process, whose registries hold only these runs.
  The reference's planted-leak case, marked slow there, is marked slow
  here too.
* No fallback: ``InProcCluster()``, ``run_load_slo`` and ``run_soak``
  without a cluster raise on a host without a GPU, and boot nothing.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from distpow_tpu import load as ref_load
from distpow_tpu.load import harness as ref_harness
from distpow_tpu.load import shapes as ref_shapes
from distpow_tpu.load import soak as ref_soak
from distpow_tpu_torch import load
from distpow_tpu_torch.load import harness, shapes
from distpow_tpu_torch.load import soak as soak_module
from distpow_tpu_torch.runtime.metrics import REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLO_JSON = os.path.join(REPO, "config", "slo.json")

MIXES = [
    dict(rate_hz=50.0, duration_s=4.0, seed=905, n_keys=8, zipf_s=1.2,
         difficulties=((1, 0.7), (2, 0.3))),
    dict(rate_hz=10.0, duration_s=20.0, seed=1, n_keys=64, zipf_s=1.1, nonce_len=4,
         difficulties=((5, 0.5), (7, 0.5))),
    dict(rate_hz=30.0, duration_s=3.0, seed=77, n_keys=5, zipf_s=0.0, nonce_len=9,
         hash_models=((None, 0.5), ("sha1", 0.3), ("sha3_256", 0.2))),
]


def mixes(mix):
    return load.LoadMix(**mix), ref_load.LoadMix(**mix)


def as_tuples(arrivals):
    return [(a.t, a.key, a.nonce, a.ntz, a.hash_model) for a in arrivals]


@pytest.mark.parametrize("mix", MIXES, ids=["skewed", "chip_load", "uniform_models"])
def test_schedules_are_the_references(mix):
    port, ref = mixes(mix)
    got = as_tuples(load.build_schedule(port))
    assert got and got == as_tuples(ref_load.build_schedule(ref))
    assert got == as_tuples(load.build_schedule(load.LoadMix(**mix)))  # deterministic
    other = load.LoadMix(**{**mix, "seed": mix["seed"] + 1})
    assert as_tuples(load.build_schedule(other)) != got


def test_mix_validation_alike():
    bad = [dict(rate_hz=0.0, duration_s=1.0), dict(rate_hz=1.0, duration_s=1.0, n_keys=0),
           dict(rate_hz=1.0, duration_s=1.0, difficulties=()),
           dict(rate_hz=1.0, duration_s=1.0, hash_models=((None, 0.0),))]
    for kw in bad:
        with pytest.raises(ValueError):
            load.LoadMix(**kw)
        with pytest.raises(ValueError):
            ref_load.LoadMix(**kw)


def shape_pairs():
    """Each shape built in both packages from the same arguments."""
    out = []
    for mod in (shapes, ref_shapes):
        day = mod.Diurnal(base=6.0, amplitude=4.0, period_s=40.0)
        crowd = mod.FlashCrowd(extra_hz=10.0, at_s=22.0, width_s=4.0, duration_s=40.0)
        out.append({
            "constant": mod.Constant(8.0, 5.0),
            "diurnal": day,
            "two_days": mod.Diurnal(base=3.0, amplitude=1.0, period_s=20.0, duration_s=40.0),
            "trough": mod.Diurnal(base=3.0, amplitude=5.0, period_s=40.0),
            "crowd": crowd,
            "ramp": mod.Ramp(start_hz=2.0, end_hz=10.0, duration_s=10.0),
            "sum": mod.Sum(parts=(day, crowd)),
            "compressed": mod.compress(mod.Sum(parts=(day, crowd)), 8.0),
            "soak_cli": mod.compress(mod.Sum(parts=(
                mod.Diurnal(base=6.0 / 320, amplitude=4.0 / 320, period_s=4800.0),
                mod.FlashCrowd(extra_hz=18.0 / 320, at_s=2640.0, width_s=384.0,
                               duration_s=4800.0))), 320.0),
        })
    return out


@pytest.mark.parametrize("name", ["constant", "diurnal", "two_days", "trough", "crowd", "ramp",
                                  "sum", "compressed", "soak_cli"])
def test_shapes_are_the_references(name):
    port_shapes, ref_shapes_ = shape_pairs()
    port, ref = port_shapes[name], ref_shapes_[name]
    assert port.duration_s == ref.duration_s
    assert port.peak_hz() == ref.peak_hz()
    assert port.phases() == ref.phases()
    assert port.phases(port.duration_s / 2) == ref.phases(ref.duration_s / 2)
    for i in range(-3, 400):
        t = i * port.duration_s / 397
        assert port.rate_hz(t) == ref.rate_hz(t)
    mix = dict(rate_hz=1.0, duration_s=1.0, seed=1811, n_keys=24, zipf_s=1.1,
               difficulties=((1, 0.7), (2, 0.3)))
    port_mix, ref_mix = mixes(mix)
    got = as_tuples(shapes.build_shaped_schedule(port, port_mix))
    assert got == as_tuples(ref_shapes.build_shaped_schedule(ref, ref_mix))


def test_compression_and_exact_percentile_alike():
    inner = shapes.Diurnal(base=5.0, amplitude=3.0, period_s=200.0)
    squeezed = shapes.compress(inner, 100.0)
    ref_squeezed = ref_shapes.compress(ref_shapes.Diurnal(base=5.0, amplitude=3.0,
                                                          period_s=200.0), 100.0)
    assert squeezed.duration_s == ref_squeezed.duration_s == pytest.approx(2.0)
    assert squeezed.phases() == ref_squeezed.phases()
    expected = 5.0 * 200.0
    n = len(shapes.build_shaped_schedule(squeezed, load.LoadMix(rate_hz=1.0, duration_s=1.0,
                                                                seed=3)))
    assert abs(n - expected) < 4.0 * math.sqrt(expected)
    with pytest.raises(ValueError):
        shapes.Compressed(inner=inner, factor=0.0)
    with pytest.raises(ValueError):
        shapes.Sum(parts=())
    for samples in ([], [1.0], [3.0, 1.0, 2.0], [float(i % 17) / 3 for i in range(101)]):
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert load.exact_percentile(samples, q) == ref_load.exact_percentile(samples, q)
    for a, b in ((None, None), ({"p95": 1.0}, {"p95": 1.1}), ({"p95": 1.0}, {"p95": 1.3}),
                 ({"p95": 0.0}, {"p95": 2.0})):
        assert load.percentile_within_one_bucket(a, b) == \
            ref_load.percentile_within_one_bucket(a, b)


def test_runner_is_open_loop_and_counts_errors():
    sched = load.build_schedule(load.LoadMix(rate_hz=40.0, duration_s=0.6, seed=5))
    started = []

    def slow(arr):
        started.append(time.monotonic())
        if len(started) % 3 == 0:
            raise RuntimeError("refused")
        time.sleep(0.001)

    rep = load.OpenLoopRunner(slow).run(sched)
    assert rep.issued == len(sched) == len(started)
    assert rep.submit_errors == len(sched) // 3
    assert rep.to_dict()["issued"] == len(sched) and rep.max_lag_s < 0.5
    runner = load.OpenLoopRunner(lambda arr: None)
    runner.stop()
    assert runner.run(sched).issued == 0


# -- runs on an in-process cluster -------------------------------------------

def secrets_of(trackers):
    """Each completion's secret by (nonce, difficulty), from the trackers
    that ``harness.keeping_results`` handed out."""
    secrets = {}
    for tracker in trackers:
        for res in tracker.results:
            assert res.error is None, res.error
            secrets.setdefault(f"{bytes(res.nonce).hex()}:{res.num_trailing_zeros}",
                               []).append(bytes(res.secret).hex())
    return secrets


ONE_DIFFICULTY = dict(rate_hz=12.0, duration_s=2.5, seed=905, n_keys=8, zipf_s=1.2,
                      difficulties=((2, 1.0),))
SOAK_MIX = dict(rate_hz=1.0, duration_s=1.0, seed=1811, n_keys=24, zipf_s=1.1,
                difficulties=((2, 1.0),))


def harness_runs(kind, spool=None):
    """``run_load_slo`` (``kind="load"``) or a green ``run_soak``
    (``"soak"``), each package's on its own one-worker python-backend
    cluster: the reports, the verdicts and the secrets their harnesses
    drained.  The tests run it in a fresh process, whose registries hold
    only these runs (every node of a process shares one, and the SLO
    config judges the error rate of the whole process)."""
    out = {}
    for side in ("port", "reference"):
        if side == "port":
            cluster = load.InProcCluster(n_workers=1, backend="python", device="cpu")
            mods, run_load, run_soak, constant = ([harness, soak_module], load.run_load_slo,
                                                  load.run_soak, shapes.Constant)
            mix_cls = load.LoadMix
        else:
            cluster = ref_load.InProcCluster(n_workers=1, backend="python")
            mods, run_load, run_soak, constant = ([ref_harness, ref_soak], ref_load.run_load_slo,
                                                  ref_load.run_soak, ref_shapes.Constant)
            mix_cls = ref_load.LoadMix
        try:
            with harness.keeping_results(mods) as trackers:
                if kind == "load":
                    report, verdict = run_load(mix_cls(**ONE_DIFFICULTY), SLO_JSON,
                                               cluster=cluster, scrape_interval_s=0.5,
                                               include_worker_targets=side == "port")
                else:
                    report, verdict = run_soak(constant(8.0, 3.0), mix_cls(**SOAK_MIX), SLO_JSON,
                                               cluster=cluster, scrape_interval_s=0.3,
                                               spool_path=spool if side == "port" else None)
        finally:
            cluster.close()
        out[side] = {"report": report, "verdict": verdict.to_dict(),
                     "exit_code": verdict.exit_code(), "render": verdict.render(),
                     "secrets": secrets_of(trackers)}
    return out


def fresh_process_runs(kind, spool=None):
    code = ("import json, sys\n"
            "from tests import test_torch_load as t\n"
            f"print(json.dumps(t.harness_runs({kind!r}, {spool!r}), default=str))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_run_load_slo_gives_the_reference_harness_secrets():
    from distpow_tpu.models import puzzle

    runs = fresh_process_runs("load")
    port, ref = runs["port"], runs["reference"]
    report, ref_report = port["report"], ref["report"]
    assert report["request_errors"] == ref_report["request_errors"] == 0
    assert report["completed"] == report["load"]["issued"] == ref_report["completed"] > 10
    secrets = {key: set(v) for key, v in port["secrets"].items()}
    assert secrets == {key: set(v) for key, v in ref["secrets"].items()}
    assert all(len(v) == 1 for v in secrets.values())
    for key, (secret,) in secrets.items():
        nonce, ntz = key.split(":")
        assert puzzle.check_secret(bytes.fromhex(nonce), bytes.fromhex(secret), int(ntz))
    assert report["merged"]["cache_hits"] > 0 and report["merged"]["stale_nodes"] == []
    assert report["oracle_check"]["ok"] and report["oracle_check"]["nodes"] == 2
    assert port["exit_code"] == ref["exit_code"] == 0
    assert set(report) == set(ref_report) | {"oracle_check"}


def test_tightened_config_breaches_alike():
    tight = {"objectives": [{"name": "mine_e2e_p95_s", "histogram": "coord.mine_s.miss",
                             "stat": "p95", "max": 1e-6}]}
    mix = dict(rate_hz=10.0, duration_s=1.0, seed=907, n_keys=6, difficulties=((1, 1.0),))
    port_mix, _ = mixes(mix)
    cluster = load.InProcCluster(n_workers=1, backend="torch", device="cpu",
                                 worker_extra={"BatchSize": 1 << 10})
    try:
        report, verdict = load.run_load_slo(port_mix, tight, cluster=cluster, breach_hooks=False)
    finally:
        cluster.close()
    assert report["completed"] > 0 and verdict.status == "breach" and verdict.exit_code() == 1


def test_green_soak_gives_the_reference_soaks_secrets(tmp_path):
    spool = str(tmp_path / "spool.jsonl")
    runs = fresh_process_runs("soak", spool)
    port, ref = runs["port"], runs["reference"]
    report, verdict = port["report"], port["verdict"]
    assert port["exit_code"] == ref["exit_code"] == 0
    assert verdict["status"] == "pass" and not verdict["failures"]
    assert not verdict["leak_suspects"]
    assert report["request_errors"] == 0 and report["completed"] == report["load"]["issued"] > 10
    assert report["phases"] == ref["report"]["phases"]
    assert {k: set(v) for k, v in port["secrets"].items()} == \
        {k: set(v) for k, v in ref["secrets"].items()}
    assert [p["name"] for p in verdict["phases"]] == \
        [p["name"] for p in ref["verdict"]["phases"]]
    assert "Soak verdict: PASS" in port["render"]
    from distpow_tpu.obs.timeseries import replay_spool as ref_replay

    assert len(list(ref_replay(spool))) == report["retention"]["points"]


@pytest.mark.slow
def test_planted_thread_leak_flips_the_verdict_nonzero():
    """One parked thread per request climbs proc.threads past the
    sentinel's noise floor and fails the soak by name."""
    cluster = load.InProcCluster(n_workers=2, backend="python", device="cpu")
    stop = threading.Event()
    parked = []
    real_mine = cluster.client.mine

    def leaky_mine(*a, **kw):
        t = threading.Thread(target=stop.wait, daemon=True)
        t.start()
        parked.append(t)
        return real_mine(*a, **kw)

    cluster.client.mine = leaky_mine
    before = REGISTRY.get("health.leak_suspects")
    try:
        report, verdict = load.run_soak(
            shapes.Constant(8.0, 6.0),
            load.LoadMix(rate_hz=1.0, duration_s=1.0, seed=1812, n_keys=24, zipf_s=1.1,
                         difficulties=((1, 0.7), (2, 0.3))),
            SLO_JSON, cluster=cluster, scrape_interval_s=0.25)
    finally:
        stop.set()
        time.sleep(0.05)
        cluster.close()
    assert len(parked) > 20
    assert verdict.exit_code() == 1 and verdict.status == "breach"
    assert "proc.threads" in [s["gauge"] for s in verdict.leak_suspects]
    assert any("proc.threads" in f for f in verdict.failures)
    assert REGISTRY.get("health.leak_suspects") >= before + 1


# -- no fallback --------------------------------------------------------------

@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: these tests describe a machine without one")


def test_no_cluster_boots_on_the_cpu_unasked(no_gpu, monkeypatch):
    booted = []
    monkeypatch.setattr(harness, "Coordinator", lambda *a, **kw: booted.append(a))
    for call in (lambda: load.InProcCluster(),
                 lambda: load.InProcCluster(n_workers=1, backend="python"),
                 lambda: load.run_load_slo(load.LoadMix(rate_hz=1.0, duration_s=1.0), SLO_JSON),
                 lambda: load.run_soak(shapes.Constant(1.0, 1.0),
                                       load.LoadMix(rate_hz=1.0, duration_s=1.0), SLO_JSON)):
        with pytest.raises(RuntimeError, match="needs a GPU"):
            call()
    assert booted == []  # the device is checked before any node boots
