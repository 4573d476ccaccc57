"""The port's observability and load CLIs (``python -m
distpow_tpu_torch.cli.{stats,slo,forensics,soak}``) held against the
reference's.

* ``cli/stats.py`` ``render_prometheus`` and ``render_cluster_prometheus``
  are byte-equal to the reference's on the same snapshots (a port worker's
  ``device`` and ``kernel_launches`` get no family).
* Against a port stack of processes (tracing server, coordinator, two
  python-backend workers), ``stats``, ``slo``, ``forensics`` and ``soak
  --addr`` exit with the reference CLIs' codes on the same arguments: a
  green gate, a breached one, a malformed config, an unknown trace, a dead
  node.
* ``cli.soak``'s in-process mode boots python-backend workers with
  ``--device cpu`` and exits 2 without it on a host without a GPU.
* ``chip_smoke.py``'s observability leg (``observe_stack``) and its
  Prometheus parser run here against the same stack.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import subprocess
import sys

import pytest
import torch

from distpow_tpu.cli import forensics as ref_forensics_cli
from distpow_tpu.cli import slo as ref_slo_cli
from distpow_tpu.cli import soak as ref_soak_cli
from distpow_tpu.cli import stats as ref_stats_cli
from distpow_tpu_torch.cli import forensics as forensics_cli
from distpow_tpu_torch.cli import slo as slo_cli
from distpow_tpu_torch.cli import soak as soak_cli
from distpow_tpu_torch.cli import stats as stats_cli
from distpow_tpu_torch.obs.merge import merge_snapshots
from distpow_tpu_torch.runtime.metrics import Metrics
from tests.test_torch_cli import PortProcStack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLO_JSON = os.path.join(REPO, "config", "slo.json")


def seeded_snapshot(seed, role, port_worker=False):
    rng = random.Random(seed)
    m = Metrics()
    m.inc("coord.mine_rpcs", rng.randrange(1, 40))
    m.inc("faults.injected.delay", 2)
    m.gauge("proc.rss_bytes", rng.randrange(1 << 20, 1 << 30))
    m.gauge("search.hashes_per_s", rng.random() * 1e9)
    for i in range(200):
        v = rng.choice((rng.lognormvariate(-4.0, 2.0), 0.0, rng.uniform(0, 3)))
        m.observe("coord.mine_s.miss", v, trace_id=(i + 1) * 97 if i % 5 == 0 else None)
        m.observe("rpc.client.call_s.CoordRPCHandler.Mine", v / 7)
    snap = m.snapshot()
    snap["role"] = role
    if port_worker:
        snap.update(device="cuda:0", kernel_launches={"md5_search": 8,
                                                      "md5_search_persistent": 19},
                    backend="CudaBackend")
    return snap


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_prometheus_text_is_the_references(seed, openmetrics):
    snap = seeded_snapshot(seed, "worker", port_worker=True)
    text = stats_cli.render_prometheus(snap, openmetrics=openmetrics)
    assert text == ref_stats_cli.render_prometheus(snap, openmetrics=openmetrics)
    assert "kernel_launches" not in text and "cuda:0" not in text
    bare = {k: v for k, v in snap.items() if k not in ("device", "kernel_launches", "backend")}
    assert stats_cli.render_prometheus(bare, openmetrics=openmetrics) == text
    cluster = merge_snapshots(
        {"c": seeded_snapshot(seed + 10, "coordinator"), "w1": snap,
         "w2": seeded_snapshot(seed + 20, "worker")},
        {"w2": {"status": "stale", "age_s": 12.5, "error": "deadline"}})
    text = stats_cli.render_cluster_prometheus(cluster, openmetrics=openmetrics)
    assert text == ref_stats_cli.render_cluster_prometheus(cluster, openmetrics=openmetrics)
    assert 'distpow_node_stale{node="w2"} 1' in text
    assert text.endswith("# EOF\n") == openmetrics
    families = chip_smoke().check_prometheus(text, openmetrics=openmetrics)
    assert "distpow_coord_mine_s_miss" in families["histogram"]


def test_prometheus_parser_refuses_a_broken_exposition():
    text = stats_cli.render_prometheus(seeded_snapshot(3, "coordinator"), openmetrics=True)
    cs = chip_smoke()
    for broken in (text.replace("# EOF\n", ""),
                   text.replace('_bucket{le="+Inf"} ', '_bucket{le="+Inf"} 9', 1),
                   text.replace("distpow_coord_mine_rpcs_total ",
                                "distpow_coord_mine_rpcs_total x")):
        with pytest.raises((AssertionError, ValueError)):
            cs.check_prometheus(broken)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Every process the port's; the demo client has run at 8 difficulty
    bits, so the nodes have spans and histograms."""
    tmp = tmp_path_factory.mktemp("obs_cli_stack")
    s = PortProcStack(tmp, workers=2, seed=654)
    try:
        s.boot_core()
        for i in range(2):
            s.boot_port_worker(i)
        client = s.spawn("-m", "distpow_tpu_torch.cli.client",
                         "--config", s.config("client_config.json"),
                         "--config2", s.config("client2_config.json"), "--difficulty-bits", "8")
        out, _ = client.communicate(timeout=120)
        assert client.returncode == 0, out
        s.coord_addr = s.coord_cfg["ClientAPIListenAddr"]
        s.addr_flags = [a for addr in (s.coord_addr, *s.coord_cfg["Workers"])
                        for a in ("--addr", addr)]
        s.tmp = tmp
        yield s
    finally:
        s.close()


def both(capsys, port_main, ref_main, argv):
    """Each package's CLI on the same arguments: both exit codes, and the
    port's output."""
    rc = port_main(argv)
    out = capsys.readouterr()
    ref_rc = ref_main(argv)
    capsys.readouterr()
    return rc, ref_rc, out


STATS_CASES = {
    "coordinator": (lambda s: ["--addr", s.coord_addr], 0),
    "worker_prom": (lambda s: ["--addr", s.coord_cfg["Workers"][0], "--prom", "--openmetrics"],
                    0),
    "cluster": (lambda s: ["--cluster", *s.addr_flags], 0),
    "cluster_prom": (lambda s: ["--cluster", *s.addr_flags, "--prom"], 0),
    "discover": (lambda s: ["--cluster", "--discover", s.coord_addr], 0),
    "cluster_dead_node": (lambda s: ["--cluster", "--addr", s.coord_addr, "--addr",
                                     "127.0.0.1:1", "--deadline", "1"], 1),
    "dead_node": (lambda s: ["--addr", "127.0.0.1:1", "--timeout", "1"], 1),
    "watch": (lambda s: ["--addr", s.coord_addr, "--watch", "0.05", "--count", "2"], 0),
}


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_stats_exit_codes_are_the_references(stack, capsys, case):
    argv, want = STATS_CASES[case]
    rc, ref_rc, out = both(capsys, stats_cli.main, ref_stats_cli.main, argv(stack))
    assert rc == ref_rc == want, out.err
    if case == "coordinator":
        assert json.loads(out.out)["role"] == "coordinator"
    if case == "worker_prom":
        assert out.out.rstrip("\n").endswith("# EOF")
    if case == "cluster":
        merged = json.loads(out.out)
        assert merged["nodes"] == 3 and merged["stale_nodes"] == []


def test_stats_json_shows_a_port_workers_device_and_launches(stack, capsys):
    assert stats_cli.main(["--addr", stack.coord_cfg["Workers"][1]]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["role"] == "worker" and snap["device"] == "cpu"
    assert snap["kernel_launches"] == {}  # python-backend workers launch no kernel


def tight_config(tmp):
    path = tmp / "tight_slo.json"
    path.write_text(json.dumps({"objectives": [{"name": "tight", "histogram":
                                                "coord.mine_s.miss", "max": 1e-9}]}))
    return str(path)


def malformed_config(tmp):
    path = tmp / "bad_slo.json"
    path.write_text(json.dumps({"objectives": [{"name": "x", "histogram": "coord.typo",
                                                "max": 1}]}))
    return str(path)


SLO_CASES = {
    "green": (lambda s: ["--config", SLO_JSON, *s.addr_flags], 0),
    "green_json_discover": (lambda s: ["--config", SLO_JSON, "--discover", s.coord_addr,
                                       "--json"], 0),
    "repeated_sweeps": (lambda s: ["--config", SLO_JSON, *s.addr_flags, "--interval", "0.05",
                                   "--count", "2"], 0),
    "breach": (lambda s: ["--config", tight_config(s.tmp), *s.addr_flags], 1),
    "malformed": (lambda s: ["--config", malformed_config(s.tmp), *s.addr_flags], 2),
    "missing_config": (lambda s: ["--config", str(s.tmp / "none.json"), *s.addr_flags], 2),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_exit_codes_are_the_references(stack, capsys, case):
    argv, want = SLO_CASES[case]
    rc, ref_rc, out = both(capsys, slo_cli.main, ref_slo_cli.main, argv(stack))
    assert rc == ref_rc == want, out.err
    if case == "green_json_discover":
        verdict = json.loads(out.out)
        assert verdict["status"] in ("pass", "warn") and verdict["stale_nodes"] == []


FORENSICS_CASES = {
    "slowest": (lambda s: s.addr_flags, 0),
    "slowest_json": (lambda s: [*s.addr_flags, "--json"], 0),
    "discover": (lambda s: ["--discover", s.coord_addr], 0),
    "unknown_trace": (lambda s: [*s.addr_flags, "--trace", "12345"], 1),
    "dead_node": (lambda s: ["--addr", "127.0.0.1:1", "--deadline", "1"], 1),
}


@pytest.mark.parametrize("case", sorted(FORENSICS_CASES))
def test_forensics_exit_codes_are_the_references(stack, capsys, case):
    argv, want = FORENSICS_CASES[case]
    rc, ref_rc, out = both(capsys, forensics_cli.main, ref_forensics_cli.main, argv(stack))
    assert rc == ref_rc == want, out.err
    if case == "slowest_json":
        timeline = json.loads(out.out)
        assert "coordinator" in timeline["nodes"]
        assert any(n.startswith("worker") for n in timeline["nodes"])


SOAK_CASES = {
    "attached": (lambda s: ["--config", SLO_JSON, "--addr", s.coord_addr, "--minutes", "0.04",
                            "--interval", "0.5"], 0),
    "attached_malformed": (lambda s: ["--config", malformed_config(s.tmp), "--addr",
                                      s.coord_addr, "--minutes", "0.04"], 2),
    "bad_shape": (lambda s: ["--config", SLO_JSON, "--addr", s.coord_addr, "--minutes", "0"],
                  2),
}


@pytest.mark.parametrize("case", sorted(SOAK_CASES))
def test_soak_attached_exit_codes_are_the_references(stack, capsys, case):
    argv, want = SOAK_CASES[case]
    rc, ref_rc, out = both(capsys, soak_cli.main, ref_soak_cli.main, argv(stack))
    assert rc == ref_rc == want, out.err
    if case == "attached":
        assert out.out.startswith("Soak verdict: PASS")


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: these tests describe a machine without one")


def test_soak_in_process_runs_on_the_cpu_only_when_asked(no_gpu, capsys):
    base = ["--config", SLO_JSON, "--workers", "1", "--minutes", "0.04", "--interval", "0.5"]
    assert soak_cli.main(base) == 2
    assert "needs a GPU" in capsys.readouterr().err
    assert soak_cli.main([*base, "--device", "cuda:0"]) == 2
    capsys.readouterr()
    # with --device cpu, in a fresh process: the SLO config judges the error
    # rate of the whole process, which in-process nodes share
    proc = subprocess.run([sys.executable, "-m", "distpow_tpu_torch.cli.soak", *base,
                           "--device", "cpu", "--json"], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(proc.stdout)
    assert report["verdict"]["status"] == "pass" and report["request_errors"] == 0
    # a bad config is refused before any cluster boots
    assert soak_cli.main(["--config", "/nonexistent.json", "--device", "cpu"]) == 2


def test_chip_smokes_observability_leg_runs_against_the_stack(stack):
    """``observe_stack`` as ``demo`` runs it on the card, here with the
    workers on the CPU (no kernel launches to count) and a short soak."""
    cs = chip_smoke()
    env = dict(stack.env, PYTHONPATH=REPO)
    out_dir = stack.tmp / "observe"
    out_dir.mkdir()
    res = cs.observe_stack(stack.coord_addr, stack.coord_cfg["Workers"], str(out_dir), env,
                           device="cpu", launched=False, soak_minutes=0.04)
    assert res["slo"]["status"] in ("pass", "warn")
    assert res["soak"][0] == "Soak verdict: PASS"
    assert "coordinator" in res["forensics"]["nodes"]
    assert set(res["libcuda_mapped"]) == {"stats_coordinator", "stats_worker1", "stats_worker2",
                                          "stats_cluster_prom", "slo", "forensics", "soak"}
    assert not any(res["libcuda_mapped"].values())
    with pytest.raises(AssertionError, match="kernel launches"):
        cs.observe_stack(stack.coord_addr, stack.coord_cfg["Workers"], str(out_dir), env,
                         device="cpu", launched=True, soak_minutes=0.04)


def test_chip_smoke_registers_load_after_demo():
    from tests.test_torch_chip_smoke import _phase_registrations

    phases = _phase_registrations()
    names = [name for name, _ in phases]
    assert dict(phases)["load"] == ("build", "mine")
    assert names.index("demo") < names.index("load") < names.index("mesh_procs")
    cs = chip_smoke()
    assert cs.LOAD_WORKERS == 4 and cs.LOAD_MIX["difficulties"] == ((5, 0.5), (7, 0.5))
    assert (cs.LOAD_MIX["rate_hz"], cs.LOAD_MIX["duration_s"], cs.LOAD_MIX["n_keys"]) == \
        (10.0, 20.0, 64)
