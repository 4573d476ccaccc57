"""Whole runs on the CPU at a size a test can hold: the deployment's
processes, the client, the window and the judgement, without the look for
a card.  A sound run is correct; each fault that the cells can have, and
the control, are not."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run

from conftest import REPO, make_root


def _run(root, fault=None, trace=False, cell="tiny.d1-2"):
    return run.run(cell, 3000000001, 2.0, trace, root=root, device="cpu", fault=fault,
                   close_wait_s=20.0, setup_timeout_s=120.0)


def test_a_sound_run_is_correct_and_reports_its_metrics(tiny_root):
    res = _run(tiny_root)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"solve_rate", "solve_p50_ms", "solve_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())
    assert res["card"] == {}  # no card looked for


def test_a_node_that_loads_jax_fails_the_run(tiny_root):
    # a worker that loads a module named as the JAX package, after the window
    with open(os.path.join(tiny_root, "portbench", "faults.py"), "a") as fh:
        fh.write("\n\nimport sys as _sys, types as _types\n"
                 "_sys.modules.setdefault('distpow_tpu', _types.ModuleType('distpow_tpu'))\n")
    with pytest.raises(RuntimeError, match="distpow_tpu"):
        _run(tiny_root)


def test_a_traced_run_reports_its_per_layer_metrics(tiny_root):
    res = _run(tiny_root, trace=True)
    assert res["correct"], res["checks"]
    # no card: the device's metrics find nothing to read and are left out
    assert set(res["metrics"]) == {"coord.first_result_ms", "coord.cancel_ms",
                                   "worker.solve_ms", "search.launch_ms_per_solve"}
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] >= 2.0


@pytest.mark.parametrize("fault", ["easy", "answer", "half", "exchange"])
def test_a_planted_fault_makes_the_run_incorrect(tiny_root, fault):
    res = _run(tiny_root, fault=fault)
    assert not res["correct"], res["checks"]


def test_a_run_without_the_program_fails_with_no_result(tmp_path):
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "md5-1w.d8-closed4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_a_run_without_a_card_fails_with_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "md5-1w.d8-closed4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.card
def test_on_the_card_the_control_fails_and_a_run_passes(card, tmp_path):
    root = make_root(tmp_path)
    good = run.run("md5-1w.d8-closed4", 11, 5.0, False, root=root)
    control = run.run("md5-1w.d8-closed4", 12, 5.0, False, root=root, fault="easy")
    assert good["correct"] and not control["correct"]
    assert json.dumps(good)
