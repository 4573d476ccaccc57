"""Fixtures of the benchmark's own tests (``python -m pytest portbench/tests``).

``tiny_root`` is a checkout of its own: a copy of ``portbench/``, the
port's package linked in, and a ``BENCHMARK.json`` with one more cell,
``tiny.d1-2`` (two md5 workers, difficulties 1 and 2, two clients), that
the CPU runs at a size a test can hold.  Tests that need a card take the
``card`` fixture, which skips where there is none, and carry the ``card``
marker."""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_MIX = {"source": "tests", "clients": 2, "nonce_len": 4,
            "difficulties": [[1, 1.0], [2, 1.0]], "pool_seed": 1, "block": 4,
            "warmup": {"requests": 2}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


def make_root(path, workers: int = 2) -> str:
    root = str(path)
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "distpow_tpu_torch"), os.path.join(root, "distpow_tpu_torch"))
    with open(os.path.join(REPO, "portbench", "configs", "md5-1w.json")) as fh:
        cfg = json.load(fh)
    cfg["Workers"] = workers
    cfg["worker"]["WarmupWidths"] = [0, 1]
    with open(os.path.join(root, "portbench", "configs", "tiny.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "portbench", "traffic", "d1-2.json"), "w") as fh:
        json.dump(TINY_MIX, fh)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny", "source": "tests", "reduced": [], "why": "tests",
                             "file": "portbench/configs/tiny.json"})
    bench["workloads"].append({"name": "tiny.d1-2", "config": "tiny", "traffic": "d1-2",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"]:  # the tiny cell reports every end-to-end metric
        m.get("workloads", []).append("tiny.d1-2")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
