"""Find a cell and everything it names, by name, from ``BENCHMARK.json``.

Nothing here lists a cell, a configuration, a traffic mix or a metric: a
cell's entry in ``BENCHMARK.json`` names its configuration (the file that
the configuration's entry names), its mix (``traffic/<traffic>.json``) and
its chips; a per-layer metric ``<name>`` is read by
``metrics/<name>.py``'s ``read(window)``.  So a later cell, configuration,
mix or metric is added by adding its entries and files.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List

from .traffic import Mix

PKG = os.path.basename(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: Mix
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _reader(root: str, name: str) -> Callable:
    path = os.path.join(root, PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load(root: str, workload: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = _entry(bench["workloads"], workload, "workload")
    conf = _entry(bench["configs"], cell["config"], "config")
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, PKG, "traffic", f"{cell['traffic']}.json")) as fh:
        mix = Mix(json.load(fh))
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(workload, int(cell["chips"]), config, mix, e2e, per_layer,
                {m["name"]: _reader(root, m["name"]) for m in per_layer})
