"""BENCHMARK.json against the benchmark's contract, and the harness finding
cells, configurations, mixes and metrics by name."""

import json
import os
import re

import pytest

from portbench import reference, spec
from portbench.traffic import Mix
from portbench.window import Window

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and all(_line(w) for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(REPO, c["file"]))
        with open(os.path.join(REPO, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        names.add(c["name"])
    used = set()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(REPO, "portbench", "traffic", f"{w['traffic']}.json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == names
    four = sum(1 for w in b["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(b["workloads"]) // 4)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(REPO, "portbench", "metrics", f"{m['name']}.py"))
        layers.add(m["layer"])
    all_names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(all_names) == len(set(all_names))
    assert len(json.dumps(b)) <= 64 * 1024
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    for w in b["workloads"]:
        cell = spec.load(REPO, w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer


def test_every_cell_loads_by_name():
    for w in _bench()["workloads"]:
        cell = spec.load(REPO, w["name"])
        assert cell.chips == w["chips"] and cell.config["Workers"] >= 1
        assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    md5 = spec.load(REPO, "md5-1w.d8-closed4")
    sha = spec.load(REPO, "sha256d-1w.d8-closed4")
    # the tail only where a window holds some hundreds of solves
    assert "solve_p95_ms" in {m["name"] for m in md5.end_to_end}
    assert "solve_p95_ms" not in {m["name"] for m in sha.end_to_end}
    assert set(md5.readers) == set(sha.readers)


def test_every_mix_names_its_source_and_only_known_keys():
    for name in os.listdir(os.path.join(REPO, "portbench", "traffic")):
        with open(os.path.join(REPO, "portbench", "traffic", name)) as fh:
            params = json.load(fh)
        assert _line(Mix(params).source)
        with pytest.raises(ValueError):
            Mix({**params, "loop": "open"})
        with pytest.raises(ValueError):
            Mix({k: v for k, v in params.items() if k != "source"})


def test_a_cell_configuration_mix_and_metric_are_added_by_adding_files(tiny_root):
    pkg = os.path.join(tiny_root, "portbench")
    with open(os.path.join(pkg, "configs", "extra.json"), "w") as fh:
        json.dump({"Workers": 3, "hash_model": "sha1", "reduced": []}, fh)
    with open(os.path.join(pkg, "traffic", "extra-mix.json"), "w") as fh:
        json.dump({"source": "tests", "clients": 3, "nonce_len": 4, "difficulties": [[5, 1.0]],
                   "pool_seed": 5, "block": 16, "warmup": {"requests": 0}}, fh)
    with open(os.path.join(pkg, "metrics", "extra_metric.py"), "w") as fh:
        fh.write("def read(window):\n    return window.seconds * 2\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "extra", "source": "tests", "reduced": [], "why": "tests",
                             "file": "portbench/configs/extra.json"})
    bench["workloads"].append({"name": "extra.extra-mix", "config": "extra",
                               "traffic": "extra-mix", "chips": 4, "why": "tests"})
    bench["per_layer"].append({"name": "extra_metric", "unit": "s", "better": "lower",
                               "source": "program_counter", "layer": "worker",
                               "moves": "solve_rate", "workloads": ["extra.extra-mix"]})
    with open(path, "w") as fh:
        json.dump(bench, fh)
    cell = spec.load(tiny_root, "extra.extra-mix")
    assert cell.chips == 4 and cell.config["hash_model"] == "sha1" and cell.mix.clients == 3
    assert "extra_metric" in cell.readers and "coord.cancel_ms" in cell.readers
    empty = ({"counters": {}, "histograms": {}},) * 2
    assert cell.readers["extra_metric"](Window(1.5, cell.config, [], empty, [])) == 3.0
    assert "extra_metric" not in spec.load(tiny_root, "md5-1w.d8-closed4").readers
    with pytest.raises(KeyError):
        spec.load(tiny_root, "no.such-cell")


def test_every_seed_sends_the_same_puzzles_in_another_order():
    mix = Mix({"source": "tests", "clients": 4, "nonce_len": 4,
               "difficulties": [[8, 1.0], [9, 1.0]], "pool_seed": 89, "block": 16,
               "warmup": {"requests": 8}})

    def first(seed, n):
        gen = mix.closed(seed)
        return [next(gen) for _ in range(n)]

    a, b = first(3000000001, 64), first(7, 64)
    assert a == first(3000000001, 64) and a != b
    for blk in range(4):
        assert sorted(a[blk * 16:(blk + 1) * 16], key=lambda r: r.nonce) == \
            sorted(b[blk * 16:(blk + 1) * 16], key=lambda r: r.nonce)
    assert len({r.nonce for r in a}) == 64
    assert {r.ntz for r in a} == {8, 9}
    assert not {r.nonce for r in mix.warmup()} & {r.nonce for r in a}


def test_reference_matches_the_port_on_secrets_and_partitions():
    from distpow_tpu_torch.models import puzzle
    from distpow_tpu_torch.parallel import partition

    nonce = bytes([1, 2, 3, 4])
    for model in ("md5", "sha256d"):
        for secret in (b"\x00", b"\x17\x01", b"\xff\x00\x10"):
            for ntz in (0, 1, 2):
                assert reference.solves(model, nonce, secret, ntz) == \
                    puzzle.check_secret(nonce, secret, ntz, model)
    for n in (1, 2, 4, 8):
        owned = [reference.first_bytes(w, n) for w in range(n)]
        assert owned == [partition.thread_bytes(w, partition.worker_bits(n)) for w in range(n)]
        assert sorted(b for o in owned for b in o) == list(range(256))


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_candidates_count_the_ports_order_to_the_secret(workers):
    from distpow_tpu_torch.parallel import partition
    from distpow_tpu_torch.parallel.search import assemble_secret, width_segments

    for w in range(workers):
        tbs = partition.thread_bytes(w, partition.worker_bits(workers))
        tried = 0  # the port's order: widths 0 and 1, then width 2's first chunks
        for width in range(3):
            for vw, lo, hi, extra in width_segments(width):
                for chunk in range(lo, min(hi, lo + 300)):
                    for f in range(len(tbs)):
                        secret, _ = assemble_secret(chunk, f, vw, extra, tbs[0], len(tbs))
                        tried += 1
                        assert reference.candidates(secret, workers) == tried
    # a launch that overruns its width reaches a chunk whose top byte is 0
    assert reference.candidates(b"\x05\x07\x00", 1) == (7 + 256 ** 2) * 256 + 6
