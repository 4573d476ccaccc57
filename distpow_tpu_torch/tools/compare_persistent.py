"""md5's persistent loop in this checkout against another checkout's, on one
card.

Runs four turns, other, this, this, other, each checkout in a process of
its own from its own sources and build, and in each:

* ``launches``: md5's persistent dispatches of widths 1, 2 and 4 (2^20,
  2^24 and 2^30 candidates of a 4-byte nonce, as ``launch_steps_for``
  sizes them), the solo kernel beside the persistent form, without a hit
  (difficulty 16) and at a hit (``HITS``: difficulties 5, 6 and 7, the
  first nonce of 256 whose hit lies past 0, 1/4 and 1/3 of the launch; at
  width 1 the chunk byte wraps every 2^16 candidates, so its hit lies in
  the first sixteenth): ms a launch, the least of two readings of
  ``REPS`` launches (5 at width 4), timed with CUDA events, and the
  persistent words;
* ``serial``: the solo kernel's ms per main-path launch (difficulty 16) of
  each model named (``sha256d`` and ``md5`` by default);
* ``loops``: md5's searches through ``get_backend("auto")`` under both
  loops, at difficulty 5 (four nonces) and 8 (two), three times over, a
  CUDA event pair around each launch: per search its wall ms and the
  launches' device ms, per launch size their count and device ms (a pair
  also counts the host's time to enqueue when the card is idle);
* ``worker``: the checkout's own ``chip_smoke.py`` with its ``device`` and
  ``worker_mine`` phases only (the demo's Mines through a worker).

A checkout whose persistent wrapper takes ``one_wave`` (before the claim
loop) gets it as its backend gave it (``one_wave_for``).

Run from the root of a checkout on a machine with a GPU, the other
checkout unpacked in a directory (for example the parent commit,
``git archive HEAD~1 | tar -x -C archive_tree/parent``)::

    python3 -m distpow_tpu_torch.tools.compare_persistent archive_tree/parent [model ...]

It prints the card's name and power limit, then one JSON line a turn;
exits 1 when the two checkouts' words or secrets differ, and 2 at once
when no GPU is visible.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# (width, difficulty of the hit, least fraction of the launch it lies at)
HITS = ((1, 5, 0.0), (2, 6, 0.25), (4, 7, 1 / 3))
REPS = 50
# loops: the nonces searched at each difficulty, and the times over
LOOP_NONCES = {5: ("05060708", "02020202", "07070103", "03010401"),
               8: ("09080706", "01020304")}
LOOP_TIMES = 3
TURN_TIMEOUT_S = 900

# Run in a child process with the checkout's root first on sys.path.
CHILD = r"""
import collections, inspect, json, sys, time
root, what = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
import torch
from distpow_tpu_torch.backends import cuda_backend, get_backend
from distpow_tpu_torch.backends.cuda_backend import CudaBackend
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops import hash_cuda
from distpow_tpu_torch.ops.operands import u32_value
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.ops.search_step import SENTINEL, step_operands
from distpow_tpu_torch.parallel.partition import thread_bytes, worker_bits
from distpow_tpu_torch.parallel.search import launch_steps_for

dev = torch.device("cuda", 0)
e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
out = {}


def ms(fn, reps):
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


md5 = get_hash_model("md5")
zero = torch.zeros(1, dtype=torch.int32, device=dev)
budget = CudaBackend(hash_model="md5", device=dev).max_launch
takes_wave = "one_wave" in inspect.signature(hash_cuda.hash_persistent_search).parameters
launches = {}
for width, difficulty, least in what["hits"]:
    steps = launch_steps_for(width, (1 << 20) // 256, 256, budget)
    n, chunk0 = (1 << 20) * steps, 256 ** (width - 1)

    def forms(nonce, d):
        spec = build_tail_spec(nonce, width, md5)
        hash_cuda.load_kernels(md5, [(spec.tb_loc, spec.chunk_locs)])
        ops = step_operands(spec, d, md5, 0, 256, dev)
        args = (md5, ops, spec.tb_loc, spec.chunk_locs, chunk0, 1 << 20, steps)
        kw = {"one_wave": hash_cuda.one_wave_for(n, d)} if takes_wave else {}
        return {"solo": lambda: hash_cuda.hash_search(*args, device=dev),
                "persistent": lambda: hash_cuda.hash_persistent_search(*args, zero, device=dev,
                                                                      **kw)}

    for i in range(256):
        nonce = b"wl" + bytes([width, i])
        found = forms(nonce, difficulty)
        f = u32_value(found["solo"]())
        if f != SENTINEL and f >= least * n:
            break
    row = {"candidates": n, "nonce": nonce.hex(), "fraction_of_launch": f / n}
    reps = what["reps"] if width < 4 else 5
    for case, fns in (("no_hit", forms(bytes([1, 2, 3, 4]), 16)), ("found", found)):
        words = [u32_value(v) for v in fns["persistent"]()]
        runs = {"solo": [], "persistent": []}
        for form in ("solo", "persistent", "persistent", "solo"):
            runs[form].append(ms(fns[form], reps))
        row[case] = {"words": words, "ms": {k: min(v) for k, v in runs.items()},
                     "over_solo": min(runs["persistent"]) / min(runs["solo"])}
    launches[f"width{width}"] = row
out["launches"] = launches

serial = {}
for name in what["models"]:
    model = get_hash_model(name)
    spec = build_tail_spec(bytes([1, 2, 3, 4]), 4, model)
    hash_cuda.load_kernels(model, [(spec.tb_loc, spec.chunk_locs)])
    ops = step_operands(spec, 16, model, 0, 256, dev)
    steps = launch_steps_for(4, (1 << 20) // 256, 256,
                             CudaBackend(hash_model=name, device=dev).max_launch)
    fn = lambda: hash_cuda.hash_search(model, ops, spec.tb_loc, spec.chunk_locs, 1 << 24,
                                       1 << 20, steps, device=dev)
    fn()
    runs = [ms(fn, 10) for _ in range(4)]
    serial[name] = {"ms": min(runs), "runs": runs}
out["serial"] = serial

full = thread_bytes(0, worker_bits(1))
orig = {n: getattr(cuda_backend, n) for n in ("hash_search", "hash_persistent_search")}
pairs = []


def timed(name, fn):
    def launch(model, ops, tb_loc, chunk_locs, chunk0, batch, steps, *args, **kwargs):
        stream = torch.cuda.current_stream(ops.device)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(stream)
        res = fn(model, ops, tb_loc, chunk_locs, chunk0, batch, steps, *args, **kwargs)
        b.record(stream)
        pairs.append((a, b, f"{name}@{batch * steps}"))
        return res
    return launch


backends = {loop: get_backend("auto", hash_model="md5", loop=loop)
            for loop in ("persistent", "serial")}
secrets = {}
for loop, be in backends.items():
    for d, nonces in what["loop_nonces"].items():
        for nonce in nonces:
            secrets[(loop, d, nonce)] = be.search(bytes.fromhex(nonce), int(d), full)
torch.cuda.synchronize()
rows = []
for t in range(what["loop_times"]):
    for loop in (("persistent", "serial") if t % 2 == 0 else ("serial", "persistent")):
        for d, nonces in what["loop_nonces"].items():
            for nonce in nonces:
                pairs.clear()
                for n, fn in orig.items():
                    setattr(cuda_backend, n, timed(n, fn))
                try:
                    t0 = time.monotonic()
                    secret = backends[loop].search(bytes.fromhex(nonce), int(d), full)
                    wall = (time.monotonic() - t0) * 1e3
                finally:
                    for n, fn in orig.items():
                        setattr(cuda_backend, n, fn)
                torch.cuda.synchronize()
                by = collections.defaultdict(lambda: [0, 0.0])
                for a, b, key in pairs:
                    by[key][0] += 1
                    by[key][1] += a.elapsed_time(b)
                rows.append({"loop": loop, "difficulty": int(d), "nonce": nonce,
                             "secret": secret.hex() if secret is not None else None,
                             "secret_stable": secret == secrets[(loop, d, nonce)],
                             "wall_ms": wall, "device_ms": sum(v[1] for v in by.values()),
                             "by_launch": dict(by)})
means = collections.defaultdict(list)
for r in rows:
    means[f"{r['loop']}@{r['difficulty']}"].append((r["wall_ms"], r["device_ms"]))
out["loops"] = {"rows": rows, "mean": {k: {"wall_ms": sum(a for a, _ in v) / len(v),
                                           "device_ms": sum(b for _, b in v) / len(v)}
                                       for k, v in means.items()}}

import chip_smoke
kept = {}
run_phase = chip_smoke.Smoke.phase


def phase(self, name, fn, needs=()):
    if name in ("device", "worker_mine"):
        run_phase(self, name, fn, ())
        kept[name] = self.info.get(name)


chip_smoke.Smoke.phase = phase
chip_smoke.main()
out["worker"] = kept.get("worker_mine")
print(json.dumps(out))
"""


def turn(root: str, what: dict) -> dict:
    """One checkout's turn, in a process of its own."""
    proc = subprocess.run([sys.executable, "-c", CHILD, root, json.dumps(what)],
                          capture_output=True, text=True, timeout=TURN_TIMEOUT_S, cwd=root)
    if proc.returncode:
        raise RuntimeError(f"the turn in {root} failed ({proc.returncode}): "
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def agree(turns) -> bool:
    """The persistent words of every launch, and every search's secret, the
    same in every turn."""
    def keyed(t):
        return ({w: (r["no_hit"]["words"], r["found"]["words"]) for w, r in
                 t["launches"].items()},
                sorted((r["loop"], r["difficulty"], r["nonce"], r["secret"])
                       for r in t["loops"]["rows"]))
    first = keyed(turns[0])
    return all(keyed(t) == first and all(r["secret_stable"] for r in t["loops"]["rows"])
               for t in turns)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_persistent: no GPU visible", file=sys.stderr)
        return 2
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    what = {"hits": HITS, "reps": REPS, "models": list(argv[1:]) or ["sha256d", "md5"],
            "loop_nonces": LOOP_NONCES, "loop_times": LOOP_TIMES}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    turns = []
    for side, root in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        result = turn(root, what)
        turns.append(result)
        print(json.dumps({"side": side, "root": root, **result}), flush=True)
    same = agree(turns)
    print(json.dumps({"agree": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
