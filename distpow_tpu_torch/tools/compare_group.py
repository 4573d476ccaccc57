"""The group kernels (the scheduler's search of a group of slots in one
launch) of this checkout against another checkout's, on one card.

Builds both checkouts' libraries of the layouts it times (each in a
process of its own, from its own sources and build code, the two at
once) and compares them: every kernel's registers and SASS loop length by
its mangled name, the group kernels' apart (registers, spills, the loop,
and the candidate loop, the widest loop that holds no barrier).  Then it
runs four turns, other, this, this, other, each checkout in a process of
its own, and in each:

* ``rate``: for every model, one engine launch of 8 slots x 2^20 at
  difficulty 16 (no hit), the slots ``chip_smoke.py``'s ``rate_group``
  makes: ``device_ms``, the wrapper's launches enqueued behind a
  ``torch.cuda._sleep`` spin, so that the host runs ahead of the card, with
  CUDA events around ``REPS`` of them; ``host_us_per_call``, the
  wrapper's time a call over those calls; ``back_to_back_ms``, ``REPS``
  launches back to back with nothing ahead of them (the host's pace where
  it is the slower); and the words;
* ``serve``: md5 at a serving difficulty, 8 slots x 2^20 at difficulty 5
  with distinct nonces, about 63 % of which hit: ``device_ms`` as above,
  the words, and the plain group step's words on the same operands.

Run from the root of a checkout on a machine with a GPU, the other
checkout unpacked in a directory (for example the parent commit, ``git
archive HEAD~1 | tar -x -C archive_tree/parent``)::

    python3 -m distpow_tpu_torch.tools.compare_group archive_tree/parent

Libraries already built in a checkout's build directory give no ptxas
lines: give a fresh ``DISTPOW_TORCH_BUILD_DIR`` after other runs in the
same call.  It prints the card's name and power limit, the ``sass`` line,
then one JSON line a turn and an ``agree`` line; exits 1 when the turns'
words differ or md5's serving words differ from the plain group step's,
and 2 at once when no GPU is visible.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODELS = ("md5", "sha256", "sha256d", "sha1", "ripemd160", "sha512", "sha384", "sha3_256",
          "blake2b_256")
# the libraries of the timed layouts: a 4-byte nonce at width 4 puts md5's
# run at message word 1
LIBRARIES = ("md5_search.vw1", "sha256_search", "sha256d_search", "sha1_search",
             "ripemd160_search", "sha512_search", "sha384_search", "sha3_256_search",
             "blake2b_256_search")
SLOTS, BATCH, REPS = 8, 1 << 20, 20
RATE_DIFFICULTY, SERVE_DIFFICULTY = 16, 5
TURN_TIMEOUT_S = 900

BUILD_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from distpow_tpu_torch.ops import _build
paths = _build.build(json.loads(sys.argv[2]))
print(json.dumps({"paths": paths, "log": _build.last_build_log}))
"""

# Run in a child process with the checkout's root first on sys.path; the
# timing helpers are this checkout's chip_smoke.py's in every turn.
CHILD = r"""
import importlib.util, json, sys
root, what = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("timing", what["chip_smoke"])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops import hash_cuda
from distpow_tpu_torch.ops.difficulty import nibble_masks
from distpow_tpu_torch.ops.operands import group_operands
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.ops.search_step import plain_group_search

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
slots, batch, reps = what["slots"], what["batch"], what["reps"]


def words(t):
    return [v & 0xFFFFFFFF for v in t.tolist()]


def group(model, nonces, d, chunk0):
    specs = [build_tail_spec(n, 4, model) for n in nonces]
    sp = specs[0]
    hash_cuda.load_kernels(model, [(sp.tb_loc, sp.chunk_locs)])
    ops = group_operands([s.init_state for s in specs], [s.base_words for s in specs],
                         [nibble_masks(d, model)] * len(nonces), [0] * len(nonces),
                         [8] * len(nonces), chunk0, dev)
    return lambda: hash_cuda.hash_group_search(model, ops, sp.tb_loc, sp.chunk_locs, batch,
                                               device=dev), (ops, sp)


def back_to_back(launch):
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


out = {"rate": {}}
for name in what["models"]:
    model = get_hash_model(name)
    launch, _ = group(model, [bytes([1, 2, 3, 4 + s]) for s in range(slots)],
                      what["rate_difficulty"], [(1 << 24) + (batch >> 8) * s for s in range(slots)])
    first = words(launch())
    device_ms, host_us = cs.device_and_host(launch, reps)
    out["rate"][name] = {"words": first, "device_ms": device_ms, "host_us_per_call": host_us,
                         "back_to_back_ms": back_to_back(launch)}
md5 = get_hash_model("md5")
launch, (ops, sp) = group(md5, [bytes([5, 6, 7, 8 + s]) for s in range(slots)],
                          what["serve_difficulty"], [1 << 24] * slots)
found = words(launch())
device_ms, host_us = cs.device_and_host(launch, reps)
out["serve"] = {"words": found, "device_ms": device_ms, "host_us_per_call": host_us,
                "plain": plain_group_search(md5, ops, sp.tb_loc, sp.chunk_locs, batch).tolist()}
print(json.dumps(out))
"""


def run_child(code: str, root: str, arg) -> dict:
    proc = subprocess.run([sys.executable, "-c", code, root, json.dumps(arg)],
                          capture_output=True, text=True, timeout=TURN_TIMEOUT_S, cwd=root)
    if proc.returncode:
        raise RuntimeError(f"the child in {root} failed ({proc.returncode}): "
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def listing(cs, path: str):
    """Per function of a library: its widest loop's length and its widest
    barrier-free loop's (``chip_smoke.sass_loops``)."""
    from distpow_tpu_torch.ops import _build

    sass = subprocess.run([_build.find_cuda_tool("cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    whole, candidate = cs.sass_loops(sass), cs.sass_loops(sass, candidate=True)
    return {name: (sum(whole[name].values()), sum(candidate.get(name, {}).values()))
            for name in whole}


def side(cs, built: dict) -> dict:
    """One checkout's build: per function, (registers, spill bytes) from
    ptxas where it ran, the two loop lengths, and its library."""
    ptxas, loops, library = {}, {}, {}
    for lib, path in built["paths"].items():
        for name, _, st, ld, regs in re.findall(cs.PTXAS_FUNCTION, built["log"].get(lib, "")):
            ptxas[name] = (int(regs), int(st) + int(ld))
        found = listing(cs, path)
        loops.update(found)
        library.update(dict.fromkeys(found, lib))
    return {"ptxas": ptxas, "loops": loops, "library": library}


def compare_builds(cs, sides: dict) -> dict:
    """Every kernel but the group ones, matched by mangled name: how many
    keep their loop length and registers, and those that do not; the group
    kernels by key, each side's registers, spills and loop lengths."""
    a, b = sides["other"], sides["this"]
    names = [n for n in a["loops"] if n in b["loops"] and cs.name_key(n, cs.GROUP_KEY) is None]
    loops_differ = [n for n in names if a["loops"][n][0] != b["loops"][n][0]]
    regs_differ = [n for n in names if n in a["ptxas"] and n in b["ptxas"]
                   and a["ptxas"][n][0] != b["ptxas"][n][0]]

    def groups(s):
        out = {}
        for name, (loop, cand) in s["loops"].items():
            key = cs.name_key(name, cs.GROUP_KEY)
            if key is not None:
                regs, spill = s["ptxas"].get(name, (None, None))
                out[f"{s['library'][name]} nb{key[0]}"] = {
                    "registers": regs, "spill_bytes": spill,
                    "blocks_per_sm": cs.blocks_per_sm(regs) if regs else None, "loop": loop,
                    "candidate_loop": cand}
        return out

    return {"matched": len(names), "loops_differ": loops_differ, "registers_differ": regs_differ,
            "registers_compared": sum(n in a["ptxas"] and n in b["ptxas"] for n in names),
            "group": {s: groups(v) for s, v in sides.items()}}


def agree(turns) -> bool:
    """Every launch's words the same in every turn, and md5's serving words
    the plain group step's in each."""
    def keyed(t):
        return {m: r["words"] for m, r in t["rate"].items()}, t["serve"]["words"]
    first = keyed(turns[0])
    return all(keyed(t) == first and t["serve"]["words"] == t["serve"]["plain"] for t in turns)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_group: no GPU visible", file=sys.stderr)
        return 2
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    other = os.path.abspath(argv[0])
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    # one build where both sides are this checkout
    roots = {"other": other, "this": REPO}
    builds = {root: subprocess.Popen([sys.executable, "-c", BUILD_CHILD, root,
                                      json.dumps(list(LIBRARIES))],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                     cwd=root) for root in set(roots.values())}
    built = {}
    for root, proc in builds.items():
        out, err = proc.communicate(timeout=TURN_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"the build in {root} failed ({proc.returncode}): {err[-3000:]}")
        built[root] = side(cs, json.loads(out.strip().splitlines()[-1]))
    print(json.dumps({"sass": compare_builds(cs, {s: built[r] for s, r in roots.items()})}),
          flush=True)
    what = {"models": list(MODELS), "slots": SLOTS, "batch": BATCH, "reps": REPS,
            "rate_difficulty": RATE_DIFFICULTY, "serve_difficulty": SERVE_DIFFICULTY,
            "chip_smoke": os.path.join(REPO, "chip_smoke.py")}
    turns = []
    for s, root in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        result = run_child(CHILD, root, what)
        turns.append(result)
        print(json.dumps({"side": s, "root": root, **result}), flush=True)
    same = agree(turns)
    print(json.dumps({"agree": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
