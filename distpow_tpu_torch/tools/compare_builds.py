"""This checkout's search kernels against another checkout's, on one card.

Builds both checkouts' kernels (each with its own sources and build code,
in its own process, the two at once), then prints per model: whether
ptxas gave every specialization the same registers, whether every
specialization's SASS loop has the same length, the same two for the
group kernel (the scheduler's search of a group of slots), every solo,
group and mesh specialization that spills on either side (``spills``,
bytes of spill stores and loads), the number of
specializations on each side, the timed specialization's (mask words 2,
one tail block, power-of-two run, and for md5's kernels, built per tail
layout, the main path's var_word) registers, spills and loop
instructions by pipe on each side, and the main-path launch time
(difficulty 16, as ``operand_placement`` times it) in ``PAIRS`` pairs of
turns, each turn in its own process, the pairs in alternating order (other
then this, this then other, ...).  Both sides must agree on each launch's
result and on a difficulty-6 first hit.  The card's name and power limit
come first.  "loop" is the loop body's length, "issued" and the pipe
split what one candidate issues (a ``switch`` counts one case).

Each pair gives a ratio this / other; a model's ``this_over_other`` is the
median of its pairs.  The models whose registers and loop lengths are the
same on both sides are the controls: their pair ratios are the spread of
code that did not change.  A changed model is "faster" if its median lies
below every control pair, "slower" if above every one, else "unresolved".

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc,
with the other checkout unpacked in a directory, for example the parent
commit (``git archive HEAD~1 | tar -x -C archive_tree/parent``)::

    python3 -m distpow_tpu_torch.tools.compare_builds archive_tree/parent [model ...]

No model named: all nine.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

from distpow_tpu_torch.tools.operand_placement import REPO, child, finish

PAIRS = 6


def build_side(proc, what: str, cs) -> dict:
    """Per kernel: ptxas per specialization and the SASS loop per
    specialization, from one side's build child (the libraries of a kernel
    built per tail layout, ``md5_search.vw<w>``, merged into its own)."""
    from distpow_tpu_torch.ops import _build

    out = finish(proc, f"build ({what})")
    kernels = {}
    for library, path in out["paths"].items():
        sass = subprocess.run([_build.find_cuda_tool("cuobjdump"), "-sass", path],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        log = out["log"].get(library, "")
        kernel = kernels.setdefault(library.partition(".vw")[0], {
            "ptxas": {}, "loops": {}, "issued": {}, "group_ptxas": {}, "group_loops": {},
            "mesh_ptxas": {}})
        kernel["ptxas"].update(cs.parse_ptxas(log))
        kernel["mesh_ptxas"].update(cs.parse_ptxas(log, cs.MESH_KEY))
        kernel["loops"].update(cs.spec_sass_loops(sass))
        kernel["issued"].update(cs.spec_sass_loops(sass, path=True))
        kernel["group_ptxas"].update(cs.parse_group_ptxas(log))
        kernel["group_loops"].update(cs.group_sass_loops(sass))
    return kernels


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distpow_tpu_torch.ops.hash_cuda import KERNELS

    other = os.path.abspath(argv[0])
    models = list(argv[1:]) or list(cs.MODELS)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    roots = {"other": other, "this": REPO}
    procs = {side: child(root, "build") for side, root in roots.items()}
    built = {side: build_side(proc, side, cs) for side, proc in procs.items()}
    runs = {"other": [], "this": []}
    for i in range(PAIRS):
        for side in (("other", "this") if i % 2 == 0 else ("this", "other")):
            runs[side].append(finish(child(roots[side], "time", models), f"timing ({side})"))
    agree = True
    rows = {}
    for m in models:
        k = KERNELS[m]
        a, b = built["other"][k], built["this"][k]
        same = all(r[m]["result"] == runs["other"][0][m]["result"]
                   and r[m]["first_hit_d6"] == runs["other"][0][m]["first_hit_d6"]
                   for side in runs for r in runs[side])
        agree &= same
        ms = {side: [r[m]["ms"] for r in runs[side]] for side in runs}
        ratios = [t / o for t, o in zip(ms["this"], ms["other"])]
        rows[m] = {
            "model": m, "ms": ms, "pair_ratios": ratios,
            "this_over_other": statistics.median(ratios),
            "same_registers": {s: v["registers"] for s, v in a["ptxas"].items()} ==
                              {s: v["registers"] for s, v in b["ptxas"].items()},
            "same_loop_lengths": {s: sum(v.values()) for s, v in a["loops"].items()} ==
                                 {s: sum(v.values()) for s, v in b["loops"].items()},
            "same_group_registers": {s: v["registers"] for s, v in a["group_ptxas"].items()} ==
                                    {s: v["registers"] for s, v in b["group_ptxas"].items()},
            "same_group_loop_lengths":
                {s: sum(v.values()) for s, v in a["group_loops"].items()} ==
                {s: sum(v.values()) for s, v in b["group_loops"].items()},
            "specializations": {side: len(built[side][k]["loops"]) for side in built},
            "group_specializations": {side: len(built[side][k]["group_loops"])
                                      for side in built},
            "timed": {side: timed_row(built[side][k], cs) for side in built},
            "spills": {side: spills(built[side][k], cs) for side in built},
            "results_agree": same}
    print(json.dumps({"verdicts": verdicts(rows.values())}), flush=True)
    for row in rows.values():
        print(json.dumps(row), flush=True)
    print(json.dumps({"results_agree": agree}), flush=True)
    return 0 if agree else 1


def timed_row(kernel: dict, cs) -> dict:
    """One side's timed specialization (mask words 2, one tail block, a
    power-of-two run; for a kernel built per tail layout, the main path's
    var_word): ptxas, loop length, what one candidate issues, by pipe.  So
    a model whose set of specializations changed (md5, keyed by var_word
    since) is still compared at the launch both sides time."""
    key = (2, 1, True)
    if key not in kernel["loops"]:
        key += (cs.MAIN_VAR_WORD,)
    return {"key": cs.spec_label(key), **kernel["ptxas"].get(key, {}),
            "loop": sum(kernel["loops"][key].values()),
            "issued": sum(kernel["issued"][key].values()), **cs.pipe_split(kernel["issued"][key])}


def spills(kernel: dict, cs) -> dict:
    """One side's specializations that spill: ``form:label`` -> spill bytes,
    over the solo, group and mesh kernels."""
    out = {}
    for form, key in (("solo", "ptxas"), ("group", "group_ptxas"), ("mesh", "mesh_ptxas")):
        for spec, v in kernel[key].items():
            if v["spill_bytes"]:
                if form != "group":
                    label = cs.spec_label(spec)
                else:  # n_blocks, or (n_blocks, var_word)
                    nb, *vw = spec if isinstance(spec, tuple) else (spec,)
                    label = f"nb{nb}" + "".join(f"_vw{w}" for w in vw)
                out[f"{form}:{label}"] = v["spill_bytes"]
    return out


def verdicts(rows) -> dict:
    """The controls' pair-ratio spread and, per changed model, its median
    ratio against it."""
    rows = list(rows)
    control = [r for row in rows if row["same_registers"] and row["same_loop_lengths"]
               for r in row["pair_ratios"]]
    out = {"controls": sorted(row["model"] for row in rows
                              if row["same_registers"] and row["same_loop_lengths"]),
           "control_spread": [min(control), max(control)] if control else None, "changed": {}}
    for row in rows:
        if row["same_registers"] and row["same_loop_lengths"]:
            continue
        med = row["this_over_other"]
        verdict = ("unresolved" if not control else "faster" if med < min(control)
                   else "slower" if med > max(control) else "unresolved")
        out["changed"][row["model"]] = {"this_over_other": med, "verdict": verdict}
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
