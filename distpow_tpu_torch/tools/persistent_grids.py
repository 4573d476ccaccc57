"""The persistent kernel's tile: a sweep of the candidates a thread tests of
each tile its block claims.

A persistent launch (``ops/hash_cuda.py hash_persistent_search``) runs on
one resident wave of blocks, which claim tiles of ``rounds`` x 256
consecutive flat indices in ascending order from a counter.
``claim_rounds`` gives the most rounds per model, from its cost per hash;
the launcher takes fewer where that would leave a block under 8 tiles of
the launch (``hash_search.cuh launch_rounds``).  Few rounds make many
claims (a same-address atomic and a block barrier each); many rounds make a
launch run on longer past its first hit and leave the blocks' last tiles
uneven.  This script measures that trade, per model, at three launches of
the worker's persistent loop (2^20 candidates a sub-batch, times
``launch_steps_for``'s multiplier under the backend's budget):

* ``main``: the width-4 dispatch (md5 2^30 candidates), where the rounds
  asked for are the rounds run (up to 256), so this is the sweep of
  ``claim_rounds``;
* ``width1`` and ``width2``: the width-1 and width-2 dispatches (2^20 and
  2^24 candidates), where ``launch_rounds`` cuts the rounds: rounds asked
  for at or below ``claim_rounds``.

At each launch, for each rounds asked for:

* ``no_hit``: difficulty 16, so every tile runs, beside the solo kernel's
  launch of the same candidates (the serial kernel on its own grid);
* ``found``: a first hit (difficulty 7 on ``main``, past the launch's first
  third; 5 and 6 on the small ones, past the first quarter on ``width2``;
  at width 1 the chunk byte wraps every 2^16 candidates, so its hit lies in
  the first sixteenth), the first such nonce of ``DEEP_TRIES``, its two
  words checked at every rounds against the solo kernel's index;
* ``solo@persistent_grid`` (``main`` only): the serial kernel without a hit
  on as many blocks as the persistent form's grid at the rule's rounds,
  which tells the grid's cost from the claim loop's.

A reading is the least of two, one taken forward and one backward through
the forms, of ``REPS`` launches (more on the small launches) timed with
CUDA events.  Each model's line gives per launch the ms of each form, each
over the solo kernel's, the hit's fraction of the launch, and per rounds
the claims of a no-hit launch (the counter), the blocks (on ``main``, the
claims past the tiles of the launch: one a block) and one tile's ms (the
launch's ms over the tiles a block takes); and the registers, spill bytes
and stack frame ptxas gave the persistent kernels of the libraries built
here.

Run from the root of a checkout on a machine with a GPU::

    python3 -m distpow_tpu_torch.tools.persistent_grids [model ...]

It prints the card's name and power limit, then one JSON line a model (all
nine by default); it exits non-zero when a check fails, and at once when no
GPU is visible.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

MAIN_BATCH = 1 << 20
NO_HIT_DIFFICULTY, DEEP_TRIES = 16, 256
# launch: (width, its found case's difficulty, the least fraction of the
# launch its hit lies at)
LAUNCHES = {"main": (4, 7, 1 / 3), "width1": (1, 5, 0.0), "width2": (2, 6, 1 / 4)}
ROUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
REPS = 5
# a persistent kernel's line of nvcc's -Xptxas -v
PTXAS_PERSISTENT = (r"Function properties for (\S*persistent_kernel\S*)\n\s*(\d+) bytes stack "
                    r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n[^\n]*Used "
                    r"(\d+) registers")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("persistent_grids: no GPU visible", file=sys.stderr)
        return 2
    from ..backends.cuda_backend import CudaBackend
    from ..models.registry import get_hash_model
    from ..ops import _build
    from ..ops.hash_cuda import (BLOCK_THREADS, KERNELS, claim_rounds, hash_search,
                                 kernel_layout, load_kernels, persistent_cell)
    from ..ops.operands import u32_value
    from ..ops.packing import build_tail_spec
    from ..ops.search_step import SENTINEL, step_operands
    from ..parallel.search import launch_steps_for

    models = argv or list(KERNELS)
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    # every library the runs need, all at once (md5's at the 4-byte nonce's
    # tail layout, which every nonce here shares)
    keys = []
    for name in models:
        model = get_hash_model(name)
        spec = build_tail_spec(bytes(4), 4, model)
        var_word = kernel_layout(spec.tb_loc, spec.chunk_locs, model)[0]
        keys.append(_build.library_key(KERNELS[name], var_word if name == "md5" else None))
    _build.build(keys)
    ptxas = {}
    for key, log in _build.last_build_log.items():
        found = re.findall(PTXAS_PERSISTENT, log)
        if found:
            ptxas[key] = {"registers": sorted({int(r) for *_, r in found}),
                          "spill_bytes": max(int(st) + int(ld) for _, _, st, ld, _ in found),
                          "stack_bytes": max(int(sf) for _, sf, *_ in found)}
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    failed = False
    for name in models:
        model = get_hash_model(name)
        budget = CudaBackend(hash_model=name, device=dev).max_launch
        rule = claim_rounds(model)
        line = {"model": name, "card": card.strip(), "claim_rounds": rule,
                "ptxas_persistent": ptxas.get(keys[models.index(name)])}
        for launch, (width, difficulty, least) in LAUNCHES.items():
            steps = launch_steps_for(width, MAIN_BATCH // 256, 256, budget)
            n, chunk0 = MAIN_BATCH * steps, 256 ** (width - 1)
            reps = max(REPS, (REPS << 26) // n)

            def ms(fn) -> float:
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / reps

            def operands(nonce, d):
                spec = build_tail_spec(nonce, width, model)
                load_kernels(model, [(spec.tb_loc, spec.chunk_locs)])
                return spec, step_operands(spec, d, model, 0, 256, dev)

            def solo(spec, ops, grid=None):
                return hash_search(model, ops, spec.tb_loc, spec.chunk_locs, chunk0,
                                   MAIN_BATCH, steps, device=dev, grid=grid)

            def persistent(spec, ops, rounds):
                return persistent_cell(model, ops, spec.tb_loc, spec.chunk_locs, chunk0,
                                       MAIN_BATCH, steps, zero, rounds=rounds)

            no_hit = operands(bytes([1, 2, 3, 4]), NO_HIT_DIFFICULTY)
            for i in range(DEEP_TRIES):
                nonce = b"par" + bytes([i])
                found = operands(nonce, difficulty)
                f = u32_value(solo(*found))
                if f != SENTINEL and f >= least * n:
                    break
            else:
                line[launch] = {"error": "no deep hit"}
                failed = True
                continue
            asked = sorted({*ROUNDS, rule} if launch == "main" else
                           {r for r in ROUNDS if r <= rule} | {rule})
            forms = {"solo": lambda: solo(*no_hit)}
            words, claims = {}, {}
            for rounds in asked:
                forms[f"no_hit@{rounds}"] = lambda r=rounds: persistent(*no_hit, r)
                forms[f"found@{rounds}"] = lambda r=rounds: persistent(*found, r)
                words[rounds] = [u32_value(v) for v in forms[f"found@{rounds}"]()[:2]]
                claims[rounds] = u32_value(forms[f"no_hit@{rounds}"]()[2])
            bad = {k: w for k, w in words.items() if w != [f, f // MAIN_BATCH + 1]}
            out = {"width": width, "launch_steps": steps, "candidates": n,
                   "deep_nonce": nonce.hex(), "difficulty": difficulty, "hit": f,
                   "fraction_of_launch": f / n, "rounds_asked": asked, "mismatches": bad,
                   "claims_no_hit": claims}
            if launch == "main":
                # the rounds asked for are the rounds run: one claim past the
                # launch's tiles a block
                tiles = {r: -(-n // (r * BLOCK_THREADS)) for r in claims}
                blocks = {r: claims[r] - tiles[r] for r in claims}
                forms["solo@persistent_grid"] = lambda: solo(*no_hit, blocks[rule])
                failed |= any(b <= 0 for b in blocks.values())
            readings = {}
            for key in [*forms, *reversed(forms)]:
                readings.setdefault(key, []).append(ms(forms[key]))
            best = {k: min(v) for k, v in readings.items()}
            out.update({"ms": best, "over_solo": {k: v / best["solo"] for k, v in best.items()
                                                  if k != "solo"}})
            if launch == "main":
                out.update({"blocks": blocks, "tile_ms": {
                    r: best[f"no_hit@{r}"] * blocks[r] / tiles[r] for r in claims}})
            line[launch] = out
            failed |= bool(bad)
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
