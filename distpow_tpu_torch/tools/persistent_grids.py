"""The persistent kernel's grid: one resident wave against several.

A persistent launch (``ops/hash_cuda.py hash_persistent_search``) runs on
one resident wave of blocks where it is expected to hold a hit
(``one_wave_for``), so that its threads reach the first hit in index order
and the launch ends near it, and on the serial kernel's grid
(``default_grid``: 16 blocks of 256 threads a SM, several waves) otherwise.
This script measures what that rule trades, per model, at the worker's
main-path launch (2^20 candidates a sub-batch, ``launch_steps_for``'s
multiplier under the backend's budget):

* ``no_hit``: difficulty 16, so every segment runs: the serial kernel and
  the persistent form on each grid;
* ``found``: the persistent form at a difficulty-7 first hit past the
  launch's first third (the first such nonce of ``DEEP_TRIES``), its two
  words checked on every grid against the solo kernel's index.

The grids: one resident wave (``one_wave``, the launcher's count) and 1, 2,
3, 4, 6, 8, 12 and 16 blocks a SM.  A reading is the least of two, one
taken forward and one backward through the forms, of ``REPS`` launches
timed with CUDA events.

Run from the root of a checkout on a machine with a GPU::

    python3 -m distpow_tpu_torch.tools.persistent_grids [model ...]

It prints the card's name and power limit, then one JSON line a model (all
nine by default); it exits non-zero when a check fails, and at once when no
GPU is visible.
"""

from __future__ import annotations

import json
import subprocess
import sys

MAIN_BATCH, MAIN_CHUNK0 = 1 << 20, 1 << 24
NO_HIT_DIFFICULTY, DEEP_DIFFICULTY, DEEP_TRIES = 16, 7, 256
BLOCKS_PER_SM = (1, 2, 3, 4, 6, 8, 12, 16)
REPS = 5


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("persistent_grids: no GPU visible", file=sys.stderr)
        return 2
    from ..backends.cuda_backend import CudaBackend
    from ..models.registry import get_hash_model
    from ..ops import _build
    from ..ops.hash_cuda import (KERNELS, hash_persistent_search, hash_search, kernel_layout,
                                 load_kernels)
    from ..ops.operands import u32_value
    from ..ops.packing import build_tail_spec
    from ..ops.search_step import SENTINEL, step_operands
    from ..parallel.search import launch_steps_for

    models = argv or list(KERNELS)
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def ms(fn) -> float:
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    failed = False
    for name in models:
        model = get_hash_model(name)
        budget = CudaBackend(hash_model=name, device=dev).max_launch
        steps = launch_steps_for(4, MAIN_BATCH // 256, 256, budget)
        n = MAIN_BATCH * steps

        def operands(nonce, d):
            spec = build_tail_spec(nonce, 4, model)
            load_kernels(model, [(spec.tb_loc, spec.chunk_locs)])
            return spec, step_operands(spec, d, model, 0, 256, dev)

        def solo(spec, ops, grid=None):
            return hash_search(model, ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0,
                               MAIN_BATCH, steps, device=dev, grid=grid)

        def persistent(spec, ops, grid, one_wave=False):
            return hash_persistent_search(model, ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0,
                                          MAIN_BATCH, steps, zero, device=dev, grid=grid,
                                          one_wave=one_wave)

        no_hit = operands(bytes([1, 2, 3, 4]), NO_HIT_DIFFICULTY)
        for i in range(DEEP_TRIES):
            nonce = b"par" + bytes([i])
            found = operands(nonce, DEEP_DIFFICULTY)
            f = u32_value(solo(*found))
            if f != SENTINEL and f >= n // 3:
                break
        else:
            print(json.dumps({"model": name, "error": "no deep hit"}), flush=True)
            failed = True
            continue
        grids = {"one_wave": None, **{f"{b}_per_sm": sms * b for b in BLOCKS_PER_SM}}
        forms = {}
        words = {}
        for label, grid in grids.items():
            one_wave = grid is None
            if not one_wave:  # (the serial kernel's own grid is 16_per_sm)
                forms[f"serial@{label}"] = lambda g=grid: solo(*no_hit, g)
            forms[f"no_hit@{label}"] = lambda g=grid, w=one_wave: persistent(*no_hit, g, w)
            forms[f"found@{label}"] = lambda g=grid, w=one_wave: persistent(*found, g, w)
            words[label] = [u32_value(v) for v in forms[f"found@{label}"]().reshape(-1)]
        bad = {k: w for k, w in words.items() if w != [f, f // MAIN_BATCH + 1]}
        readings = {}
        for key in [*forms, *reversed(forms)]:
            readings.setdefault(key, []).append(ms(forms[key]))
        print(json.dumps({"model": name, "launch_steps": steps, "candidates": n,
                          "deep_nonce": nonce.hex(), "hit": f, "hit_fraction": f / n,
                          "sm_count": sms, "mismatches": bad,
                          "ms": {k: min(v) for k, v in readings.items()}}), flush=True)
        failed |= bool(bad)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
