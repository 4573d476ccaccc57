"""The scheduler's row copy: pinned and non-blocking against a blocking copy.

``ops/operands.py`` ``group_operands`` stages a group's slot rows in pinned
host memory and copies them to the card ``non_blocking`` on the
scheduler's stream, so an engine launch waits on the host once, for its
results.  This script measures that against the blocking form (rows copied
from pageable memory with ``Tensor.to``, which waits for the stream after
each copy), both in one process:

* host ms per engine launch: a ``BatchingScheduler`` with 8 difficulty-16
  slots (no hit) of 2^20 candidates runs for ``WINDOW_S`` seconds, and the
  window's wall time is divided by its ``sched.launches``; md5 and
  sha3_256, the two forms alternating (pinned, blocking, blocking,
  pinned);
* which form keeps the one host wait: each serves one request under
  ``torch.cuda.set_sync_debug_mode("error")``, where a synchronizing CUDA
  call raises on the scheduler's loop (an event wait does not count).

Run on a machine with an NVIDIA GPU and nvcc, from the root of a
checkout::

    python3 -m distpow_tpu_torch.tools.row_copy

It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

WINDOW_S = 2.0
MODELS = ("md5", "sha3_256")


def blocking_group_operands(init, base, masks, tb_lo, log_tbc, chunk0, device="cpu"):
    """``group_operands`` with a blocking copy from pageable memory."""
    import torch

    from distpow_tpu_torch.ops.operands import GroupOperands, group_operands

    rows = group_operands(init, base, masks, tb_lo, log_tbc, chunk0, "cpu")
    parts = (rows.init, rows.base, rows.masks, rows.tb_lo, rows.log_tbc, rows.chunk0)
    buf = torch.cat([t.reshape(-1) for t in parts]).to(device)
    split = torch.split(buf, [t.numel() for t in parts])
    return GroupOperands(*(p.view(t.shape) for p, t in zip(split, parts)))


def host_ms(model: str) -> float:
    """Host ms per engine launch of 8 no-hit slots of 2^20 candidates."""
    from distpow_tpu_torch.runtime.metrics import Metrics
    from distpow_tpu_torch.sched import BatchingScheduler

    m = Metrics()
    eng = BatchingScheduler(hash_model=model, batch_size=1 << 20, max_slots=8, start=False,
                            metrics=m)
    slots = [eng.submit(bytes([7, 7, 7, s]), 16, range(256)) for s in range(8)]
    eng.start()
    try:
        time.sleep(0.5)  # past widths 0-2
        l0, t0 = m.get("sched.launches"), time.monotonic()
        time.sleep(WINDOW_S)
        l1, t1 = m.get("sched.launches"), time.monotonic()
        for s in slots:
            s.cancel()
    finally:
        eng.close()
    if l1 <= l0:
        raise RuntimeError(f"{model}: the engine made no launch in the window")
    return (t1 - t0) * 1e3 / (l1 - l0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("row_copy: this needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from distpow_tpu_torch.models.registry import get_hash_model
    from distpow_tpu_torch.ops.hash_cuda import load_kernels
    from distpow_tpu_torch.ops.packing import build_tail_spec
    from distpow_tpu_torch.ops.operands import group_operands
    from distpow_tpu_torch.runtime.metrics import Metrics
    from distpow_tpu_torch.sched import BatchingScheduler
    from distpow_tpu_torch.sched import engine

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for model in MODELS:  # built before any window is timed: 4-byte nonces, widths 0-4
        m = get_hash_model(model)
        load_kernels(m, [(t.tb_loc, t.chunk_locs)
                         for t in (build_tail_spec(bytes(4), w, m) for w in range(5))])
    forms = {"pinned": group_operands, "blocking": blocking_group_operands}
    out = {"host_ms": {name: {m: [] for m in MODELS} for name in forms}, "sync_debug": {}}
    try:
        for model in MODELS:
            for name in ("pinned", "blocking", "blocking", "pinned"):
                engine.group_operands = forms[name]
                out["host_ms"][name][model].append(host_ms(model))
        for name, form in forms.items():
            engine.group_operands = form
            eng = BatchingScheduler(hash_model="md5", batch_size=1 << 20, max_slots=8,
                                    metrics=Metrics())
            torch.cuda.set_sync_debug_mode("error")
            try:
                secret = eng.search(bytes([1, 2, 3, 4]), 5, range(256))
                out["sync_debug"][name] = {"secret": secret.hex() if secret else None}
            except Exception as exc:  # the blocking form's loop dies: reported
                out["sync_debug"][name] = {"error": repr(exc)[:300]}
            finally:
                torch.cuda.set_sync_debug_mode("default")
                eng.close()
    finally:
        engine.group_operands = group_operands
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
