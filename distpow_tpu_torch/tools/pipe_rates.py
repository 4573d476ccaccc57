"""Issue rates of the H100's integer pipes, one instruction kind at a time.

``pipe_rates.cu`` (beside this file) holds one probe kernel per kind:
independent chains of LOP3, SHF (funnel shift), IADD3, IMAD, IMAD.HI and
IMAD.WIDE, and the mixes LOP3+IMAD, SHF+IMAD.HI, LOP3+VIADD, SHF+IMAD and
IMAD+VIADD, which issue the two kinds in equal numbers (ptxas folds a
chain of VIADDs alone, so VIADD is measured only in mixes).  This script
builds it with nvcc, reads each probe's loop out of ``cuobjdump -sass`` (so a probe counts what
ptxas issued, and says whether that is the instruction it names), times
each probe on 8 blocks of 256 threads per SM for about 0.3 s a launch, and
prints per probe the thread results per clock per SM, in all and per
opcode, at the SM clock that nvidia-smi read during the timed launches.
The card's name and power limit come first.

Run on a machine with an NVIDIA GPU and nvcc, from the root of a
checkout::

    python3 -m distpow_tpu_torch.tools.pipe_rates

The library lives under ``distpow_tpu_torch/build/pipe_rates/``; the full
output also goes to ``pipe_rates.json`` in ``chip_smoke.py``'s output
directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
SOURCE = os.path.join(PKG, "tools", "pipe_rates.cu")
BUILD = os.path.join(PKG, "build", "pipe_rates")

# pipe_probe's probe index -> name; a name with "+" alternates two kinds
PROBES = ("LOP3", "SHF", "IADD3", "IMAD", "IMAD.HI", "IMAD.WIDE", "LOP3+IMAD", "SHF+IMAD.HI",
          "LOP3+VIADD", "SHF+IMAD", "IMAD+VIADD")
THREADS, BLOCKS_PER_SM = 256, 8
TARGET_MS = 300.0
REPS = 3
K = 0x9E3779B1  # the probes' runtime operand: odd, so multiplies keep their bits moving


def opcode_kind(op: str) -> str:
    """A SASS opcode as the probes name it: the base opcode, and the form of
    an IMAD (``IMAD.HI.U32`` is ``IMAD.HI``, ``IMAD.U32`` is ``IMAD``)."""
    parts = op.split(".")
    if parts[0] == "IMAD" and len(parts) > 1 and parts[1] in ("HI", "SHL", "MOV", "IADD",
                                                               "WIDE", "X"):
        return ".".join(parts[:2])
    return parts[0]


def build() -> str:
    from distpow_tpu_torch.ops import _build

    os.makedirs(BUILD, exist_ok=True)
    lib = os.path.join(BUILD, "libpipe_rates.so")
    subprocess.run([_build.find_cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", lib, SOURCE],
                   check=True, capture_output=True, text=True, timeout=600)
    return lib


def probe_loops(sass: str, sass_loops) -> dict:
    """Probe index -> its loop's opcodes (``opcode_kind``), read from the
    ``cuobjdump -sass`` listing with ``sass_loops`` (chip_smoke's)."""
    kinds = {"0": "LOP3", "1": "SHF", "2": "IADD3", "3": "IMAD", "4": "IMAD.HI", "5": "VIADD",
             "6": "IMAD.WIDE"}
    out = {}
    for name, body in sass_loops(sass).items():
        m = re.search(r"probe_kernelILi(\d)ELi(\d)E", name)
        if not m:
            continue
        even, odd = kinds[m.group(1)], kinds[m.group(2)]
        label = even if even == odd else f"{even}+{odd}"
        ops = {}
        for op, c in body.items():
            ops[opcode_kind(op)] = ops.get(opcode_kind(op), 0) + c
        out[PROBES.index(label)] = ops
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("pipe_rates: no CUDA device", file=sys.stderr)
        return 2
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    from distpow_tpu_torch.ops import _build

    lib_path = build()
    sass = subprocess.run([_build.find_cuda_tool("cuobjdump"), "-sass", lib_path],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    loops = probe_loops(sass, cs.sass_loops)
    lib = ctypes.CDLL(lib_path)
    lib.pipe_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.pipe_probe.restype = ctypes.c_int
    grid = sm_count * BLOCKS_PER_SM
    out = torch.empty(grid * THREADS, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)

    def launch_ms(p: int, iters: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.pipe_probe(p, grid, iters, K, out.data_ptr(), stream.cuda_stream)
        end.record()
        if rc:
            raise RuntimeError(f"probe {PROBES[p]}: CUDA error {rc}")
        end.synchronize()
        return start.elapsed_time(end)

    rows = []
    for p, name in enumerate(PROBES):
        ops = loops[p]
        per_iter = sum(ops.values())
        launch_ms(p, 64)  # warm-up
        iters = max(64, int(64 * TARGET_MS / launch_ms(p, 64)))
        with cs.SmClock() as clock:
            ms = statistics.median(launch_ms(p, iters) for _ in range(REPS))
        mhz = statistics.median(clock.mhz)
        per_clock = grid * THREADS * iters / (ms * 1e-3 * mhz * 1e6 * sm_count)
        rows.append({
            "probe": name, "loop_opcodes": ops,
            "named_share": sum(ops.get(k, 0) for k in name.split("+")) / per_iter,
            "iterations": iters, "ms": ms, "sm_clock_mhz": mhz, "sm_clock_readings": clock.mhz,
            "thread_instructions_per_clock_per_sm": per_clock * per_iter,
            "per_opcode_per_clock_per_sm": {k: per_clock * c for k, c in ops.items()}})
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "pipe_rates.json"), "w") as fh:
        json.dump({"card": card, "sm_count": sm_count, "probes": rows}, fh, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
