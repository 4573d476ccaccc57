"""Issue rates of the H100's integer pipes, one instruction kind at a time.

``pipe_rates.cu`` (beside this file) holds one probe kernel per kind:
independent chains of LOP3, SHF (funnel shift), IADD3, IMAD, IMAD.HI,
IMAD.WIDE and PRMT, and the mixes LOP3+IMAD, SHF+IMAD.HI, LOP3+VIADD,
SHF+IMAD, IMAD+VIADD, PRMT+IMAD and PRMT+LOP3, which issue the two kinds in
equal numbers (ptxas folds a chain of VIADDs alone, so VIADD is measured
only in mixes).  Then chains of 64-bit operations: a sum of two and of
three terms as IADD3 + IADD3.X (``ADD64``, ``ADD3_64``), with the high
limb as IMAD.X (``.CARRY``) or through IMAD.WIDE (``.WIDE``), an XOR and a
rotate by 24 (``XROT64``: LOP3 and SHF; ``.PRMT``: LOP3 and PRMT;
``.HALF`` and ``.FMA``: one or both limbs of the rotate as IMAD and
IMAD.HI), and mixes of four chains of one kind with four of another
(``XROT64x4+...``): the forms that could move a 64-bit hash's work onto
the FMA pipe.  This script
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

# pipe_probe's probe index -> name; a name with "+" alternates two kinds,
# or gives "xN" chains of each 64-bit kind
PROBES = ("LOP3", "SHF", "IADD3", "IMAD", "IMAD.HI", "IMAD.WIDE", "LOP3+IMAD", "SHF+IMAD.HI",
          "LOP3+VIADD", "SHF+IMAD", "IMAD+VIADD", "PRMT", "PRMT+IMAD", "PRMT+LOP3",
          "ADD64", "ADD64.CARRY", "ADD64.WIDE", "ADD3_64", "ADD3_64.CARRY", "ADD3_64.WIDE",
          "XROT64", "XROT64.PRMT", "XROT64x4+ADD64.CARRYx4", "XROT64x4+ADD64.WIDEx4",
          "XROT64x4+ADD3_64.CARRYx4", "XROT64x4+ADD3_64.WIDEx4", "LOP3+IMAD.HI",
          "XROT64.HALF", "XROT64.FMA", "XROT64x4+XROT64.HALFx4", "XROT64.HALFx4+XROT64.FMAx4")
# pipe_rates.cu's Op and Op64 kinds, in enum order
KINDS = ("LOP3", "SHF", "IADD3", "IMAD", "IMAD.HI", "VIADD", "IMAD.WIDE", "PRMT")
KINDS64 = ("ADD64", "ADD64.CARRY", "ADD64.WIDE", "ADD3_64", "ADD3_64.CARRY", "ADD3_64.WIDE",
           "XROT64", "XROT64.PRMT", "XROT64.HALF", "XROT64.FMA")
# the opcodes (chip_smoke's opcode_kind) a 64-bit kind should issue
ISSUES64 = {"ADD64": ("IADD3",), "ADD64.CARRY": ("IADD3", "IMAD.X"),
            "ADD64.WIDE": ("IMAD.WIDE", "IMAD"), "ADD3_64": ("IADD3",),
            "ADD3_64.CARRY": ("IADD3", "IMAD.X"), "ADD3_64.WIDE": ("IMAD.WIDE", "IMAD"),
            "XROT64": ("LOP3", "SHF"), "XROT64.PRMT": ("LOP3", "PRMT"),
            "XROT64.HALF": ("LOP3", "SHF", "IMAD", "IMAD.HI"),
            "XROT64.FMA": ("LOP3", "IMAD", "IMAD.HI")}
CHAINS, STEPS = 8, 8
THREADS, BLOCKS_PER_SM = 256, 8
TARGET_MS = 300.0
REPS = 3
K = 0x9E3779B1  # the probes' runtime operand: odd, so multiplies keep their bits moving


def build() -> str:
    from distpow_tpu_torch.ops import _build

    os.makedirs(BUILD, exist_ok=True)
    lib = os.path.join(BUILD, "libpipe_rates.so")
    subprocess.run([_build.find_cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                    "-o", lib, SOURCE], check=True, capture_output=True, text=True, timeout=600)
    return lib


def probe_label(kernel: str):
    """The PROBES name of a probe kernel's mangled name, or None."""
    m = re.search(r"probe_kernelILi(\d)ELi(\d)E", kernel)
    if m:
        even, odd = KINDS[int(m.group(1))], KINDS[int(m.group(2))]
        return even if even == odd else f"{even}+{odd}"
    m = re.search(r"probe64_kernelILi(\d)ELi(\d)ELi(\d)E", kernel)
    if m:
        op0, n0, op1 = KINDS64[int(m.group(1))], int(m.group(2)), KINDS64[int(m.group(3))]
        return op0 if n0 == CHAINS else f"{op0}x{n0}+{op1}x{CHAINS - n0}"
    return None


def named_kinds(probe: str):
    """(opcode kinds the probe names, named operations per loop iteration
    by kind): a 32-bit probe issues CHAINS * STEPS instructions of the kinds
    it names, a 64-bit one CHAINS * STEPS operations of the ISSUES64 opcodes."""
    parts = [m.groups() if (m := re.fullmatch(r"(.+)x(\d+)", p)) else (p, None)
             for p in probe.split("+")]
    kinds, ops = set(), {}
    for kind, n in parts:
        if kind in ISSUES64:
            kinds.update(ISSUES64[kind])
            ops[kind] = STEPS * (int(n) if n else CHAINS)
        else:
            kinds.add(kind)
            ops[kind] = STEPS * CHAINS // len(parts)
    return kinds, ops


def probe_loops(sass: str, cs) -> dict:
    """Probe index -> its loop's opcodes by kind, read from the ``cuobjdump
    -sass`` listing with the module ``cs`` (chip_smoke): ``sass_loops`` and
    ``opcode_kind``."""
    out = {}
    for name, body in cs.sass_loops(sass).items():
        label = probe_label(name)
        if label is None:
            continue
        ops = {}
        for op, c in body.items():
            ops[cs.opcode_kind(op)] = ops.get(cs.opcode_kind(op), 0) + c
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
    loops = probe_loops(sass, cs)
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
        kinds, named = named_kinds(name)
        rows.append({
            "probe": name, "loop_opcodes": ops,
            "named_share": sum(ops.get(k, 0) for k in kinds) / per_iter,
            "named_per_clock_per_sm": {k: per_clock * n for k, n in named.items()},
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
