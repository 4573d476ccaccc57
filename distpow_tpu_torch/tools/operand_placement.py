"""Where the scaffold kernels keep the launch's operands: shared memory
(the kernels as built) against registers.

``hash_search.cuh`` loads the prefix state and the tail's rows into shared
memory once per block.  This script builds a copy of the package whose
kernel copies them into registers instead, then prints, for the eight
kernels over the scaffold: ptxas's registers and spill bytes per
specialization in both builds, and the time of each model's main-path
launch (difficulty 16, nonce ``01020304``, width 4, batch 2^20 times the
model's cost-scaled sub-batches), in the order shared, registers,
registers, shared, each in its own process.  Both builds must agree on
each launch's result and on the first hit of a difficulty-6 launch.

Run on a machine with an NVIDIA GPU and nvcc, from the root of a
checkout::

    python3 -m distpow_tpu_torch.tools.operand_placement

The copy and its libraries live under ``distpow_tpu_torch/build/``; the
full ptxas numbers go to ``chiprun_out/operand_placement.json``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
VARIANT_ROOT = os.path.join(PKG, "build", "operand_placement")
MODELS = ("sha256", "sha256d", "sha1", "ripemd160", "sha512", "sha384", "sha3_256",
          "blake2b_256")

SHARED = """\
  __shared__ uint32_t init[H::STATE_WORDS], base[BASE_WORDS];
  for (int i = threadIdx.x; i < H::STATE_WORDS; i += blockDim.x) init[i] = init_g[i];
  for (int i = threadIdx.x; i < BASE_WORDS; i += blockDim.x) base[i] = base_g[i];
  __syncthreads();
"""
REGISTERS = """\
  uint32_t init[H::STATE_WORDS], base[BASE_WORDS];
#pragma unroll
  for (int i = 0; i < H::STATE_WORDS; ++i) init[i] = __ldg(init_g + i);
#pragma unroll
  for (int i = 0; i < BASE_WORDS; ++i) base[i] = __ldg(base_g + i);
"""

# Run in a child process with the build's root first on sys.path:
# "build" compiles it (nvcc's log and the libraries' paths), "time" times
# each model's main-path launch.
CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
from distpow_tpu_torch.ops import _build
if sys.argv[3] == "build":
    paths = _build.build()
    print(json.dumps({"log": _build.last_build_log, "paths": paths}))
    sys.exit(0)
import torch
import chip_smoke as cs
from distpow_tpu_torch.backends.cuda_backend import CudaBackend
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops.hash_cuda import hash_search
from distpow_tpu_torch.ops.operands import u32_value
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.ops.search_step import step_operands
from distpow_tpu_torch.parallel.search import launch_steps_for
dev = torch.device("cuda", 0)
out = {}
for name in json.loads(sys.argv[4]):
    model = get_hash_model(name)
    spec = build_tail_spec(bytes([1, 2, 3, 4]), 4, model)
    steps = launch_steps_for(4, cs.MAIN_BATCH // 256, 256,
                             CudaBackend(hash_model=name, device=dev).max_launch)

    def launch(d):
        ops = step_operands(spec, d, model, 0, 256, dev)
        return hash_search(model, ops, spec.tb_loc, spec.chunk_locs, cs.MAIN_CHUNK0,
                           cs.MAIN_BATCH, steps, device=dev)

    result = launch(16)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(cs.RATE_LAUNCHES):
        launch(16)
    end.record()
    end.synchronize()
    out[name] = {"ms": start.elapsed_time(end) / cs.RATE_LAUNCHES, "result": u32_value(result),
                 "first_hit_d6": u32_value(launch(6))}
print(json.dumps(out))
"""


def make_register_copy() -> str:
    """A copy of the package whose scaffold kernel keeps the operands in registers."""
    root = os.path.join(VARIANT_ROOT, "registers")
    dst = os.path.join(root, "distpow_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(dst, "csrc", "hash_search.cuh")
    with open(path) as fh:
        src = fh.read()
    if src.count(SHARED) != 1:
        raise RuntimeError("hash_search.cuh no longer loads its operands as this script expects")
    with open(path, "w") as fh:
        fh.write(src.replace(SHARED, REGISTERS))
    return root


def child(root: str, mode: str, models=()) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", CHILD, root, REPO, mode, json.dumps(models)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, what: str):
    out, err = proc.communicate(timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{what} failed ({proc.returncode}): {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def summary(specs) -> dict:
    """Per tail-block count: the register range and the specializations that spill."""
    out = {}
    for nb in (1, 2):
        rows = {k: v for k, v in specs.items() if f"_nb{nb}_" in k}
        regs = [v["registers"] for v in rows.values()]
        out[f"nb{nb}"] = {"registers": [min(regs), max(regs)],
                          "spills": {k: v["spill_bytes"] for k, v in rows.items()
                                     if v["spill_bytes"]}}
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    print(cs.nvidia_smi("name,power.limit"), flush=True)
    roots = {"shared": REPO, "registers": make_register_copy()}
    builds = {v: child(root, "build") for v, root in roots.items()}
    ptxas = {}
    for v, proc in builds.items():
        log = finish(proc, f"build ({v})")["log"]
        ptxas[v] = {k: {cs.spec_label(s): r for s, r in sorted(cs.parse_ptxas(log[k]).items())}
                    for k in sorted(log) if not k.startswith("md5_search")}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "operand_placement.json"), "w") as fh:
        json.dump(ptxas, fh, indent=1)
    for k in sorted(ptxas["shared"]):
        print(json.dumps({"kernel": k, **{v: summary(ptxas[v][k]) for v in ptxas},
                          "timed_mw2_nb1_pow2": {v: ptxas[v][k]["mw2_nb1_pow2"]
                                                 for v in ptxas}}), flush=True)
    runs = []
    for v in ("shared", "registers", "registers", "shared"):
        r = finish(child(roots[v], "time", list(MODELS)), f"timing ({v})")
        runs.append(r)
        print(json.dumps({"operands": v, "ms": {m: r[m]["ms"] for m in MODELS}}), flush=True)
    agree = all(r[m]["result"] == runs[0][m]["result"]
                and r[m]["first_hit_d6"] == runs[0][m]["first_hit_d6"]
                for r in runs for m in MODELS)
    print(json.dumps({"results_agree": agree}), flush=True)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
