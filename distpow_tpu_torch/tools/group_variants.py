"""md5's group kernel as built beside variants of its design, on one card.

Each variant is a copy of ``csrc/`` with one change, built with the group
C function alone at var_word 1 (one nvcc each, all started together):

* ``as_built``: the kernel of this checkout (``hash_search.cuh``
  ``hash_group_block``: a block tests one slot, the grid's later blocks
  take the slots still open, 16 tiles a block of the wave);
* ``slot_loop``: each block stays resident and loops over slots, making
  each slot's launch constants at the top of that loop
  (``tools/group_slot_loop.cuh`` in place of ``hash_group_block``);
* ``cell_at_start``: thread 0 reads the slot's cell for a tile's check as
  the tile begins, as the other hashes' group kernels do, not at its end;
* ``waves1``: one resident wave of blocks (``GROUP_WAVES`` 1), so no later
  blocks to take the slots that stay open.

For each it prints ptxas' registers and spills of the one- and two-block
kernels, and their candidate loops (``chip_smoke.sass_loops``' widest loop
without a barrier): the instructions one candidate issues, by pipe, and
those that add md5's K[i] + m on the uniform datapath (``UIADD3``).  Then
it times every variant, and ``as_built`` at 1 round a tile (the rounds
argument), in four turns (forward, backward, forward, backward) at md5's
engine launch of 8 slots x 2^20: difficulty 16 (no hit), and difficulty 5
with distinct nonces (five of the eight hit), each launch's words held to
the plain group step; the kernel alone, launches enqueued behind a spin of
the card (``chip_smoke.device_and_host``), and the claims per slot.

Run from the root of a checkout on a machine with a GPU::

    python3 -m distpow_tpu_torch.tools.group_variants

It prints the card's name and power limit, then one JSON line a variant's
build and one a case; exits 1 where a variant's words differ from the plain
group step's, and 2 at once when no GPU is visible.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
SRC = os.path.join(PKG, "csrc")
OUT = os.path.join(PKG, "build", "group_variants")
MAIN = '#include "md5.cuh"\nDISTPOW_GROUP_FUNCTION(md5, distpow::Md5<1>, var_word == 1)\n'
SLOTS, BATCH, REPS = 8, 1 << 20, 20
BLOCK = ("template <class H, int N_BLOCKS>\n__device__ __forceinline__ void hash_group_block(",
         "template <class H, int N_BLOCKS>\n__global__ void __launch_bounds__(HASH_BLOCK_THREADS)\n"
         "hash_group_search_kernel(")


def variants():
    """name -> its changes to hash_search.cuh, (old, new) pairs."""
    with open(os.path.join(SRC, "hash_search.cuh")) as fh:
        header = fh.read()
    a, b = header.index(BLOCK[0]), header.index(BLOCK[1])
    with open(os.path.join(PKG, "tools", "group_slot_loop.cuh")) as fh:
        loop = fh.read()
    return {"as_built": [],
            "slot_loop": [(header[a:b], loop + "\n")],
            "cell_at_start": [("constexpr bool EARLY = !KeyedByVarWord<H>::value;",
                               "constexpr bool EARLY = true;")],
            "waves1": [("constexpr int GROUP_WAVES = 3;", "constexpr int GROUP_WAVES = 1;")]}


def build(cs) -> dict:
    """Each variant's library, built at once; prints its ptxas and loops."""
    from distpow_tpu_torch.ops import _build

    nvcc, cuobjdump = _build.find_cuda_tool("nvcc"), _build.find_cuda_tool("cuobjdump")
    procs = {}
    for name, changes in variants().items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        path = os.path.join(d, "hash_search.cuh")
        with open(path) as fh:
            text = fh.read()
        for old, new in changes:
            if old not in text:
                raise RuntimeError(f"{name}: hash_search.cuh no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        with open(path, "w") as fh:
            fh.write(text)
        with open(os.path.join(d, "main.cu"), "w") as fh:
            fh.write(MAIN)
        lib = os.path.join(d, "libgroup.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-DDISTPOW_VAR_WORD=1", "-I", d, "-o", lib,
               os.path.join(d, "main.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed ({proc.returncode}): {log[-3000:]}")
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout
        ptxas = {cs.name_key(n, cs.GROUP_KEY): (int(regs), int(st) + int(ld))
                 for n, _, st, ld, regs in re.findall(cs.PTXAS_FUNCTION, log)}
        issued = cs.by_group(cs.sass_loops(sass, path=True, candidate=True))
        kernels = {f"nb{k[0]}": {"registers": ptxas[k][0], "spill_bytes": ptxas[k][1],
                                 "blocks_per_sm": cs.blocks_per_sm(ptxas[k][0]),
                                 "issued_per_candidate": sum(v.values()),
                                 **cs.pipe_split(v),
                                 "uiadd3": sum(c for op, c in v.items()
                                               if op.startswith("UIADD3"))}
                   for k, v in sorted(issued.items())}
        print(json.dumps({"variant": name, "kernels": kernels}), flush=True)
        libs[name] = lib
    return libs


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("group_variants: no GPU visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distpow_tpu_torch.models.registry import get_hash_model
    from distpow_tpu_torch.ops._build import GROUP_ARGTYPES
    from distpow_tpu_torch.ops.difficulty import nibble_masks
    from distpow_tpu_torch.ops.hash_cuda import kernel_layout
    from distpow_tpu_torch.ops.operands import group_operands
    from distpow_tpu_torch.ops.packing import build_tail_spec
    from distpow_tpu_torch.ops.search_step import plain_group_search

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    fns = {}
    for name, lib in build(cs).items():
        fn = ctypes.CDLL(lib).distpow_md5_group_search
        fn.argtypes, fn.restype = GROUP_ARGTYPES, ctypes.c_int
        fns[name] = fn
    md5 = get_hash_model("md5")
    cells = torch.tensor([-1] * SLOTS + [0] * SLOTS, dtype=torch.int32, device=dev)

    def group(nonces, d, chunk0):
        specs = [build_tail_spec(n, 4, md5) for n in nonces]
        ops = group_operands([s.init_state for s in specs], [s.base_words for s in specs],
                             [nibble_masks(d, md5)] * SLOTS, [0] * SLOTS, [8] * SLOTS, chunk0,
                             dev)
        return specs[0], ops

    def launcher(fn, sp, ops, rounds):
        layout = kernel_layout(sp.tb_loc, sp.chunk_locs, md5)

        def launch():
            out = cells.clone()
            rc = fn(ops.init.data_ptr(), ops.base.data_ptr(), ops.masks.data_ptr(),
                    ops.n_blocks, *layout, ops.tb_lo.data_ptr(), ops.log_tbc.data_ptr(),
                    ops.chunk0.data_ptr(), SLOTS, BATCH, rounds, out.data_ptr(), 0,
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"group launch failed: CUDA error {rc}")
            return out
        return launch

    forms = {name: (fn, 64) for name, fn in fns.items()}
    forms["as_built_1_round"] = (fns["as_built"], 1)
    cases = {"d16": group([bytes([1, 2, 3, 4 + s]) for s in range(SLOTS)], 16,
                          [(1 << 24) + (BATCH >> 8) * s for s in range(SLOTS)]),
             "d5": group([bytes([5, 6, 7, 8 + s]) for s in range(SLOTS)], 5, [1 << 24] * SLOTS)}
    same = True
    for case, (sp, ops) in cases.items():
        want = plain_group_search(md5, ops, sp.tb_loc, sp.chunk_locs, BATCH).tolist()
        runs, claims, words = {f: [] for f in forms}, {}, {}
        for turn in range(4):
            for f in (list(forms) if turn % 2 == 0 else list(forms)[::-1]):
                launch = launcher(forms[f][0], sp, ops, forms[f][1])
                cell = [v & 0xFFFFFFFF for v in launch().tolist()]
                words[f], claims[f] = cell[:SLOTS], cell[SLOTS:]
                same &= words[f] == want
                runs[f].append(cs.device_and_host(launch, REPS)[0])
        print(json.dumps({"case": case, "plain": want, "words": words, "device_ms": runs,
                          "claims": claims}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
