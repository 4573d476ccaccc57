"""The FMA-pipe designs of the md5, sha256, sha1, ripemd160, blake2b_256,
sha512 and sha384 rounds, timed beside the kernels as built, on one card.

``round_variants.cuh`` (beside this file) holds md5's rounds with u = f +
t as an IADD3 or an IMAD (``Md5Keyed``, built for the main path's var_word
1), sha256's without resident blocks and in the plain form
(``Sha256Unbounded``, ``Sha256Plain``), sha1's and ripemd160's in the
plain form (``Sha1Plain``, ``Ripemd160Plain``) and in the variants' own
copy of their rounds with each sum and rotate as an IMAD, rotl_fma or on
the ALU pipe (``Sha1As``, ``Ripemd160As``), the BLAKE2b and SHA-512
rounds with their 64-bit sums and rotates in the forms of
``fma_forms.cuh`` (the high limb of a sum as IMAD.X or through IMAD.WIDE,
a rotate's limbs as IMAD + IMAD.HI), and a wrapper that asks for resident
blocks.  ``VARIANTS`` names each design; the variant named by a model alone
is that model's kernel as built (``csrc/``), and ``<model>.as`` is the
variants' own copy of its rounds in the plain forms, which should compile
to the same loop.  This script builds ``round_variants.cu`` once per
variant (the variant defined in a one-line source beside it; the main path's
specializations only: one tail block, a power-of-two run, mask words 1
and 2), all at once, and prints per variant:

- ptxas's registers and spills, and what one candidate of the timed
  specialization (mask words 2) issues, by pipe and by opcode
  (``chip_smoke.py``'s ``sass_loops`` and ``pipe_split``);
- whether its first hits equal the plain version's on small launches at
  mask words 1 and 2, and its model's kernel's on a difficulty-6 launch of
  the main path's size;
- the main-path launch time (difficulty 16, nonce ``01020304``, width 4,
  batch 2^20 times the model's cost-scaled sub-batches), every variant
  timed in one process in turns, the order reversed every turn, and its
  median over the median of its model's kernel (``over_kernel``).

The card's name and power limit come first and last.

Run on a machine with an NVIDIA GPU and nvcc, from the root of a
checkout::

    python3 -m distpow_tpu_torch.tools.round_variants [variant ...]

No variant named: all of them.  The libraries live under
``distpow_tpu_torch/build/round_variants/``.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
SOURCE = os.path.join(PKG, "tools", "round_variants.cu")
BUILD = os.path.join(PKG, "build", "round_variants")
TURNS = 4


def blake(sum_="SUM_PLAIN", r24="ROT_SHF", r16="ROT_SHF", r63="ROT_SHF", every_other=False):
    return f"Blake2bAs<BlakeForms<{sum_}, {r24}, {r16}, {r63}, {int(every_other)}>>"


def sha(d, sum_="SUM_PLAIN", big="ROT_SHF", small="ROT_SHF", shr=False):
    return f"Sha512As<ShaForms<{sum_}, {big}, {small}, {int(shr)}>, {d}>"


def resident(hash_type: str, n: int) -> str:
    return f"Resident<{hash_type}, {n}>"


def sha1(sums=0, ft=0, rot5=0, wrot=0, rot30=0, crot=0):
    """sha1's rounds with e + (K + w) (``sums``) and f + t (``ft``) as IMAD,
    and rotl_fma in every ``rot5``-th round, schedule word and chain value
    (0: never); the other rotates as C shifts (``crot``) or through
    __funnelshift_l."""
    return f"Sha1As<Sha1Forms<{sums}, {ft}, {rot5}, {wrot}, {rot30}, {crot}>>"


def rmd(sums=0, ft=0, e_imad=0, rot=0, rot10=0, crot=0):
    """ripemd160's lines with a + (K + w) (``sums``), f + t (``ft``) and the +
    e after a funnel shift (``e_imad``) as IMAD, and rotl_fma for rotl(t,
    S) + e in every ``rot``-th round and for rotl(x, 10) in every
    ``rot10``-th chain value (0: never); ``crot`` as sha1's."""
    return f"Ripemd160As<RmdForms<{sums}, {ft}, {e_imad}, {rot}, {rot10}, {crot}>>"


H3 = dict(r24="ROT_HALF", r16="ROT_HALF", r63="ROT_HALF")
# name -> (model, the variant's hash type in namespace distpow)
VARIANTS = {
    "blake2b_256": ("blake2b_256", "Blake2b_256"),
    "blake2b_256.as": ("blake2b_256", blake()),
    "blake2b_256.sums_carry": ("blake2b_256", blake("SUM_CARRY")),
    "blake2b_256.sums_wide": ("blake2b_256", blake("SUM_WIDE")),
    "blake2b_256.rot63_half": ("blake2b_256", blake(r63="ROT_HALF")),
    "blake2b_256.rot_half": ("blake2b_256", blake(**H3)),
    "blake2b_256.rot24_16_fma_every_other":
        ("blake2b_256", blake(r24="ROT_FMA", r16="ROT_FMA", every_other=True)),
    "blake2b_256.resident2": ("blake2b_256", resident("Blake2b_256", 2)),
    "blake2b_256.resident3": ("blake2b_256", resident("Blake2b_256", 3)),
    "blake2b_256.rot_half.resident3": ("blake2b_256", resident(blake(**H3), 3)),
    "sha512": ("sha512", "Sha512"),
    "sha512.as": ("sha512", sha(16)),
    "sha512.sums_carry": ("sha512", sha(16, "SUM_CARRY")),
    "sha512.sums_wide": ("sha512", sha(16, "SUM_WIDE")),
    "sha512.big_half": ("sha512", sha(16, big="ROT_HALF")),
    "sha512.sigmas_half": ("sha512", sha(16, big="ROT_HALF", small="ROT_HALF")),
    "sha512.sigmas_half_shr": ("sha512", sha(16, big="ROT_HALF", small="ROT_HALF", shr=True)),
    "sha512.shr_fma": ("sha512", sha(16, shr=True)),
    "sha512.resident3": ("sha512", resident("Sha512", 3)),
    "sha512.big_half.resident3": ("sha512", resident(sha(16, big="ROT_HALF"), 3)),
    "sha384": ("sha384", "Sha384"),
    "sha384.big_half": ("sha384", sha(12, big="ROT_HALF")),
    "sha384.resident3": ("sha384", resident("Sha384", 3)),
    "md5": ("md5", "Md5<1>"),
    "md5.ft_alu": ("md5", "Md5Keyed<1, false>"),
    "md5.rows": ("md5", "Md5Keyed<1, true, false>"),
    "md5.kc_const": ("md5", "Md5KcConst<1>"),
    "sha256": ("sha256", "Sha256"),
    "sha256.unbounded": ("sha256", "Sha256Unbounded"),
    "sha256.resident5": ("sha256", resident("Sha256", 5)),
    "sha256.plain": ("sha256", "Sha256Plain"),
    "sha256.plain.resident5": ("sha256", resident("Sha256Plain", 5)),
    "sha1": ("sha1", "Sha1"),
    "sha1.plain": ("sha1", "Sha1Plain"),
    "sha1.as": ("sha1", sha1()),
    "sha1.sums": ("sha1", sha1(1)),
    "sha1.sums_ft": ("sha1", sha1(1, 1)),
    "sha1.sums_ft_crot": ("sha1", sha1(1, 1, crot=1)),
    "sha1.sums_ft_rot5": ("sha1", sha1(1, 1, rot5=1)),
    "sha1.sums_ft_rot5_half": ("sha1", sha1(1, 1, rot5=2)),
    "sha1.sums_ft_wrot": ("sha1", sha1(1, 1, wrot=1)),
    "sha1.sums_ft_wrot_half": ("sha1", sha1(1, 1, wrot=2)),
    "sha1.sums_ft_rot30": ("sha1", sha1(1, 1, rot30=1)),
    "sha1.sums_ft_rot30_half": ("sha1", sha1(1, 1, rot30=2)),
    "sha1.resident7": ("sha1", resident("Sha1", 7)),
    "sha1.resident8": ("sha1", resident("Sha1", 8)),
    "ripemd160": ("ripemd160", "Ripemd160"),
    "ripemd160.plain": ("ripemd160", "Ripemd160Plain"),
    "ripemd160.as": ("ripemd160", rmd()),
    "ripemd160.sums": ("ripemd160", rmd(1)),
    "ripemd160.sums_ft": ("ripemd160", rmd(1, 1)),
    "ripemd160.sums_ft_crot": ("ripemd160", rmd(1, 1, crot=1)),
    "ripemd160.sums_ft_e": ("ripemd160", rmd(1, 1, e_imad=1)),
    "ripemd160.sums_ft_rot": ("ripemd160", rmd(1, 1, rot=1)),
    "ripemd160.sums_ft_rot_half": ("ripemd160", rmd(1, 1, rot=2)),
    "ripemd160.sums_ft_rot10": ("ripemd160", rmd(1, 1, rot10=1)),
    "ripemd160.sums_ft_rot10_half": ("ripemd160", rmd(1, 1, rot10=2)),
    "ripemd160.resident7": ("ripemd160", resident("Ripemd160", 7)),
    "ripemd160.resident8": ("ripemd160", resident("Ripemd160", 8)),
}
# The nonce lengths of the first-hit checks: one-block tails (of 64-byte
# blocks: ONE_BLOCK16), and for md5,
# whose variants are built for the main path's var_word 1 only, tails whose
# run starts at word 1 (a 4-7 byte remainder)
ONE_BLOCK16 = (4, 9, 20, 37, 40, 50)
CHECK_NONCE_LENS = {"md5": (4, 5, 6, 7, 68, 71), "sha256": ONE_BLOCK16, "sha1": ONE_BLOCK16,
                    "ripemd160": ONE_BLOCK16}


def build(names):
    """Start one nvcc per variant; return {name: (process, library path)}."""
    from distpow_tpu_torch.ops import _build

    os.makedirs(BUILD, exist_ok=True)
    nvcc = _build.find_cuda_tool("nvcc")
    procs = {}
    for name in names:
        # nvcc's -D splits at commas, so the type goes into a source file
        src, lib = os.path.join(BUILD, f"{name}.cu"), os.path.join(BUILD, f"lib{name}.so")
        kc_const = "#define VARIANT_KC_CONST 1\n" if "KcConst" in VARIANTS[name][1] else ""
        with open(src, "w") as fh:
            fh.write(f"{kc_const}#define VARIANT {VARIANTS[name][1]}\n"
                     f"#include \"round_variants.cu\"\n")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", os.path.dirname(SOURCE), "-I", _build.CSRC_DIR,
               "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    return procs


def main(argv) -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    from distpow_tpu_torch.backends.cuda_backend import CudaBackend
    from distpow_tpu_torch.models.registry import get_hash_model
    from distpow_tpu_torch.ops import _build
    from distpow_tpu_torch.ops.hash_cuda import default_grid, kernel_layout
    from distpow_tpu_torch.ops.operands import make_operands, u32_value
    from distpow_tpu_torch.ops.packing import build_tail_spec
    from distpow_tpu_torch.ops.search_step import plain_search, step_operands
    from distpow_tpu_torch.parallel.search import launch_steps_for

    if not torch.cuda.is_available():
        print("round_variants: no CUDA device", file=sys.stderr)
        return 2
    names = argv or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}: one of {', '.join(VARIANTS)}")
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    vp, u32, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    fns, set_kc, rows = {}, {}, {}
    for name, (proc, lib) in build(names).items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        sass = subprocess.run([_build.find_cuda_tool("cuobjdump"), "-sass", lib],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        # mask words 2, one tail block, a power-of-two run (md5's at var_word 1)
        timed = cs.timed_key(VARIANTS[name][0])
        issued = cs.spec_sass_loops(sass, path=True)[timed]
        rows[name] = {"variant": name, "type": VARIANTS[name][1],
                      **cs.parse_ptxas(log)[timed],
                      "loop": sum(cs.spec_sass_loops(sass)[timed].values()),
                      "issued": sum(issued.values()), **cs.pipe_split(issued),
                      "opcodes": dict(sorted(issued.items()))}
        dll = ctypes.CDLL(lib)
        fn = dll.variant_search
        fn.argtypes = [vp, vp, vp, i32, i32, u32, u32, u32, i32, i32, i32, u32, u32, vp, i32, vp]
        fn.restype = i32
        fns[name] = fn
        set_kc[name] = dll.variant_set_kc
        set_kc[name].argtypes, set_kc[name].restype = [vp], i32
    md5_k = [int(abs(math.sin(i + 1)) * (1 << 32)) & 0xFFFFFFFF for i in range(64)]
    md5_g = [i if i < 16 else (5 * i + 1) % 16 if i < 32 else (3 * i + 5) % 16 if i < 48
             else (7 * i) % 16 for i in range(64)]
    tables = {}

    def launch(name, ops, spec, chunk0, n):
        model = get_hash_model(VARIANTS[name][0])
        vw, vs, cm = kernel_layout(spec.tb_loc, spec.chunk_locs, model)
        if "KcConst" in VARIANTS[name][1] and tables.get(name) != spec.base_words[0]:
            # the table of this launch's first row, before the launch
            kc = np.array([(md5_k[i] + spec.base_words[0][md5_g[i]]) & 0xFFFFFFFF
                           for i in range(64)], dtype=np.uint32)
            torch.cuda.synchronize(dev)
            if set_kc[name](kc.ctypes.data):
                raise RuntimeError(f"{name}: writing the table failed")
            tables[name] = spec.base_words[0]
        out = torch.full((), -1, dtype=torch.int32, device=dev)
        log_tbc = ops.tb_count.bit_length() - 1
        rc = fns[name](ops.init.data_ptr(), ops.base.data_ptr(), ops.masks.data_ptr(), 1,
                       ops.mask_words, chunk0, ops.tb_lo, ops.tb_count, log_tbc, vw, vs, cm, n,
                       out.data_ptr(), default_grid(n, sm),
                       torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        return out

    main_path = {}
    for m in {VARIANTS[n][0] for n in names}:
        model = get_hash_model(m)
        spec = build_tail_spec(bytes([1, 2, 3, 4]), 4, model)
        steps = launch_steps_for(4, cs.MAIN_BATCH // 256, 256,
                                 CudaBackend(hash_model=m, device=dev).max_launch)
        main_path[m] = (spec, steps, {d: step_operands(spec, d, model, 0, 256, dev)
                                      for d in (6, cs.RATE_DIFFICULTY)})

    # first hits: small launches against the plain version (7 random mask
    # bits over 1 or 2 words, so a hit comes every 128 candidates or so),
    # and the main path's difficulty-6 launch against the model's kernel
    agree = True
    for name in names:
        m = VARIANTS[name][0]
        model = get_hash_model(m)
        rng = np.random.default_rng(7)
        checks = []
        lens = CHECK_NONCE_LENS.get(m, (4, 37, 70, 101, 9, 62))
        for mw, nonce_len in zip((1, 1, 2, 2, 1, 2), lens):
            spec = build_tail_spec(rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes(),
                                   4, model)
            masks = [0] * mw
            for b in rng.choice(32 * mw, size=7, replace=False):
                masks[int(b) // 32] |= 1 << (int(b) % 32)
            ops = make_operands(spec.init_state, spec.base_words, masks, 0, 256, dev)
            got = u32_value(launch(name, ops, spec, 70000, 1 << 16))
            want = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, 70000, 1 << 16,
                                          model=model))
            checks.append(got == want)
        spec, steps, ops = main_path[m]
        rows[name]["first_hit_d6"] = u32_value(launch(name, ops[6], spec, cs.MAIN_CHUNK0,
                                                      cs.MAIN_BATCH * steps))
        rows[name]["plain_agrees"] = all(checks)
        agree &= all(checks)
    for name in names:
        kernel = VARIANTS[name][0]
        if kernel in rows and rows[name]["first_hit_d6"] != rows[kernel]["first_hit_d6"]:
            rows[name]["plain_agrees"] = agree = False

    def timed(name):
        spec, steps, ops = main_path[VARIANTS[name][0]]
        return launch(name, ops[cs.RATE_DIFFICULTY], spec, cs.MAIN_CHUNK0, cs.MAIN_BATCH * steps)

    for name in names:
        timed(name)
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for turn in range(TURNS):
        for name in (names if turn % 2 == 0 else names[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(cs.RATE_LAUNCHES):
                timed(name)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / cs.RATE_LAUNCHES)
    for name in names:
        kernel = VARIANTS[name][0]
        med = statistics.median(times[name])
        rows[name].update(ms=times[name], median_ms=med,
                          over_kernel=(med / statistics.median(times[kernel])
                                       if kernel in times else None))
        print(json.dumps(rows[name]), flush=True)
    print(json.dumps({"plain_agrees": agree}), flush=True)
    print(card, flush=True)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
