#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MD5 mining path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
CUDA kernel from ``distpow_tpu_torch/csrc``, holds it against its plain
PyTorch version on the card, mines through ``get_backend("auto")`` at the
worker's full size (batch 2^20, 2^30-candidate launches), checks
cancellation, and times the kernel.  Every phase prints one JSON line; the
last line, printed only when every phase passed, is
``{"ok": true, "device": {...}}``.  It imports neither JAX nor the JAX
package.  Long outputs (the nvcc log, the SASS) go to ``chiprun_out/``.

Exits non-zero, without the result line, when no GPU is available, when the
port's package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# Parity grid (phase kernel_parity): every tail shape, width, mask bucket,
# partition kind and launch multiplier the plain step handles.
NONCE_LENS = (1, 4, 13, 55, 56, 63, 64, 100)
DIFFICULTIES = (0, 1, 2, 5, 8, 9, 12, 16)
# (tb_lo, tbc, chunks per sub-batch): sub-batches of at most 2^14, so
# batch * launch_steps stays within 2^16
PARTITIONS = ((0, 256, 64), (64, 64, 256), (7, 1, 4096), (16, 96, 128))
LAUNCH_STEPS = (1, 3)

# Hopper issues at most one warp instruction per clock from each of an SM's
# four schedulers: 4 x 32 = 128 thread results per clock per SM, whatever
# the pipe.  The programming guide's 64 per clock for 32-bit integer ops is
# no floor for this kernel: it measured faster than that rate allows.
ISSUED_RESULTS_PER_CLOCK_PER_SM = 128

# The main path's launch: batch 2^20 x 1024 sub-batches of a width-4 segment
MAIN_BATCH, MAIN_STEPS, MAIN_CHUNK0 = 1 << 20, 1 << 10, 1 << 24

RATE_LAUNCHES = 10
RATE_DIFFICULTY = 16
# full_parity: nonces tried for a difficulty-7 first hit deep in the launch
FULL_PARITY_TRIES = 256

# message word of MD5 round i
MD5_G = tuple(i if i < 16 else (5 * i + 1) % 16 if i < 32 else (3 * i + 5) % 16 if i < 48
              else (7 * i) % 16 for i in range(64))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self):
        self.failed = []
        self.info = {}

    def phase(self, name, fn, needs=()):
        missing = [n for n in needs if n in self.failed or n not in self.info]
        if missing:
            self.failed.append(name)
            emit({"phase": name, "ok": False, "error": f"skipped: {missing} did not pass"})
            return
        t0 = time.monotonic()
        try:
            out = fn()
        except Exception as exc:  # report the phase and go on; the run fails at the end
            self.failed.append(name)
            emit({"phase": name, "ok": False, "error": f"{type(exc).__name__}: {exc}",
                  "traceback": traceback.format_exc()[-4000:]})
            return
        self.info[name] = out
        emit({"phase": name, "ok": True, "wall_s": time.monotonic() - t0, **out})


def parse_sass_loops(sass: str):
    """Per kernel specialization ``(mask_words, n_blocks, pow2)``: the
    count of instructions in its grid-stride loop body (one candidate; the loop is
    not unrolled), counted between the widest backward branch and its
    target, NOPs excluded."""
    out = {}
    parts = re.split(r"\n\s*Function : ", sass)
    for part in parts[1:]:
        name = part.split("\n", 1)[0].strip()
        m = re.search(r"md5_search_kernelILi(\d)ELi(\d)ELb(\d)E", name)
        if not m:
            continue
        instrs, labels = [], {}
        pending = []
        for line in part.splitlines():
            lab = re.match(r"^\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            ins = re.match(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if not ins:
                continue
            addr = int(ins.group(1), 16)
            for p in pending:
                labels[p] = addr
            pending = []
            instrs.append((addr, ins.group(2)))
        best = None
        for addr, text in instrs:
            br = re.search(r"\bBRA\s+`?\(?(0x[0-9a-f]+|\.L_x_\d+)", text)
            if not br:
                continue
            tgt = br.group(1)
            tgt = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
            if tgt is not None and tgt < addr and (best is None or addr - tgt > best[1] - best[0]):
                best = (tgt, addr)
        if best is None:
            continue
        body = [t for a, t in instrs if best[0] <= a <= best[1]
                and not re.match(r"^(@!?U?P\w+\s+)?NOP\b", t)]
        out[(int(m.group(1)), int(m.group(2)), m.group(3) == "1")] = len(body)
    return out


def md5_needed_ops(n_blocks: int, mask_words: int, var_words) -> int:
    """Integer operations one candidate of a power-of-two run needs, counted
    from MD5 itself rather than from what the kernel issues.

    A round is three: F (one three-input logic op), f + a + (K[i] + m[g]) (one
    three-input add, with K[i] + m[g] folded to a constant for a constant
    word) and b + rotl(f, s) (one shift-and-add); a round that reads one of
    ``var_words`` (tail word indices that hold variable bytes) adds the
    K[i] + m[g] that cannot fold.  The last block runs only the rounds that
    feed the ``mask_words`` digest words read (62, 63 or 64).  Around the
    rounds: the digest adds, decode (shift + add, and + add), placing the
    variable bytes (one combine, then a shift and an OR per word), the mask
    fold (one op per mask word), the hit test (compare + branch) and the
    loop (add, compare, branch).  Selects against a runtime layout are not
    counted: a kernel built for the layout needs none.
    """
    n = 0
    for blk in range(n_blocks):
        last = blk == n_blocks - 1
        for i in range(min(64, 61 + mask_words) if last else 64):
            n += 3 + (16 * blk + MD5_G[i] in var_words)
        n += mask_words if last else 4
    return n + 4 + 1 + 2 * len(var_words) + mask_words + 2 + 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import distpow_tpu_torch

    pkg = os.path.dirname(os.path.abspath(distpow_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        print(f"chip_smoke: distpow_tpu_torch was imported from {pkg}, not from "
              f"this checkout ({HERE})", file=sys.stderr)
        return 2

    from distpow_tpu_torch.backends import get_backend
    from distpow_tpu_torch.backends.cuda_backend import CudaBackend
    from distpow_tpu_torch.models import puzzle
    from distpow_tpu_torch.models.registry import MD5
    from distpow_tpu_torch.ops import _build
    from distpow_tpu_torch.ops.md5_cuda import BLOCK_THREADS, LAUNCHES, default_grid, md5_search
    from distpow_tpu_torch.ops.operands import make_operands, u32_value
    from distpow_tpu_torch.ops.packing import build_tail_spec
    from distpow_tpu_torch.ops.search_step import (
        SENTINEL, mask_words_for, plain_search, plain_search_w0, step_operands)
    from distpow_tpu_torch.parallel.partition import thread_bytes, worker_bits
    from distpow_tpu_torch.runtime.metrics import REGISTRY

    os.makedirs(OUT_DIR, exist_ok=True)
    smoke = Smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def sync_value(t) -> int:
        torch.cuda.synchronize()
        return u32_value(t)

    # 1. device ---------------------------------------------------------
    def device():
        line = nvidia_smi("name,power.limit,clocks.max.sm")
        name, power, clock = (s.strip() for s in line.split(","))
        props = torch.cuda.get_device_properties(dev)
        return {"nvidia_smi": line, "name": name, "power_limit": power,
                "clocks_max_sm": clock, "clock_mhz": float(clock.split()[0]),
                "sm_count": props.multi_processor_count, "torch": torch.__version__,
                "torch_cuda": torch.version.cuda, "python": sys.version.split()[0]}

    smoke.phase("device", device)

    # 2. build ----------------------------------------------------------
    loops = {}

    def build():
        paths = _build.build()
        build_s = _build.last_build_s
        log = "\n".join(f"== {k}\n{v}" for k, v in _build.last_build_log.items())
        with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as fh:
            fh.write(log)
        # ptxas -v: registers and spill bytes per specialization
        ptxas = {}
        pattern = (r"md5_search_kernelILi(\d)ELi(\d)ELb(\d)E[^\n]*\n\s*(\d+) bytes stack frame, "
                   r"(\d+) bytes spill stores, (\d+) bytes spill loads\n[^\n]*Used (\d+) registers")
        for mw, nb, p2, _, st, ld, regs in re.findall(pattern, log):
            key = f"mw{mw}_nb{nb}_{'pow2' if p2 == '1' else 'div'}"
            ptxas[key] = {"registers": int(regs), "spill_bytes": int(st) + int(ld)}
        lib = paths["md5_search"]
        sass = subprocess.run([_build.find_cuda_tool("cuobjdump"), "-sass", lib],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        with open(os.path.join(OUT_DIR, "md5_search.sass"), "w") as fh:
            fh.write(sass)
        loops.update(parse_sass_loops(sass))
        if len(loops) != 16:
            raise RuntimeError(f"found the loop of {len(loops)} of 16 specializations")
        _build.load_library("md5_search")
        return {"build_s": build_s, "libraries": {k: os.path.relpath(v, HERE)
                                                              for k, v in paths.items()},
                "ptxas": ptxas,
                "loop_instructions": {f"mw{k[0]}_nb{k[1]}_{'pow2' if k[2] else 'div'}": v
                                      for k, v in sorted(loops.items())}}

    smoke.phase("build", build, needs=("device",))

    # 3. kernel_parity --------------------------------------------------
    def kernel_parity():
        import numpy as np

        rng = np.random.default_rng(20261016)
        cases = []  # (label, ops, spec, chunk0, batch, steps, grid)
        i = 0
        for n_len in NONCE_LENS:
            nonce = rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes()
            for width in range(5):
                for d in DIFFICULTIES:
                    tb_lo, tbc, chunks = PARTITIONS[i % len(PARTITIONS)]
                    steps = LAUNCH_STEPS[(i // len(PARTITIONS)) % 2]
                    extra = b"\x01\x02" if i % 7 == 3 else b""
                    i += 1
                    spec = build_tail_spec(nonce, width, MD5, extra)
                    ops = step_operands(spec, d, MD5, tb_lo, tbc, dev)
                    if width == 0:
                        cases.append((f"n{n_len}_w0_d{d}", ops, spec, 0, tbc, 1, None))
                        continue
                    # segment start, and a start whose launch runs past the
                    # width's end (chunk bytes wrap as in the driver's overshoot)
                    chunk0 = 256 ** (width - 1) if i % 2 else 256 ** width - 5
                    cases.append((f"n{n_len}_w{width}_d{d}_tbc{tbc}_k{steps}", ops, spec,
                                  chunk0, chunks * tbc, steps, None))
        # synthetic sparse masks: hits in every mask bucket and tail shape,
        # first hits deep in the launch, small grids that loop
        for mw in (1, 2, 3, 4):
            for n_len in (13, 60):
                for (tb_lo, tbc, chunks), bits, grid in (((0, 256, 64), 6, None),
                                                         ((16, 96, 128), 13, 3)):
                    nonce = rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes()
                    spec = build_tail_spec(nonce, 3, MD5)
                    masks = [0] * mw
                    for b in rng.choice(32 * mw, size=bits, replace=False):
                        masks[int(b) // 32] |= 1 << (int(b) % 32)
                    ops = make_operands(spec.init_state, spec.base_words, masks, tb_lo, tbc, dev)
                    cases.append((f"mask{mw}_n{n_len}_tbc{tbc}_bits{bits}", ops, spec, 70000,
                                  chunks * tbc, 3, grid))
        mismatches, hits, max_err = [], 0, 0
        for label, ops, spec, chunk0, batch, steps, grid in cases:
            got = sync_value(md5_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch,
                                        steps, device=dev, grid=grid))
            if spec.width == 0:
                want = u32_value(plain_search_w0(ops, spec.tb_loc, spec.chunk_locs))
            else:
                want = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0,
                                              batch, steps))
            hits += want != SENTINEL
            max_err = max(max_err, abs(got - want))
            if got != want:
                mismatches.append({"case": label, "kernel": got, "plain": want})
        if mismatches:
            raise AssertionError(f"{len(mismatches)} of {len(cases)} cases differ: "
                                 f"{mismatches[:10]}")
        return {"cases": len(cases), "mismatches": 0, "hit_cases": hits,
                "sentinel_cases": len(cases) - hits, "max_abs_err": max_err,
                "tolerance": "exact (integer first-hit index)"}

    smoke.phase("kernel_parity", kernel_parity, needs=("build",))

    # 3b. full_parity: the main path's launch (2^30 candidates, the wrapper's
    # grid) against the plain version, on inputs with hits -------------------
    def full_parity():
        n = MAIN_BATCH * MAIN_STEPS
        grid = default_grid(n, smoke.info["device"]["sm_count"])
        stride = grid * BLOCK_THREADS

        def operands(nonce, d):
            spec = build_tail_spec(nonce, 4, MD5)
            return spec, step_operands(spec, d, MD5, 0, 256, dev)

        def kernel(spec, ops):
            return sync_value(md5_search(ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0,
                                         MAIN_BATCH, MAIN_STEPS, device=dev))

        # a nonce whose first difficulty-7 hit lies in the launch's second
        # half and in a block of the grid's second half (the plain version
        # below is the judge of the index the kernel reports)
        for i in range(FULL_PARITY_TRIES):
            nonce = bytes([0x70, 0x61, 0x72, i])
            f = kernel(*operands(nonce, 7))
            if f != SENTINEL and f >= n // 2 and (f % stride) // BLOCK_THREADS >= grid // 2:
                break
        else:
            raise AssertionError(f"no nonce of {FULL_PARITY_TRIES} has a deep first hit")
        cases, max_err = [], 0
        # difficulty 7: one deep first hit and few others; difficulty 6: hits
        # in many blocks at once, whose atomicMin must keep the first
        for d in (7, 6):
            spec, ops = operands(nonce, d)
            got = kernel(spec, ops)
            want = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0,
                                          MAIN_BATCH, MAIN_STEPS))
            max_err = max(max_err, abs(got - want))
            cases.append({"difficulty": d, "kernel": got, "plain": want,
                          "fraction_of_launch": got / n,
                          "block": (got % stride) // BLOCK_THREADS})
            if got != want or want == SENTINEL:
                raise AssertionError(f"full launch at difficulty {d}: kernel {got}, plain {want}")
        return {"nonce": nonce.hex(), "candidates": n, "grid": grid, "nonces_tried": i + 1,
                "cases": cases, "mismatches": 0, "max_abs_err": max_err,
                "tolerance": "exact (integer first-hit index)"}

    smoke.phase("full_parity", full_parity, needs=("build", "device"))

    # 4. mine: the worker's path through get_backend("auto") -------------
    def mine():
        backend = get_backend("auto")
        if not isinstance(backend, CudaBackend) or backend.batch_size != 1 << 20:
            raise AssertionError(f"auto resolved to {backend!r}")
        nonce = bytes([1, 2, 3, 4])
        full = thread_bytes(0, worker_bits(1))
        LAUNCHES.reset()
        REGISTRY.reset()
        requests = []

        def counts():
            return (REGISTRY.get("search.hashes"), REGISTRY.get("search.launches"),
                    LAUNCHES.value)

        def deltas(before):
            return dict(zip(("hashes_dispatched", "search_launches", "kernel_launches"),
                            (b - a for a, b in zip(before, counts()))))

        for d in (5, 6, 8):
            before = counts()
            t0 = time.monotonic()
            secret = backend.search(nonce, d, full)
            wall = time.monotonic() - t0
            if secret is None or not puzzle.check_secret(nonce, secret, d):
                raise AssertionError(f"difficulty {d}: {secret!r} does not solve")
            digest = hashlib.md5(nonce + secret).hexdigest()
            if not digest.endswith("0" * d):
                raise AssertionError(f"difficulty {d}: hashlib digest {digest}")
            req = {"difficulty": d, "workers": 1, "secret": secret.hex(), "md5": digest,
                   "wall_s": wall, **deltas(before)}
            if d == 5:
                oracle = puzzle.python_search(nonce, d, full)
                req["python_search"] = oracle.hex()
                if oracle != secret:
                    raise AssertionError(f"difficulty 5: kernel {secret.hex()} != "
                                         f"python_search {oracle.hex()}")
            requests.append(req)

        # 4-way prefix split on the one card, each worker in its own thread
        # and stream; the first result wins and cancels the others
        nonce4, d4 = bytes([5, 6, 7, 8]), 8
        bits = worker_bits(4)
        done = threading.Event()
        results = [None] * 4
        errors = []

        def worker(i):
            try:
                with torch.cuda.stream(torch.cuda.Stream(dev)):
                    secret = backend.search(nonce4, d4, thread_bytes(i, bits), done.is_set)
                    torch.cuda.current_stream(dev).synchronize()
                if secret is not None:
                    results[i] = (time.monotonic(), secret)
                    done.set()
            except Exception as exc:  # surfaced below through errors
                errors.append(f"worker {i}: {exc!r}")
                done.set()

        before = counts()
        t0 = time.monotonic()
        threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            done.set()
            raise AssertionError("a 4-way worker did not finish within 300 s")
        if errors:
            raise AssertionError("; ".join(errors))
        found = sorted((r[0], i, r[1]) for i, r in enumerate(results) if r is not None)
        if not found:
            raise AssertionError("no 4-way worker found a secret")
        t_win, winner, secret = found[0]
        digest = hashlib.md5(nonce4 + secret).hexdigest()
        if not digest.endswith("0" * d4) or secret[0] >> 6 != winner:
            raise AssertionError(f"4-way: {secret.hex()} from worker {winner}, md5 {digest}")
        requests.append({"difficulty": d4, "workers": 4, "winner": winner,
                         "secret": secret.hex(), "md5": digest, "wall_s": t_win - t0,
                         **deltas(before), "finished": sum(r is not None for r in results)})
        launches = LAUNCHES.value
        if launches <= 0:
            raise AssertionError("the main path launched the kernel no time")
        return {"requests": requests, "kernel_launches": {"md5_search": launches},
                "search_launches": REGISTRY.get("search.launches"),
                "blocking_syncs": REGISTRY.get("search.blocking_syncs")}

    smoke.phase("mine", mine, needs=("kernel_parity",))

    # 5. cancel ---------------------------------------------------------
    def cancel():
        backend = get_backend("auto")
        t0 = time.monotonic()
        res = backend.search(bytes([9, 9, 9, 9]), 16, thread_bytes(0, worker_bits(1)),
                             lambda: time.monotonic() - t0 > 1.0)
        t_ret = time.monotonic() - t0
        torch.cuda.synchronize()
        if res is not None:
            raise AssertionError(f"cancelled search returned {res!r}")
        return {"returned": None, "time_to_cancel_s": t_ret - 1.0, "return_s": t_ret,
                "drained_s": time.monotonic() - t0}

    smoke.phase("cancel", cancel, needs=("build",))

    # 6. rate -----------------------------------------------------------
    def rate():
        nonce, width = bytes([1, 2, 3, 4]), 4
        spec = build_tail_spec(nonce, width, MD5)
        ops = step_operands(spec, RATE_DIFFICULTY, MD5, 0, 256, dev)
        batch, steps, chunk0 = MAIN_BATCH, MAIN_STEPS, MAIN_CHUNK0
        n = batch * steps
        grid = default_grid(n, smoke.info["device"]["sm_count"])

        def launch():
            return md5_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, steps,
                              device=dev)

        first = sync_value(launch())  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(RATE_LAUNCHES):
            launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / RATE_LAUNCHES

        # the plain version on the same inputs: no yardstick of speed, it
        # repeats the kernel's arithmetic in ~1000 elementwise torch ops
        small = 1 << 16
        plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, small, 1)
        start.record()
        plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, small, 1)
        end.record()
        end.synchronize()
        plain_small_ms = start.elapsed_time(end)
        start.record()
        plain_full = plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, steps)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        if u32_value(plain_full) != first:
            raise AssertionError(f"full launch: kernel {first} != plain {u32_value(plain_full)}")

        # the bound: the operations MD5 needs per candidate (no hit at this
        # difficulty, so every candidate is hashed) at the issue rate; the
        # kernel's own SASS loop count is a diagnostic beside it
        mw = mask_words_for(RATE_DIFFICULTY, MD5)
        var_words = {16 * b + w for b, w, _ in (spec.tb_loc, *spec.chunk_locs)}
        needed = md5_needed_ops(spec.n_blocks, mw, var_words)
        dev_info = smoke.info["device"]
        sass = loops[(mw, spec.n_blocks, True)]
        ops_per_s = ISSUED_RESULTS_PER_CLOCK_PER_SM * dev_info["sm_count"] * \
            dev_info["clock_mhz"] * 1e6
        bound_ms = n * needed / ops_per_s * 1e3
        return {"difficulty": RATE_DIFFICULTY, "mask_words": mw, "candidates_per_launch": n,
                "grid": grid, "launches_timed": RATE_LAUNCHES, "ms": ms,
                "ghs": n / ms / 1e6, "result": first,
                "plain_ms_full_launch": plain_ms,
                "plain_ms_2p16_no_yardstick": plain_small_ms,
                "needed_ops_per_hash": needed, "bound_ms": bound_ms,
                "bound_ghs": n / bound_ms / 1e6, "bound_share": bound_ms / ms,
                "sass_instructions_per_hash": sass,
                "sass_issue_ms": n * sass / ops_per_s * 1e3,
                "card": dev_info["nvidia_smi"]}

    smoke.phase("rate", rate, needs=("build", "device"))

    r = smoke.info.get("rate")
    if r is not None and all(p in smoke.info for p in ("mine", "kernel_parity", "full_parity")):
        emit({"kernels": [{
            "name": "md5_search", "route": "cuda",
            "source": "distpow_tpu_torch/csrc/md5_search.cu",
            "replaces": "distpow_tpu/ops/md5_pallas.py:698",
            "launches": smoke.info["mine"]["kernel_launches"]["md5_search"],
            "max_abs_err": max(smoke.info[p]["max_abs_err"]
                               for p in ("kernel_parity", "full_parity")),
            "ms": r["ms"], "plain_ms": r["plain_ms_full_launch"],
            "bound_ms": r["bound_ms"], "bound_by": "operations", "library_ms": None}]})
    if "device" in smoke.info:
        print(nvidia_smi("name,power.limit"), flush=True)
    if smoke.failed:
        print(f"chip_smoke: failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
