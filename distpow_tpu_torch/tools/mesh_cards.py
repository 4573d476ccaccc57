"""The mesh across the cards of one host: the path between cards.

Shards on different cards take a path that logical shards on one card do
not: each shard's operands are made on its card, each shard runs on its
card's stream, and its result cell is copied to the first card
(``non_blocking``) for the least index (``Mesh.run``); the scheduler's mesh
lane also copies each group's rows from the first card to every other.
This script drives that path with one shard per visible GPU:

* ``main_launch``: md5's mesh step at the worker's main-path launch (2^20
  candidates a sub-batch, ``launch_steps_for``'s multiplier) on a nonce whose
  difficulty-7 first hit lies in a shard past the first, held to the solo
  kernel on the same candidates and to the plain mesh step;
* ``mine``: ``get_backend("pallas-mesh")`` and ``search_mesh`` over every
  card, md5 at difficulties 6 and 8, on a 4-way partition and on a run of
  2 thread bytes (the chunk split), and sha512 at 6; each secret checked
  with hashlib and against the solo backend's, the mesh launch counts set
  to 0 just before and read just after;
* ``sched``: the scheduler's mesh lane over every card on eight requests,
  under ``torch.cuda.set_sync_debug_mode("error")``, each secret the solo
  backend's.

Run from the root of a checkout on a machine with more than one GPU::

    python3 -m distpow_tpu_torch.tools.mesh_cards

It prints the cards' names and power limits, then one JSON line; it exits
non-zero, after that line, when a check fails, and at once when fewer than
two GPUs are visible.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

MAIN_BATCH, MAIN_CHUNK0 = 1 << 20, 1 << 24
DEEP_DIFFICULTY, DEEP_TRIES = 7, 256
SCHED_BATCH, SCHED_REQUESTS = 1 << 20, 8


def main() -> int:
    import hashlib

    import numpy as np
    import torch

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print(f"mesh_cards: {n_cards} GPU(s) visible; this run needs two or more",
              file=sys.stderr)
        return 2
    from ..backends import get_backend
    from ..backends.cuda_backend import CudaBackend, CudaMeshBackend
    from ..models.registry import get_hash_model
    from ..ops import _build
    from ..ops.hash_cuda import KERNELS, LAUNCHES, hash_search
    from ..ops.operands import u32_value
    from ..ops.packing import build_tail_spec
    from ..ops.search_step import SENTINEL, MeshOrigin, plain_mesh_search, step_operands
    from ..parallel import mesh_search
    from ..parallel.partition import thread_bytes, worker_bits
    from ..parallel.search import launch_steps_for
    from ..runtime.metrics import Metrics
    from ..sched import BatchingScheduler

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    # the libraries this run's 4-byte nonces launch (md5's for var_word 1),
    # one nvcc each, all at once
    _build.build([_build.library_key(KERNELS["md5"], 1), KERNELS["sha512"]])
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    first = cards[0]
    mesh = mesh_search.make_mesh(cards)
    md5 = get_hash_model("md5")
    out, failures = {"cards": n_cards, "devices": [str(d) for d in mesh.devices],
                     "nvcc_s": _build.last_build_s}, []

    def solo_secret(model_name, nonce, d, tbs):
        return CudaBackend(hash_model=model_name, device=first).search(nonce, d, tbs)

    # main_launch: a deep hit, in a shard past the first
    budget = CudaBackend(hash_model="md5", device=first).max_launch
    target = MAIN_BATCH // 256
    k = launch_steps_for(4, target, 256, budget)
    n = MAIN_BATCH * k
    for tried in range(1, DEEP_TRIES + 1):
        nonce = bytes([0x6d, 0x63, 0x64, tried - 1])
        spec = build_tail_spec(nonce, 4, md5)
        ops = step_operands(spec, DEEP_DIFFICULTY, md5, 0, 256, first)
        solo = hash_search(md5, ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0, n, 1,
                           device=first)
        torch.cuda.synchronize(first)
        solo = u32_value(solo)
        if solo != SENTINEL and (solo % 256) * n_cards // 256 >= 1:
            break
    else:
        raise AssertionError(f"no nonce of {DEEP_TRIES} has a hit past the first shard")
    step, chunks = mesh_search._cuda_mesh_step_factory(
        nonce, DEEP_DIFFICULTY, 0, 256, md5, mesh, max_launch=budget)(4, b"", target, k)
    got = step(MAIN_CHUNK0)
    torch.cuda.synchronize()
    shards = mesh_search.mesh_shards(0, 256, MAIN_CHUNK0, n_cards, target, k)
    plain = u32_value(plain_mesh_search(ops, spec.tb_loc, spec.chunk_locs, shards,
                                        MeshOrigin(MAIN_CHUNK0, 0, 256), model=md5))
    out["main_launch"] = {"nonce": nonce.hex(), "nonces_tried": tried, "candidates": n,
                          "covered": chunks * 256, "result_device": str(got.device),
                          "mesh": u32_value(got), "solo": solo, "plain": plain,
                          "shard": (solo % 256) * n_cards // 256}
    if not (u32_value(got) == solo == plain and chunks * 256 == n and got.device == first):
        failures.append("main_launch")

    # mine: the backend and search_mesh over every card
    for counter in LAUNCHES.values():
        counter.reset()
    runs = []
    backend = get_backend("pallas-mesh", hash_model="md5")
    if not isinstance(backend, CudaMeshBackend) or backend.mesh.devices != mesh.devices:
        raise AssertionError(f"pallas-mesh resolved to {backend!r} over {backend.mesh}")
    full, nonce = thread_bytes(0, worker_bits(1)), bytes([1, 2, 3, 4])
    runs.append(("get_backend('pallas-mesh')", "md5", nonce, 6, full,
                 backend.search(nonce, 6, full)))
    for model_name, d, tbs in (("md5", 6, full), ("md5", 8, full),
                               ("md5", 6, thread_bytes(2, worker_bits(4))),
                               ("md5", 5, range(10, 12)), ("sha512", 6, full)):
        res = mesh_search.search_mesh(nonce, d, tbs, mesh=mesh, model=get_hash_model(model_name))
        runs.append(("search_mesh", model_name, nonce, d, tbs, res and res.secret))
    launches = {KERNELS[name]: LAUNCHES[f"{KERNELS[name]}_mesh"].value
                for name in ("md5", "sha512")}
    out["mine"] = {"mesh_kernel_launches": launches, "requests": []}
    for how, model_name, nonce_r, d, tbs, secret in runs:
        digest = hashlib.new(model_name, nonce_r + (secret or b"")).hexdigest()
        solo = solo_secret(model_name, nonce_r, d, tbs)
        ok = secret is not None and secret == solo and digest.endswith("0" * d) and \
            secret[0] in tbs
        out["mine"]["requests"].append({"how": how, "model": model_name, "difficulty": d,
                                        "thread_bytes": [min(tbs), max(tbs)],
                                        "secret": secret and secret.hex(), "ok": ok})
        if not ok:
            failures.append(f"mine {how} {model_name} d{d}")
    if min(launches.values()) <= 0:
        failures.append("mine: a mesh kernel was launched no time")

    # sched: the scheduler's mesh lane over every card
    rng = np.random.default_rng(20261017)
    reqs = [(rng.integers(0, 256, size=4, dtype=np.uint8).tobytes(), int(rng.integers(5, 7)))
            for _ in range(SCHED_REQUESTS)]
    m = Metrics()
    eng = BatchingScheduler(hash_model="md5", batch_size=SCHED_BATCH, max_slots=SCHED_REQUESTS,
                            metrics=m, lane="mesh", mesh=mesh)
    results, errors = [None] * len(reqs), []

    def client(i):
        try:
            results[i] = eng.search(reqs[i][0], reqs[i][1], full)
        except Exception as exc:  # surfaced below through errors
            errors.append(f"request {i}: {exc!r}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(len(reqs))]
    t0 = time.monotonic()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        eng.close()
    want = [solo_secret("md5", nonce_r, d, full) for nonce_r, d in reqs]
    out["sched"] = {"requests": len(reqs), "wall_s": time.monotonic() - t0, "errors": errors,
                    "mesh_lane_launches": m.get("sched.lane_launches.mesh"),
                    "secrets_equal_solo": results == want}
    if errors or results != want or not m.get("sched.lane_launches.mesh"):
        failures.append("sched")

    out["ok"] = not failures
    out["failures"] = failures
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
