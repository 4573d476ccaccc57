#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's mining path on one NVIDIA GPU, for every
hash model, each through its own CUDA kernel: md5, sha256, sha256d, sha1,
ripemd160, sha512, sha384, sha3_256, blake2b_256; and the batching
scheduler, through each model's group kernel.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
CUDA kernels from ``distpow_tpu_torch/csrc`` (one nvcc per library, md5's
source once per var_word, all started together), and for each model holds
its kernel against the plain PyTorch version on the card
(``kernel_parity``, md5's at every tail layout it is built for, and
``full_parity`` at the
worker's full launch), mines through ``get_backend("auto", hash_model=...)``
at the worker's full size (batch 2^20, the model's cost-scaled launch)
with the launch counts set to 0 just before and read just after
(``mine``), and times the kernel on the main-path launch and the plain
version on its first sixteenth, where their results must agree (``rate``;
it also gives the timed loop's instructions by pipe and the SM clock
during the timed launches).  The group kernels (the scheduler's search of
a group of slots in one launch): ``group_parity`` holds each against the plain group step
on random slot sets, and ``rate_group`` times one engine launch of 8 slots
(the kernel with CUDA events, the engine's launches by wall clock, the
device's idle share).  md5's phases keep their names
(``kernel_parity``, ``full_parity``, ``mine``, ``cancel``, ``rate``,
``group_parity``, ``rate_group``); the other models' carry the model's
name as a suffix.  Then the scheduler serves concurrent requests through
``BatchingScheduler`` with the counts set to 0 just before and read just
after: ``sched_md5`` (8 requests from 8 threads), ``sched_mixed`` (seven
models in shared launches, and sha512 refused), ``sched_sha512`` and
``sched_sha384`` (the wide kernels as the default model), each secret
checked with hashlib and against the solo backend's; ``sched_cancel``
cancels a request in flight, and times the cancel of a first request made
after ``CudaBackend.warmup`` in a fresh process with a fresh build
directory.  The mesh form of each kernel (one shard's launch of a search
spread over a mesh of devices; logical shards on ``cuda:0`` unless the
machine has more cards): ``mesh_parity`` holds it against the plain mesh
step and against the solo kernel on the same launch (1-8 shards, both
regimes, widths 0-4, both tails); ``mesh_full_parity`` holds it against
the solo kernel at the worker's full launch on 4 shards, first hits deep
in a later shard, and against ``full_parity``'s plain results on the same
nonce and candidates, runs the plain mesh step shard by shard on the
sub-batch of the deepest hit, and times the launch beside the solo
kernel's;
``mine_mesh`` mines through ``get_backend("pallas-mesh")`` and
``search_mesh`` on 4 shards (every model, md5 also on a 4-way split), the
mesh launch counts set to 0 just before and read just after; ``rate_mesh``
times md5's main-path launch on 4 shards against the solo kernel's; and
``sched_mesh`` serves ``sched_md5``'s requests on the scheduler's mesh
lane.  Last, the worker node (``distpow_tpu_torch.nodes.Worker``) over
RPC, with the port's ``RPCServer`` standing in for the coordinator:
``worker_mine`` (after the boot warm-up, the reference demo's four Mines
and a difficulty-8 one, each secret checked with hashlib and against the
direct backend, the worker's actions and nil ACK, the kernel's launches,
the device ms of the launches whose results were read against the wall
ms from Mine to Result, and no library built after warm-up),
``worker_fanout`` (one request raced by four workers on the card),
``worker_sched`` (eight md5 and sha1 Mines through the batching
scheduler's group kernels, under sync debug mode "error") and
``worker_cli`` (``python -m distpow_tpu_torch.cli.worker`` in a fresh
process whose ``CompilationCacheDir`` holds the ``build`` phase's
libraries: warm-up that builds nothing, one Mine, SIGTERM, exit 0), and
``worker_mesh`` (a Mine through a worker whose backend is the mesh
kernels' on 4 logical shards).  Last, ``mesh_procs``: the mesh across
processes, two ranks of ``python -m distpow_tpu_torch.tools.mesh_procs``
with two logical shards of the card each in a gloo group (and an NCCL
group of a card per rank where two or more cards are visible), md5 and
sha3_256 serial and persistent at the main-path launch on
``full_parity``'s nonce, whose first hit lies on rank 1's shards: both
ranks report the one-process mesh's and the plain version's index.
``native`` builds the port's C++ CPU miner with g++, holds its
single-thread secrets to the python backend's for every model and md5's to
the CUDA backend's, and times md5 on the host's cores beside the card.
``demo`` runs the reference demo with every process the port's
(``config_gen``, the tracing server, the coordinator, four workers on the
card, the demo client, then the client again and four requests one at a
time): the secrets checked with hashlib, ``trace_check`` on the logs, the
workers' ``Stats`` (the card, the kernels' launches), and the card's CUDA
contexts (the workers' and no other process's); after its sequential
requests the observability and load CLIs run against the stack, each a
fresh process that must not map libcuda (``observe_stack``: ``stats`` of
each node and the cluster's OpenMetrics, parsed; ``slo`` green;
``forensics`` of the slowest trace, with spans of the coordinator and a
worker; ``soak --addr`` the coordinator, green).  ``load`` boots the load
harness's ``InProcCluster`` of four workers on the card in this process,
runs ``run_load_slo`` and a compressed ``run_soak`` on it (every secret
checked with hashlib, no errors, both verdicts green, md5's solo and
persistent kernels launched), then ``demo``'s requests.  ``lock_audit``
runs the port's runtime lock-order audit over the same cluster in a fresh
process (``python -m distpow_tpu_torch.tools.lock_audit``: the audit
installed before the port is imported, a short ``run_load_slo``, then
``demo``'s requests): no observed inversion, md5's persistent kernel
launched, the sites held longest.  ``lint`` runs ``python -m
distpow_tpu_torch.cli.lint --json`` in a fresh process: exit 0, no
finding, neither ``torch`` nor ``libcuda.so`` loaded.  The
persistent loop (the reference worker's default ``SearchLoop``):
``persistent_parity`` holds each model's persistent kernel, solo and on 4
logical shards, against the plain persistent step on both of its words
(hits in the first, a middle and no segment, widths 0-4, both tails, a
set stop flag) and at the main path's launch; ``mine`` serves every request under both
loops (``persistent`` and ``serial``) with the same secrets, ``rate``
times the persistent launch without a hit beside the solo one, ``cancel``
runs under both loops, and ``worker_mine`` serves the reference's
defaults (persistent) and one serial Mine, the device time of the
launches behind the hit's, and a ``torch.profiler`` record of two
difficulty-5 Mines.  Every phase prints one
JSON line; the line before the card's name lists every kernel; the last
line, printed only when every phase passed, is ``{"ok": true, "device":
{...}}``.  It imports neither JAX nor the JAX package.  Long outputs (the
nvcc log, each kernel's SASS, gzipped) go to ``chiprun_out/``.

Exits non-zero, without the result line, when no GPU is available, when the
port's package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import collections
import concurrent.futures
import functools
import gzip
import hashlib
import json
import multiprocessing
import os
import queue
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

MODELS = ("md5", "sha256", "sha256d", "sha1", "ripemd160", "sha512", "sha384", "sha3_256",
          "blake2b_256")
# the TPU code every group kernel replaces
REPLACES_GROUP = "distpow_tpu/sched/lanes.py:143"
# the TPU code every mesh kernel replaces
REPLACES_MESH = "distpow_tpu/parallel/mesh_search.py:178 _dyn_pallas_mesh_step"
# model -> the TPU code its kernel replaces (distpow_tpu/ops/md5_pallas.py:
# the scaffold _dyn_pallas_step, ported with md5, and each model's tile)
REPLACES = {"md5": "distpow_tpu/ops/md5_pallas.py:698",
            "sha256": "distpow_tpu/ops/md5_pallas.py:247",
            "sha256d": "distpow_tpu/ops/md5_pallas.py:304",
            "sha1": "distpow_tpu/ops/md5_pallas.py:325",
            "ripemd160": "distpow_tpu/ops/md5_pallas.py:391",
            "sha512": "distpow_tpu/ops/md5_pallas.py:605",
            "sha384": "distpow_tpu/ops/md5_pallas.py:609",
            "sha3_256": "distpow_tpu/ops/md5_pallas.py:528",
            "blake2b_256": "distpow_tpu/ops/md5_pallas.py:615"}

# Parity grid (phase kernel_parity): every tail shape, width, mask bucket,
# partition kind and launch multiplier the plain step handles.  md5's grid;
# the other models run a reduced grid of difficulties and nonce lengths
# around their own block size: one- and two-block tails, and runs that
# cross the block boundary.
NONCE_LENS = (1, 4, 13, 55, 56, 63, 64, 100)
DIFFICULTIES = (0, 1, 2, 5, 8, 9, 12, 16)
NONCE_LENS_REDUCED = {"sha512": (1, 13, 111, 120, 127, 130, 250),
                      "sha384": (1, 13, 111, 120, 127, 130, 250),
                      "sha3_256": (1, 13, 130, 133, 135, 140, 280),
                      "blake2b_256": (1, 13, 120, 124, 126, 127, 129, 260)}
NONCE_LENS_64 = (1, 13, 55, 56, 63, 100)  # the 64-byte-block models
DIFFICULTIES_REDUCED = (0, 2, 5, 9)
# (tb_lo, tbc, chunks per sub-batch): sub-batches of at most 2^14, so
# batch * launch_steps stays within 2^16
PARTITIONS = ((0, 256, 64), (64, 64, 256), (7, 1, 4096), (16, 96, 128))
LAUNCH_STEPS = (1, 3)

# Hopper issues at most one warp instruction per clock from each of an SM's
# four schedulers: 4 x 32 = 128 thread results per clock per SM.  The bound
# (needed_ops) is taken at that rate.  The integer pipes are narrower.  The
# ALU pipe retires 64 thread results per clock per SM (LOP3, SHF and IADD3
# measured by python3 -m distpow_tpu_torch.tools.pipe_rates; LEA, ISETP,
# SEL, PRMT and MOV issue there too).  IMAD and VIADD go to the FMA pipe,
# IMAD at another 64 per clock, so a loop that mixes the two pipes can issue
# up to 128.  A loop of ALU-pipe instructions alone issues at 64 per clock
# at best; md5's measured 76 because ptxas put its 61 constant adds (VIADD)
# on the FMA pipe.  IMAD.HI and IMAD.WIDE take two of the FMA pipe's slots
# (FMA_TWO_SLOTS, by the same probes), so a loop's FMA-pipe time counts
# them twice.
ISSUED_RESULTS_PER_CLOCK_PER_SM = 128
ALU_PIPE_RESULTS_PER_CLOCK_PER_SM = 64
FMA_PIPE_SLOTS_PER_CLOCK_PER_SM = 64
ALU_PIPE = frozenset({"LOP3", "SHF", "IADD3", "LEA", "ISETP", "SEL", "PRMT", "MOV"})
FMA_PIPE = frozenset({"IMAD", "VIADD"})
FMA_TWO_SLOTS = frozenset({"IMAD.HI", "IMAD.WIDE"})

# The main path's launch: batch 2^20 x k sub-batches of a width-4 segment,
# k from the model's cost-scaled dispatch budget (1024 for md5)
MAIN_BATCH, MAIN_CHUNK0 = 1 << 20, 1 << 24

RATE_LAUNCHES = 10
# rate: the plain version runs the launch's first 1/RATE_PLAIN_PART
# sub-batches (at least one)
RATE_PLAIN_PART = 16
# kernel_parity: candidates the plain version evaluates in one call
JUDGE_CANDIDATES = 1 << 21
RATE_DIFFICULTY = 16
# full_parity: nonces tried for a difficulty-7 first hit deep in the launch
FULL_PARITY_TRIES = 256
# mine: difficulties solved per model; the first is also held to python_search
MINE_DIFFICULTIES = {m: (5, 6, 8) if m == "md5" else (3, 6, 8) for m in MODELS}
# group_parity: slots per launch, power-of-two runs (log2), candidates per
# slot (log2), and the width cases: 0-4, and 5 (a width-4 run below one
# fixed high byte)
GROUP_SLOTS = (1, 3, 8)
GROUP_LOG_TBC = (0, 1, 4, 8)
GROUP_LOG_BATCH = (12, 13, 14, 15, 16)
GROUP_WIDTHS = (0, 1, 2, 3, 4, 5)
# the scheduler's serving size: the worker's default BatchSize and SchedMaxSlots
SCHED_BATCH, SCHED_SLOTS = 1 << 20, 8
# group_full_parity: per tail layout, slots drawn (in launches of 8) to find
# first hits deep in the range and grid, the deep ones each final launch
# holds at least, and the mask bits per slot (about one hit per 2^20)
GROUP_POOL_SLOTS = 128
GROUP_DEEP_SLOTS = 3
GROUP_MASK_BITS = 20
# rate_group: seconds the engine runs 8 difficulty-16 slots
RATE_GROUP_WINDOW_S = 2.0
SCHED_SEED = 20261017
# mesh_parity: (shards, tb_lo, tbc) of the cases, each at every width: 1-8
# shards and 3 on the full run (thread-byte split, or chunk split where
# the shards do not divide it), 8 shards on runs of 64, 3 and 4 (chunk
# split) and of 96 (thread-byte split into runs of 12)
MESH_LAYOUTS = ((1, 0, 256), (2, 0, 256), (4, 0, 256), (8, 0, 256), (3, 0, 256),
                (8, 64, 64), (8, 5, 3), (8, 16, 4), (8, 16, 96))
MESH_DIFFICULTIES = (2, 3, 4, 0, 5)
# candidates a mesh_parity case covers at most (2^14 a launch, 3 launch steps)
MESH_CASE_CANDIDATES = 1 << 14
# mesh_full_parity: launches timed of the main-path mesh and solo launches
MESH_RATE_LAUNCHES = 5
# persistent_parity: (tb_lo, tbc, chunks a segment) of the cases, about
# 2^12 candidates a segment; the segments of a launch; the difficulties: a
# hit in the first segment, in a later one (about 1 in 4096), none
PERSISTENT_PARTITIONS = ((0, 256, 16), (16, 96, 40), (5, 3, 1300))
PERSISTENT_SEGMENTS = (4, 1)
PERSISTENT_DIFFICULTIES = (1, 3, 8)
# its mesh cases on 4 logical shards: (tb_lo, tbc) of a thread-byte split
# and of two chunk splits, at widths 1 and 4
PERSISTENT_MESH_RUNS = ((0, 256), (16, 4), (5, 3))
# launches timed of the main-path persistent launch (at the deep hit, and
# without a hit in rate*)
PERSISTENT_RATE_LAUNCHES = 5
# mine_mesh, mesh_full_parity, rate_mesh, sched_mesh: shards of search_mesh
MESH_SHARDS = 4
# mesh_procs: the ranks of the group and each rank's logical shards of its
# card (MESH_SHARDS in all), the models of the main-path legs, and seconds
# a child may take
MESH_PROCS_RANKS, MESH_PROCS_LOCAL = 2, 2
MESH_PROCS_MODELS = ("md5", "sha3_256")
MESH_PROCS_TIMEOUT_S = 300
# sched_mixed: md5 (the default) and the models it admits besides
MIXED_MODELS = ("md5", "sha256", "sha256d", "sha1", "ripemd160", "sha3_256", "blake2b_256")

# worker_*: the reference demo's requests (distpow_tpu/cli/client.py at its
# default difficulty 5: the first nonce and the repeat at 5 + 2), then one
# difficulty-8 Mine; worker_fanout's workers (worker_bits 2) and request;
# worker_sched's requests per model and their seed
WORKER_DEMO = ((bytes([1, 2, 3, 4]), 7), (bytes([5, 6, 7, 8]), 5), (bytes([2, 2, 2, 2]), 5),
               (bytes([2, 2, 2, 2]), 7), (bytes([9, 8, 7, 6]), 8))
WORKER_FANOUT, WORKER_FANOUT_REQUEST = 4, (bytes([4, 3, 2, 1]), 8)
WORKER_SCHED_MODELS, WORKER_SCHED_PER_MODEL = ("md5", "sha1"), 4
# the worker's configuration in every worker_* phase (the reference's
# defaults but the hang timeout)
WORKER_CONFIG = {"Backend": "auto", "HashModel": "md5", "BatchSize": 1 << 20,
                 "WarmupNonceLens": [2, 4], "WarmupWidths": [0, 1, 2, 3, 4],
                 "DeviceHangTimeoutS": 30.0}

# native: the port's C++ CPU miner (g++).  Each model's single-thread
# secret on nonce 01020304 at NATIVE_DIFFICULTY over the whole partition is
# held against the python backend's, md5's at NATIVE_CUDA_DIFFICULTY
# against the CUDA backend's, and md5 is timed over NATIVE_RATE_CANDIDATES
# candidates (256 thread bytes x 2^18 chunks of width 4) at a difficulty no
# candidate meets, on all cores and on one
NATIVE_DIFFICULTY, NATIVE_CUDA_DIFFICULTY = 4, 6
NATIVE_RATE_CANDIDATES = 1 << 26
# demo: the reference's process surface with every process the port's
# (config_gen, tracing_server, coordinator, four workers on the card, the
# demo client at its default difficulty: 5, the repeated nonce at 7)
DEMO_TIMEOUT_S = 300
DEMO_SEQUENTIAL = ((bytes([1, 2, 3, 5]), 5), (bytes([1, 2, 3, 6]), 7), (bytes([5, 6, 7, 9]), 5),
                   (bytes([2, 2, 2, 3]), 7))
# Each demo worker is the worker CLI's main in a fresh process, with each
# kernel launch of the CUDA backend timed by a CUDA event pair (as
# worker_mine's LaunchTimer does in process); each launch's host time and
# device ms go to the file named by the first argument when the worker has
# stopped.  After the demo client, the client runs again (every request a
# cache hit), then DEMO_SEQUENTIAL's requests go one at a time through the
# port's Client in this process.
DEMO_WORKER_SHIM = """
import json, sys, time
import torch
from distpow_tpu_torch.backends import cuda_backend
from distpow_tpu_torch.cli import worker

pairs = []

def timed(orig):
    def launch(model, ops, *args, **kwargs):
        stream = torch.cuda.current_stream(ops.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = orig(model, ops, *args, **kwargs)
        end.record(stream)
        pairs.append((time.time(), start, end))
        return out
    return launch

for name in ("hash_search", "hash_persistent_search"):
    setattr(cuda_backend, name, timed(getattr(cuda_backend, name)))
worker.main(sys.argv[2:])
for _, _, end in pairs:
    end.synchronize()
with open(sys.argv[1], "w") as fh:
    json.dump([[t, start.elapsed_time(end)] for t, start, end in pairs], fh)
"""
# The demo client is the client CLI's main in a fresh process, which then
# prints DEMO_CLIENT_DONE and stays up until its standard input closes, so
# that its CUDA mappings and the card's contexts are read while it lives.
DEMO_CLIENT_DONE = "demo client done"
DEMO_CLIENT_SHIM = f"""
import sys
from distpow_tpu_torch.cli import client

try:
    client.main(sys.argv[1:])
finally:
    print({DEMO_CLIENT_DONE!r}, flush=True)
    sys.stdin.read()
"""

# demo's observability leg: after the sequential requests, the device-less
# CLIs of the observability and load planes run against the demo's
# coordinator and workers, each a fresh process running its CLI's main in
# DEMO_CLI_SHIM (the module and its arguments), which prints DEMO_CLI_DONE
# with the exit code and stays up until its standard input closes, so that
# its maps are read while it lives.  The soak at its stock mix and shape,
# DEMO_SOAK_MINUTES of wall clock, attached to the coordinator.
DEMO_CLI_DONE = "demo cli done"
DEMO_CLI_SHIM = f"""
import importlib, sys
rc = importlib.import_module(sys.argv[1]).main(sys.argv[2:])
print({DEMO_CLI_DONE!r}, rc or 0, flush=True)
sys.stdin.read()
"""
# lint: DEMO_CLI_SHIM that also prints, before its done line, the modules of
# torch, JAX or the JAX package the CLI's process loaded
LINT_SHIM = f"""
import importlib, json, sys
rc = importlib.import_module(sys.argv[1]).main(sys.argv[2:])
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'distpow_tpu'))))
print({DEMO_CLI_DONE!r}, rc or 0, flush=True)
sys.stdin.read()
"""
DEMO_SOAK_MINUTES = 0.25
SLO_CONFIG = os.path.join(HERE, "config", "slo.json")
# load: the harness's in-process cluster (four workers on the card in this
# process, the harness's own config) under run_load_slo at LOAD_MIX, then a
# compressed run_soak of LOAD_SOAK_MINUTES on the same cluster (the soak
# CLI's stock shape, LOAD_MIX's keys and difficulties, its own seed)
LOAD_WORKERS = 4
LOAD_MIX = {"rate_hz": 10.0, "duration_s": 20.0, "n_keys": 64, "zipf_s": 1.1, "nonce_len": 4,
            "difficulties": ((5, 0.5), (7, 0.5))}
LOAD_SOAK_MINUTES, LOAD_SOAK_SEED = 0.25, 1805
# lock_audit: the runtime lock-order audit over the same cluster in a fresh
# process (python -m distpow_tpu_torch.tools.lock_audit): run_load_slo at
# LOAD_MIX (the tool's own mix) for LOCK_AUDIT_LOAD_S, then demo's requests
LOCK_AUDIT_LOAD_S = 5.0


def maps_libcuda(pid):
    """Whether process ``pid`` has the CUDA driver library mapped (None when
    its maps cannot be read)."""
    try:
        with open(f"/proc/{pid}/maps") as fh:
            return "libcuda.so" in fh.read()
    except OSError:
        return None


def run_cli(module, args, cwd, env, log_path, timeout, shim=None):
    """``module``'s main with ``args`` in a fresh process (``shim``, by
    default DEMO_CLI_SHIM):
    its exit code, its standard output before the done line, and whether it
    mapped libcuda, read while it waits on its standard input."""
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", shim or DEMO_CLI_SHIM, module, *args],
                                cwd=cwd,
                                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=log, text=True)
    lines, done = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith(DEMO_CLI_DONE):
                done.set()
        done.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        finished = done.wait(timeout)
        mapped = maps_libcuda(proc.pid)
        proc.stdin.close()
        proc.wait(timeout=60)
        reader.join(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if not finished or not lines or not lines[-1].startswith(DEMO_CLI_DONE):
        with open(log_path) as fh:
            raise AssertionError(f"{module} {args}: no done line (exit {proc.returncode}): "
                                 f"{''.join(lines)[-2000:]} {fh.read()[-2000:]}")
    return int(lines[-1].split()[-1]), "".join(lines[:-1]), mapped


PROM_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)'
                         r'( # \{trace_id="\d+"\} \S+ \S+)?$')


def check_prometheus(text, openmetrics=True):
    """Parse a Prometheus (or, with ``openmetrics``, an OpenMetrics) text
    exposition: every sample line well formed with a number, each histogram's
    buckets cumulative and its ``+Inf`` bucket equal to its ``_count``, the
    OpenMetrics form ending in ``# EOF``.  Returns the families by type."""
    lines = text.rstrip("\n").split("\n")
    if openmetrics and lines[-1] != "# EOF":
        raise AssertionError(f"no # EOF: {lines[-3:]}")
    types, samples = {}, {}
    for line in lines:
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types[name] = kind
        elif line.startswith("#"):
            continue
        else:
            m = PROM_SAMPLE.match(line)
            if m is None:
                raise AssertionError(f"malformed sample line {line!r}")
            float(m[3])
            samples.setdefault(m[1], []).append((m[2] or "", float(m[3])))
    for name, kind in types.items():
        if kind != "histogram":
            continue
        buckets = samples[f"{name}_bucket"]
        counts = [v for _, v in buckets]
        if counts != sorted(counts) or buckets[-1][0] != '{le="+Inf"}' or \
                buckets[-1][1] != samples[f"{name}_count"][0][1]:
            raise AssertionError(f"{name}: buckets {buckets}, count {samples[f'{name}_count']}")
    return {k: sorted(n for n, t in types.items() if t == k) for k in set(types.values())}


def observe_stack(coord_addr, worker_addrs, out_dir, env, device="cuda", launched=True,
                  soak_minutes=DEMO_SOAK_MINUTES, timeout=DEMO_TIMEOUT_S):
    """The observability and load CLIs against a running stack: ``cli.stats``
    of each node (each worker's on ``device``, counting kernel launches where
    ``launched``), ``cli.stats --cluster --prom --openmetrics`` over all of
    them (parsed), ``cli.slo`` over all of them (exit 0), ``cli.forensics`` of
    the slowest trace (spans of the coordinator and of a worker), and
    ``cli.soak --addr`` the coordinator at its stock mix (exit 0).  None of
    their processes may map libcuda."""
    addrs = [coord_addr, *worker_addrs]
    flags = [a for addr in addrs for a in ("--addr", addr)]
    out, maps, walls = {}, {}, {}

    def cli(name, module, *args, want_rc=0):
        t0 = time.monotonic()
        rc, text, maps[name] = run_cli(f"distpow_tpu_torch.cli.{module}", args, HERE, env,
                                       os.path.join(out_dir, f"{name}.log"), timeout)
        walls[name] = time.monotonic() - t0
        if rc != want_rc:
            raise AssertionError(f"{name} exited {rc}: {text[-3000:]}")
        return text

    stats = {name: json.loads(cli(f"stats_{name}", "stats", "--addr", addr))
             for name, addr in (("coordinator", coord_addr),
                                *((f"worker{i + 1}", a) for i, a in enumerate(worker_addrs)))}
    if stats["coordinator"].get("role") != "coordinator":
        raise AssertionError(f"coordinator stats: {stats['coordinator'].get('role')}")
    for name, snap in stats.items():
        if name == "coordinator":
            continue
        n = sum((snap.get("kernel_launches") or {}).values())
        if not str(snap.get("device", "")).startswith(device) or (launched and n <= 0):
            raise AssertionError(f"{name} stats: device {snap.get('device')}, kernel "
                                 f"launches {snap.get('kernel_launches')}")
    out["stats"] = {name: {"role": snap.get("role"), "device": snap.get("device"),
                           "kernel_launches": snap.get("kernel_launches")}
                    for name, snap in stats.items()}
    prom = cli("stats_cluster_prom", "stats", "--cluster", *flags, "--prom", "--openmetrics")
    families = check_prometheus(prom)
    if "distpow_coord_mine_s_miss" not in families.get("histogram", []):
        raise AssertionError(f"cluster exposition families: {families}")
    out["prometheus"] = {"lines": prom.count("\n"),
                         "families": {k: len(v) for k, v in families.items()}}
    verdict = json.loads(cli("slo", "slo", "--config", SLO_CONFIG, *flags, "--json"))
    out["slo"] = {"status": verdict["status"],
                  "objectives": {f"{o['name']}[{o.get('model', '')}]": o["status"]
                                 for o in verdict["objectives"]}}
    timeline = json.loads(cli("forensics", "forensics", *flags, "--json"))
    nodes = timeline.get("nodes") or []
    if "coordinator" not in nodes or not any(n.startswith("worker") for n in nodes):
        raise AssertionError(f"forensics: trace {timeline.get('trace_id')} spans of {nodes}")
    out["forensics"] = {"trace_id": timeline["trace_id"], "nodes": nodes,
                        "spans": len(timeline["spans"]), "wall_s": timeline.get("wall_s"),
                        "slowest": (timeline.get("slowest") or {}).get("name")}
    soak = cli("soak", "soak", "--config", SLO_CONFIG, "--addr", coord_addr,
               "--minutes", str(soak_minutes))
    out["soak"] = soak.strip().splitlines()
    if any(maps[name] is not False for name in maps):
        raise AssertionError(f"libcuda mapped: {maps}")
    out["libcuda_mapped"], out["wall_s"] = maps, walls
    return out


# sched_cancel: run in a fresh process with a fresh build directory
# (DISTPOW_TORCH_BUILD_DIR): CudaBackend.warmup builds and loads md5's
# library for the layouts it serves (4-byte nonces: var_word 1) and
# launches each layout once, then a difficulty-16 request is
# cancelled 0.5 s after it starts; prints one JSON line.
WARM_CANCEL = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from distpow_tpu_torch.backends.cuda_backend import CudaBackend
from distpow_tpu_torch.ops import _build
empty = not (os.path.isdir(_build.BUILD_DIR) and os.listdir(_build.BUILD_DIR))
t0 = time.monotonic()
backend = CudaBackend(hash_model="md5")
backend.warmup([4], [0, 1, 2, 3, 4])
warmup_s, build_s = time.monotonic() - t0, _build.last_build_s
flagged = []
t1 = time.monotonic()
def cancel_check():
    if time.monotonic() - t1 > 0.5:
        flagged.append(time.monotonic())
        return True
    return False
res = backend.search(bytes([9, 9, 9, 9]), 16, range(256), cancel_check)
t_ret = time.monotonic()
torch.cuda.synchronize()
print(json.dumps({"build_dir_was_empty": empty, "warmup_s": warmup_s, "build_s": build_s,
                  "returned": None if res is None else res.hex(),
                  "time_to_cancel_s": t_ret - t1 - 0.5, "poll_to_return_s": t_ret - flagged[0],
                  "return_s": t_ret - t1}))
"""
# message word of MD5 round i
MD5_G = tuple(i if i < 16 else (5 * i + 1) % 16 if i < 32 else (3 * i + 5) % 16 if i < 48
              else (7 * i) % 16 for i in range(64))
# message word of RIPEMD-160 round i, left and right line
RMD_RL = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
          7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
          3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
          1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
          4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13)
RMD_RR = (5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
          6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
          15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
          8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
          12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def suffix(model_name: str) -> str:
    """Phase-name suffix: none for md5 (the first slice's names), else _<model>."""
    return "" if model_name == "md5" else f"_{model_name}"


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


# A kernel specialization's key in its mangled name:
# (resident_)hash_search_kernel<Hash, MW, NB, POW2>; MW has two digits for
# the full digests of sha512 (16) and sha384 (12)
KERNEL_KEY = r"_search_kernelI(?:N\w*?E)?Li(\d+)ELi(\d)ELb(\d)E"


# A group kernel's key in its mangled name:
# (resident_)hash_group_search_kernel<Hash, NB>
GROUP_KEY = r"group_search_kernelI(?:N\w*?E)?Li(\d)EE"

# A mesh kernel's key: (resident_)hash_mesh_kernel<Hash, MW, NB, POW2>
MESH_KEY = r"_mesh_kernelI(?:N\w*?E)?Li(\d+)ELi(\d)ELb(\d)E"

# The persistent forms' keys: (resident_)hash_persistent_kernel and
# (resident_)hash_mesh_persistent_kernel, <Hash, MW, NB, POW2>
PERSISTENT_KEY = r"hash_persistent_kernelI(?:N\w*?E)?Li(\d+)ELi(\d)ELb(\d)E"
MESH_PERSISTENT_KEY = r"mesh_persistent_kernelI(?:N\w*?E)?Li(\d+)ELi(\d)ELb(\d)E"

# md5's kernels are built per tail layout: the hash Md5<VW> (or a round
# variant's Md5As<VW, ...>) carries the run's first message word, which
# ends each of its keys: (MW, NB, POW2, VW), the group's (NB, VW)
VAR_WORD_KEY = r"\dMd5\w*?ILi(\d+)E"
KEYED_MODELS = frozenset({"md5"})
# the var_word of the main path's launch (nonce 01020304, width 4)
MAIN_VAR_WORD = 1

PTXAS_FUNCTION = (r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes "
                  r"spill stores, (\d+) bytes spill loads\n[^\n]*Used (\d+) registers")


def name_key(name: str, key: str):
    """A kernel's specialization from its mangled name, or None if the name
    does not match ``key``: the ints, bools as such, and the var_word of a
    kernel built for one."""
    m = re.search(key, name)
    if not m:
        return None
    parts = tuple(int(g) for g in m.groups())
    if len(parts) == 3:
        parts = (parts[0], parts[1], parts[2] == 1)
    vw = re.search(VAR_WORD_KEY, name)
    return parts + (int(vw.group(1)),) if vw else parts


def timed_key(model_name: str, mw: int = 2, n_blocks: int = 1, var_word: int = MAIN_VAR_WORD):
    """The key of a model's solo (or mesh) kernel at mask words ``mw`` and
    a power-of-two run of an ``n_blocks``-block tail at ``var_word``: the
    timed one by default (mask words 2, one block, the main path's run)."""
    key = (mw, n_blocks, True)
    return key + (var_word,) if model_name in KEYED_MODELS else key


def group_key(model_name: str, n_blocks: int, var_word: int = MAIN_VAR_WORD):
    """The key of a model's group kernel for that tail."""
    return (n_blocks, var_word) if model_name in KEYED_MODELS else n_blocks


def parse_group_ptxas(log: str):
    """Per group kernel specialization ``n_blocks`` (``(n_blocks,
    var_word)`` for md5's): registers and spill bytes, from nvcc's ``-Xptxas
    -v`` output."""
    out = {}
    for name, _, st, ld, regs in re.findall(PTXAS_FUNCTION, log):
        key = name_key(name, GROUP_KEY)
        if key is not None:
            out[key[0] if len(key) == 1 else key] = {"registers": int(regs),
                                                     "spill_bytes": int(st) + int(ld)}
    return out


def group_sass_loops(sass: str, path: bool = False):
    """Per group kernel specialization (``parse_group_ptxas``'s keys): its
    loop's opcodes, as ``spec_sass_loops`` gives the solo kernels'."""
    return by_group(sass_loops(sass, path))


def by_group(loops):
    """``sass_loops``'s result, the group kernels' by specialization."""
    out = {}
    for name, body in loops.items():
        key = name_key(name, GROUP_KEY)
        if key is not None:
            out[key[0] if len(key) == 1 else key] = body
    return out


def spec_label(key) -> str:
    mw, nb, pow2, *vw = key
    return f"mw{mw}_nb{nb}_{'pow2' if pow2 else 'div'}" + "".join(f"_vw{v}" for v in vw)


def parse_ptxas(log: str, key: str = KERNEL_KEY):
    """Per specialization ``(mask_words, n_blocks, pow2)`` (and the var_word
    of md5's): registers and spill bytes, from nvcc's ``-Xptxas -v``
    output; ``key`` is the solo kernels' name pattern, or ``MESH_KEY``."""
    out = {}
    for name, _, st, ld, regs in re.findall(PTXAS_FUNCTION, log):
        spec = name_key(name, key)
        if spec is not None:
            out[spec] = {"registers": int(regs), "spill_bytes": int(st) + int(ld)}
    return out


def sass_loops(sass: str, path: bool = False):
    """Per function of a ``cuobjdump -sass`` listing, by its mangled name:
    the opcodes of its widest loop's body, counted between the widest
    backward branch and its target, NOPs excluded, each opcode with its
    modifiers (``IMAD.HI.U32``), as a Counter (its total is the body's
    length).  With ``path``, only the instructions one iteration issues on
    the path that takes no conditional branch, follows every unconditional
    forward one and enters a jump table (``BRX``) at its first case: a
    ``switch`` in the body counts one case, not all of them."""
    out = {}
    parts = re.split(r"\n\s*Function : ", sass)
    for part in parts[1:]:
        name = part.split("\n", 1)[0].strip()
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

        def target(text):
            br = re.search(r"\bBRA\s+`?\(?(0x[0-9a-f]+|\.L_x_\d+)", text)
            if not br:
                return None
            tgt = br.group(1)
            return int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)

        best = None
        for addr, text in instrs:
            tgt = target(text)
            if tgt is not None and tgt < addr and (best is None or addr - tgt > best[1] - best[0]):
                best = (tgt, addr)
        if best is None:
            continue
        body = [(a, t) for a, t in instrs if best[0] <= a <= best[1]]
        if path:
            at = {a: i for i, (a, _) in enumerate(body)}
            walk, i = [], 0
            while i < len(body) and len(walk) < len(body):
                a, t = body[i]
                walk.append((a, t))
                tgt = None if t.startswith("@") else target(t)
                i = at[tgt] if tgt is not None and a < tgt <= best[1] else i + 1
            body = walk
        ops = [re.sub(r"^@!?U?P\w+\s+", "", t) for _, t in body]
        out[name] = collections.Counter(t.split()[0] for t in ops if not t.startswith("NOP"))
    return out


def spec_sass_loops(sass: str, path: bool = False, key: str = KERNEL_KEY):
    """Per kernel specialization ``(mask_words, n_blocks, pow2)`` (and the
    var_word of md5's): the
    opcodes of its grid-stride loop body (one candidate; the loop is not
    unrolled), each with its modifiers, as a Counter; with ``path``, those
    one candidate issues (``sass_loops``).  ``key``: the solo kernels, or
    ``MESH_KEY``."""
    return by_spec(sass_loops(sass, path), key)


def by_spec(loops, key: str = KERNEL_KEY):
    """``sass_loops``'s result, the kernels of name pattern ``key`` by
    specialization ``(mask_words, n_blocks, pow2)`` (and var_word)."""
    out = {}
    for name, body in loops.items():
        spec = name_key(name, key)
        if spec is not None:
            out[spec] = body
    return out


def listing_loops(cuobjdump: str, library: str, listing_gz: str):
    """A library's ``cuobjdump -sass`` listing, kept gzipped at
    ``listing_gz``, parsed: ``(sass_loops, sass_loops(path=True))`` of every
    function.  Run in a worker process, one a library."""
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    with gzip.open(listing_gz, "wt") as fh:
        fh.write(sass)
    return sass_loops(sass), sass_loops(sass, path=True)


def opcode_kind(op: str) -> str:
    """A SASS opcode by its kind: the base opcode, and the form of an IMAD
    (``IMAD.HI.U32`` is ``IMAD.HI``, ``IMAD.U32`` is ``IMAD``)."""
    parts = op.split(".")
    if parts[0] == "IMAD" and len(parts) > 1 and parts[1] in ("HI", "SHL", "MOV", "IADD",
                                                               "WIDE", "X"):
        return ".".join(parts[:2])
    return parts[0]


def pipe_split(ops) -> dict:
    """Instructions of a loop body by the pipe they issue to, and the FMA
    pipe's slots they take (``FMA_TWO_SLOTS`` count two; without modifiers
    every FMA-pipe opcode counts one)."""
    alu = sum(c for op, c in ops.items() if op.split(".")[0] in ALU_PIPE)
    fma = sum(c for op, c in ops.items() if op.split(".")[0] in FMA_PIPE)
    slots = fma + sum(c for op, c in ops.items() if opcode_kind(op) in FMA_TWO_SLOTS)
    return {"alu": alu, "fma": fma, "fma_slots": slots, "other": sum(ops.values()) - alu - fma}


def pipe_ms(pipes, n: int, clocks_per_s: float) -> dict:
    """The least ms each integer pipe needs for ``n`` hashes of a loop split
    by ``pipe_split``: its ALU-pipe instructions at that pipe's rate and its
    FMA-pipe slots at that pipe's."""
    return {"alu_pipe_ms": n * pipes["alu"] / (ALU_PIPE_RESULTS_PER_CLOCK_PER_SM *
                                               clocks_per_s) * 1e3,
            "fma_pipe_ms": n * pipes["fma_slots"] / (FMA_PIPE_SLOTS_PER_CLOCK_PER_SM *
                                                     clocks_per_s) * 1e3}


class SmClock(threading.Thread):
    """The SM clock in MHz, read by one ``nvidia-smi`` call after another
    while a ``with`` block runs; ``mhz`` keeps the readings whose call
    overlapped the block."""

    def __init__(self):
        super().__init__(daemon=True)
        self.done = threading.Event()
        self.readings = []
        self.mhz = []

    def run(self):
        while not self.done.is_set():
            t0 = time.monotonic()
            value = nvidia_smi("clocks.sm").split()[0]
            self.readings.append((t0, time.monotonic(), float(value)))

    def __enter__(self):
        self.start()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        self.done.set()
        self.join(timeout=120)
        self.mhz = [v for a, b, v in self.readings if b > self.t0 and a < t1]
        return False


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


# The counts below follow md5_needed_ops' conventions (a rotate = 1 SHF, a
# logic function of up to three inputs = 1 LOP3, a sum of up to three terms
# = 1 IADD3, a rotate-then-add = 1 LEA.HI), and track which values vary per
# candidate: a value computed only from the launch's operands (the prefix
# state, the constant message words) is computed once per launch and costs
# nothing per candidate, and the constants of a sum fold into one term.
# That lets the rounds before the first variable message word, and
# schedule words made of constant words only, cost nothing.  The 64-bit
# hashes count in the same 32-bit instructions: a 64-bit sum of up to three
# terms is 2 (IADD3 with its carry out, IADD3.X), a 64-bit logic function
# of up to three inputs 2 LOP3, a 64-bit rotate or shift 2 funnel shifts,
# and a rotate by 32 nothing (the halves swap).

def _sum_ops(n_var: int, has_const: bool) -> int:
    """Three-input adds (or XORs) to combine ``n_var`` varying terms and,
    when ``has_const``, one folded constant term."""
    return (n_var + has_const) // 2 if n_var else 0


def _sha2_block_ops(state_var, word_var, rounds: int, live, cost: int):
    """(ops, new state variability) of one SHA-256 (64 rounds of 32-bit
    words, ``cost`` 1) or SHA-512 (80 rounds of 64-bit words, ``cost`` 2)
    compression whose digest words ``live`` are read: the E chain stops at
    the last chain index they read, the A chain where the E chain or they
    need it (the tiles' MAX_E / MAX_A)."""
    need_a = [rounds - 1 - j for j in live if j < 4]
    need_e = [rounds + 3 - j for j in live if j >= 4]
    max_e = max(need_e + need_a)
    max_a = max(need_a + [max_e - 4])
    n, w = 0, list(word_var)
    for i in range(16, max_e + 1):
        terms = (w[i - 2], w[i - 7], w[i - 15], w[i - 16])
        n += cost * (4 * w[i - 2] + 4 * w[i - 15] + _sum_ops(sum(terms), not all(terms)))
        w.append(any(terms))
    A = {-1 - j: state_var[j] for j in range(4)}
    E = {-1 - j: state_var[4 + j] for j in range(4)}
    for r in range(max_e + 1):
        s1, ch = E[r - 1], E[r - 1] or E[r - 2] or E[r - 3]
        n += cost * (4 * s1 + ch)
        t1_var = sum((E[r - 4], s1, ch, w[r]))
        n += cost * _sum_ops(t1_var, True)  # K[r] is the constant term
        E[r] = bool(t1_var) or A[r - 4]
        n += cost * E[r]
        if r <= max_a:
            s0, maj = A[r - 1], A[r - 1] or A[r - 2] or A[r - 3]
            n += cost * (4 * s0 + maj)
            a_var = sum((bool(t1_var), s0, maj))
            n += cost * _sum_ops(a_var, a_var < 3)
            A[r] = bool(a_var)
    out = list(state_var)
    for j in live:
        out[j] = A[rounds - 1 - j] if j < 4 else E[rounds + 3 - j]
        n += cost * out[j]
    return n, out


def _sha256_block_ops(state_var, word_var, mw):
    """(ops, new state variability) of one SHA-256 compression whose ``mw``
    trailing digest words are live (None: the full state)."""
    mw = 8 if mw is None else mw
    return _sha2_block_ops(state_var, word_var, 64, range(8 - mw, 8), 1)


def _sha512_block_ops(state_var, word_var, mw, d32: int):
    """(ops, new 64-bit state variability) of one SHA-512 compression, for a
    digest of ``d32`` 32-bit words (16; sha384 12) of which ``mw`` trailing
    ones are live (None: the full state).  ``word_var`` has the block's 32
    words; a 64-bit word varies if either half does."""
    w64 = [word_var[2 * i] or word_var[2 * i + 1] for i in range(16)]
    live = range(8) if mw is None else range((d32 - mw) // 2, d32 // 2)
    return _sha2_block_ops(state_var, w64, 80, live, 2)


def _sha1_block_ops(state_var, word_var, mw):
    """(ops, new state variability) of one SHA-1 compression; the chain
    stops at round 74 + mw (None: the full state)."""
    last = 74 + (5 if mw is None else mw)
    n, w = 0, list(word_var)
    for i in range(16, last + 1):
        terms = (w[i - 3], w[i - 8], w[i - 14], w[i - 16])
        v = any(terms)
        n += _sum_ops(sum(terms), not all(terms)) + v  # XORs, then rotl 1
        w.append(v)
    X = {-1 - j: state_var[j] for j in range(5)}
    rotated = set()

    def rot(i):  # rotl(X[i], 30), computed once per chain value
        nonlocal n
        if i >= -2 and X[i] and i not in rotated:
            rotated.add(i)
            n += 1

    for r in range(last + 1):
        rot(r - 3)
        f = X[r - 2] or X[r - 3] or X[r - 4]
        s_var = sum((f, X[r - 5], w[r]))
        n += f + _sum_ops(s_var, True)  # K is the constant term
        n += X[r - 1] or bool(s_var)    # rotl(a, 5) + s: one LEA.HI
        X[r] = X[r - 1] or bool(s_var)
    out = list(state_var)
    for j in range(79 - last, 5):
        out[j] = X[79 - j]
        n += out[j]  # init + x, or init + rotl(x, 30): one op
    return n, out


RMD_NEED = ((78, 77), (77, 76), (76, 75), (75, 79), (79, 78))


def _ripemd160_block_ops(state_var, word_var, mw):
    """(ops, new state variability) of one RIPEMD-160 compression; each
    line stops at the last chain index its live digest words read."""
    live = range(0 if mw is None else 5 - mw, 5)
    n = 0
    lines = []
    for right, order in ((False, RMD_RL), (True, RMD_RR)):
        last = max(RMD_NEED[j][right] for j in live)
        a0, b0, c0, d0, e0 = state_var
        X = {-1: b0, -2: c0, -3: d0, -4: e0, -5: a0}
        rotated = set()

        def rot(i, X=X, rotated=rotated):  # rotl(X[i], 10), once per chain value
            nonlocal n
            if i >= -2 and X[i] and i not in rotated:
                rotated.add(i)
                n += 1

        for r in range(last + 1):
            rot(r - 3)
            f = X[r - 1] or X[r - 2] or X[r - 3]
            t_var = sum((X[r - 5], f, word_var[order[r]]))
            n += f + _sum_ops(t_var, True)  # K is the constant term
            n += bool(t_var) or X[r - 4]    # rotl(t, s) + e: one LEA.HI
            X[r] = bool(t_var) or X[r - 4]
        lines.append((X, rot))
    (XL, rot_l), (XR, rot_r) = lines
    # word j: h + one chain value of each line, some rotated by 10
    terms = ((78, 77, False, True), (77, 76, True, True), (76, 75, True, True),
             (75, 79, True, False), (79, 78, False, False))
    out = list(state_var)
    for j in live:
        il, ir, rl, rr = terms[j]
        if rl:
            rot_l(il)
        if rr:
            rot_r(ir)
        out[j] = XL[il] or XR[ir]
        n += out[j]
    return n, out


def _sha3_block_ops(state_var, word_var, mw):
    """(ops, new lane variability) of one SHA3-256 absorb and Keccak-f, over
    the 25 lanes (a lane varies if either half does).  A round: theta's
    column sums (a five-input XOR, 2 LOP3 a half), the rotate of each
    column sum by 1, one three-input XOR a lane (A ^ C[x-1] ^ rotl(C[x+1],
    1)), rho's rotate (none by 0), chi (one LOP3 a half) and iota (one XOR
    a half whose constant is not zero).  The last round computes chi only
    for the live lanes (None: all), and only what they read.  The absorb's
    XOR of a varying word joins the byte placement's OR (base | bytes ^
    state is one LOP3, the constants folded), so it costs nothing here."""
    from distpow_tpu_torch.models.sha3 import KECCAK_RC, KECCAK_ROT

    lanes = [state_var[i] or (i < 17 and (word_var[2 * i] or word_var[2 * i + 1]))
             for i in range(25)]
    live = set(range(25)) if mw is None else set(range((8 - mw) // 2, 4))
    src = {y + 5 * ((2 * x + 3 * y) % 5): x + 5 * y for x in range(5) for y in range(5)}
    n = 0
    for r in range(24):
        need = live if r == 23 else set(range(25))
        need_b = {(i % 5 + k) % 5 + i - i % 5 for i in need for k in range(3)}
        need_a = {src[b] for b in need_b}
        need_d = {a % 5 for a in need_a}
        need_c = {(x + 4) % 5 for x in need_d} | {(x + 1) % 5 for x in need_d}
        col = [any(lanes[x + 5 * y] for y in range(5)) for x in range(5)]
        n += sum(4 * col[x] for x in need_c)
        n += sum(2 * col[(x + 1) % 5] for x in need_d)
        a_var = {a: lanes[a] or col[(a + 4) % 5] or col[(a + 1) % 5] for a in need_a}
        n += 2 * sum(a_var.values())
        b_var = {b: a_var[src[b]] for b in need_b}
        n += sum(2 * a_var[src[b]] for b in need_b
                 if KECCAK_ROT[src[b] % 5][src[b] // 5] != 0)
        new = list(lanes)
        for i in need:
            y5 = i - i % 5
            new[i] = b_var[i] or b_var[(i + 1) % 5 + y5] or b_var[(i + 2) % 5 + y5]
            n += 2 * new[i]
        if 0 in need and new[0]:
            n += bool(KECCAK_RC[r] & 0xFFFFFFFF) + bool(KECCAK_RC[r] >> 32)
        lanes = new
    return n, lanes


def _blake2b_block_ops(state_var, word_var, mw):
    """(ops, new state variability) of one BLAKE2b compression over 64-bit
    words.  A G is 8 steps: a + b + x (2), (d ^ a) >>> 32 (2: the XOR), c +
    d (2), (b ^ c) >>> 24 (4), a + b + y (2), (d ^ a) >>> 16 (4), c + d (2),
    (b ^ c) >>> 63 (4), each only where it varies; IV, t and f0 are
    constants.  The last round skips the diagonals that write no lane of a
    live 64-bit digest word (None: all live); a live word is one three-input
    XOR a half, h ^ v[j] ^ v[j + 8]."""
    from distpow_tpu_torch.models.blake2b import BLAKE2B_SIGMA, G_LANES

    m = [word_var[2 * i] or word_var[2 * i + 1] for i in range(16)]
    v = list(state_var) + [False] * 8
    live = set(range(8)) if mw is None else set(range((8 - mw) // 2, 4))
    n = 0
    for r in range(12):
        s = BLAKE2B_SIGMA[r]
        for g, (a, b, c, d) in enumerate(G_LANES):
            if r == 11 and g >= 4 and not any(k % 8 in live for k in (a, b, c, d)):
                continue
            va = v[a] or v[b] or m[s[2 * g]]
            vd = v[d] or va
            vc = v[c] or vd
            vb = v[b] or vc
            n += 2 * va + 2 * vd + 2 * vc + 4 * vb
            va = va or vb or m[s[2 * g + 1]]
            vd = vd or va
            vc = vc or vd
            vb = vb or vc
            n += 2 * va + 4 * vd + 2 * vc + 4 * vb
            v[a], v[b], v[c], v[d] = va, vb, vc, vd
    out = list(state_var)
    for j in live:
        out[j] = state_var[j] or v[j] or v[j + 8]
        n += 2 * out[j]
    return n, out


# model -> (the ops of one block, the state values it tracks)
BLOCK_OPS = {"sha256": (_sha256_block_ops, 8), "sha256d": (_sha256_block_ops, 8),
             "sha1": (_sha1_block_ops, 5), "ripemd160": (_ripemd160_block_ops, 5),
             "sha512": (functools.partial(_sha512_block_ops, d32=16), 8),
             "sha384": (functools.partial(_sha512_block_ops, d32=12), 8),
             "sha3_256": (_sha3_block_ops, 25), "blake2b_256": (_blake2b_block_ops, 8)}


def needed_ops(model_name: str, n_blocks: int, mask_words: int, var_words) -> int:
    """Integer operations one candidate of a power-of-two run needs, counted
    from the hash itself (the conventions above).  ``var_words`` are the
    tail's message words (``words_per_block`` a block) that hold variable
    bytes.  Around the compressions, as for md5: decode 4, placing the
    variable bytes (a byte swap for a big-endian hash, a combine, a shift
    and an OR per word), the mask fold (one per mask word), the hit test 2
    and the loop 3."""
    from distpow_tpu_torch.models.registry import get_hash_model

    if model_name == "md5":
        return md5_needed_ops(n_blocks, mask_words, var_words)
    model = get_hash_model(model_name)
    wpb = model.words_per_block
    fn, state_size = BLOCK_OPS[model_name]
    state = [False] * state_size
    n = 0
    for blk in range(n_blocks):
        words = [wpb * blk + w in var_words for w in range(wpb)]
        last = blk == n_blocks - 1
        if model_name == "sha256d" and last:
            ops, state = fn(state, words, None)
            n += ops
            # stage 2: the digest words, then constants, from the constant init
            ops, state = fn([False] * 8, state + [False] * 8, mask_words)
        else:
            ops, state = fn(state, words, mask_words if last else None)
        n += ops
    big_endian = model.word_byteorder == "big"
    return n + 4 + big_endian + 1 + 2 * len(var_words) + mask_words + 2 + 3


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
    from distpow_tpu_torch.backends.cuda_backend import CudaBackend, CudaMeshBackend
    from distpow_tpu_torch.models import puzzle
    from distpow_tpu_torch.models.registry import get_hash_model
    from distpow_tpu_torch.ops import _build
    from distpow_tpu_torch.ops.hash_cuda import (BLOCK_THREADS, KERNELS, KEYED_LAYOUTS, LAUNCHES,
                                                 default_grid, hash_search, kernel_layout,
                                                 kernel_mask_words)
    from distpow_tpu_torch.ops.operands import make_operands, u32_value
    from distpow_tpu_torch.ops.packing import build_tail_spec
    from distpow_tpu_torch.ops.difficulty import nibble_masks
    from distpow_tpu_torch.ops.hash_cuda import (group_grid, hash_group_search,
                                                 hash_persistent_search, one_wave_for)
    from distpow_tpu_torch.ops.operands import group_operands
    from distpow_tpu_torch.ops.search_step import (
        SENTINEL, MeshOrigin, mask_words_for, partition_index, persistent_search_step,
        plain_first_hits, plain_group_search, plain_mesh_search, plain_search, step_operands)
    from distpow_tpu_torch.parallel import mesh_search
    from distpow_tpu_torch.parallel.mesh_search import make_mesh
    from distpow_tpu_torch.runtime.metrics import Metrics
    from distpow_tpu_torch.sched import BatchingScheduler
    from distpow_tpu_torch.parallel.partition import thread_bytes, worker_bits
    from distpow_tpu_torch.parallel.search import StopFlag, assemble_secret, launch_steps_for
    from distpow_tpu_torch.runtime.metrics import REGISTRY
    from distpow_tpu_torch.backends import cuda_backend
    from distpow_tpu_torch.nodes import Worker
    from distpow_tpu_torch.runtime import rpc, tracing
    from distpow_tpu_torch.runtime.config import WorkerConfig
    from distpow_tpu_torch.runtime.spans import SPANS

    MODEL_OF = {KERNELS[m]: m for m in MODELS}
    os.makedirs(OUT_DIR, exist_ok=True)
    smoke = Smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def sync_value(t) -> int:
        torch.cuda.synchronize()
        return u32_value(t)

    def main_steps(model) -> int:
        """Sub-batches of the worker's width-4 launch for ``model``: what the
        driver plans under the CUDA backend's cost-scaled budget."""
        budget = CudaBackend(hash_model=model.name, device=dev).max_launch
        return launch_steps_for(4, MAIN_BATCH // 256, 256, budget)

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
    # kernel -> {(mask_words, n_blocks, pow2): SASS loop opcodes}: the whole
    # loop body, and what one candidate issues (spec_sass_loops); the group
    # kernels' by n_blocks
    loops, issued = {}, {}
    group_loops, group_issued = {}, {}
    mesh_issued = {}

    def build():
        # every library: the eight sources, and md5's once per var_word
        paths = _build.build()
        # copied now: load_library below calls build() again, which resets them
        build_s, library_log = _build.last_build_s, dict(_build.last_build_log)
        log = "\n".join(f"== {k}\n{v}" for k, v in library_log.items())
        with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as fh:
            fh.write(log)
        # per kernel, its libraries' logs and listings together
        build_log = collections.defaultdict(str)
        for lib, text in library_log.items():
            build_log[lib.partition(".vw")[0]] += text
        ptxas, loop_counts, group_info, mesh_info, persistent_info = {}, {}, {}, {}, {}
        # the listings parsed at once, one process a library
        libs = sorted(paths)
        with concurrent.futures.ProcessPoolExecutor(
                min(len(libs), os.cpu_count() or 8),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            by_library = dict(zip(libs, pool.map(
                listing_loops, [_build.find_cuda_tool("cuobjdump")] * len(libs),
                [paths[k] for k in libs],
                [os.path.join(OUT_DIR, f"{k}.sass.gz") for k in libs])))
        parsed = {}
        for lib, (whole, path) in by_library.items():
            kernel = parsed.setdefault(lib.partition(".vw")[0], ({}, {}))
            kernel[0].update(whole)
            kernel[1].update(path)
        for model_name in MODELS:
            kernel = KERNELS[model_name]
            # mask words 1-4 and the full digest (md5's is 4), both runs; md5
            # at every tail layout it is built for, the others per tail length
            model = get_hash_model(model_name)
            mws = sorted({1, 2, 3, 4, model.digest_words})
            tails = [(nb, vw) for nb, vws in KEYED_LAYOUTS.get(model_name, {1: [0], 2: [0]}).items()
                     for vw in vws]
            expect = 2 * len(mws) * len(tails)
            specs = parse_ptxas(build_log.get(kernel, ""))
            if build_log and len(specs) != expect:
                raise RuntimeError(f"ptxas reported {len(specs)} of {expect} {kernel} kernels")
            ptxas[kernel] = {spec_label(k): v for k, v in sorted(specs.items())}
            whole, path = parsed[kernel]
            loops[kernel] = by_spec(whole)
            issued[kernel] = by_spec(path)
            if len(loops[kernel]) != expect:
                raise RuntimeError(f"found the loop of {len(loops[kernel])} of {expect} "
                                   f"{kernel} specializations")
            loop_counts[kernel] = {spec_label(k): sum(v.values())
                                   for k, v in sorted(loops[kernel].items())}
            # the group kernel, one specialization per tail: the solo kernel's
            # full-digest power-of-two body, beside which it is shown (md5's
            # at the main path's run for a one-block tail, at word 14 for a
            # two-block one)
            gspecs = parse_group_ptxas(build_log.get(kernel, ""))
            group_loops[kernel] = by_group(whole)
            group_issued[kernel] = by_group(path)
            if (build_log and len(gspecs) != len(tails)) or len(group_loops[kernel]) != len(tails):
                raise RuntimeError(f"{kernel}: ptxas reported {len(gspecs)} and the SASS "
                                   f"{len(group_loops[kernel])} of {len(tails)} group kernels")
            full = model.digest_words
            shown = {1: MAIN_VAR_WORD, 2: 14}
            group_info[kernel] = {
                f"nb{nb}": {**gspecs.get(group_key(model_name, nb, shown[nb]), {}),
                            "loop_instructions": sum(group_loops[kernel][
                                group_key(model_name, nb, shown[nb])].values()),
                            "solo_full_digest": {
                                **ptxas[kernel].get(spec_label(
                                    timed_key(model_name, full, nb, shown[nb])), {}),
                                "loop_instructions": sum(loops[kernel][
                                    timed_key(model_name, full, nb, shown[nb])].values())}}
                for nb in (1, 2)}
            if model_name in KEYED_MODELS:
                group_info[kernel]["registers_all_layouts"] = sorted(
                    {v["registers"] for v in gspecs.values()})
                group_info[kernel]["spill_bytes_all_layouts"] = max(
                    [v["spill_bytes"] for v in gspecs.values()], default=None)
            # the mesh kernel, one specialization per solo one: the solo
            # loop, the remap to the partition's index after it
            mspecs = parse_ptxas(build_log.get(kernel, ""), MESH_KEY)
            mloops = by_spec(whole, MESH_KEY)
            mesh_issued[kernel] = by_spec(path, MESH_KEY)
            if (build_log and len(mspecs) != expect) or len(mloops) != expect:
                raise RuntimeError(f"{kernel}: ptxas reported {len(mspecs)} and the SASS "
                                   f"{len(mloops)} of {expect} mesh kernels")
            tk = timed_key(model_name)
            mesh_info[kernel] = {
                "same_loop_length_as_solo": sum(sum(mloops[k].values()) == sum(loops[kernel][k].values())
                                                for k in mloops),
                "specializations": expect,
                "register_delta_to_solo": sorted({v["registers"] - specs[k]["registers"]
                                                  for k, v in mspecs.items() if k in specs}),
                "spill_bytes": max([v["spill_bytes"] for v in mspecs.values()], default=None),
                "timed": {**mspecs.get(tk, {}), "loop_instructions": sum(mloops[tk].values())}}
            # the persistent forms, one specialization per solo (mesh) one:
            # the same loop with the checks of the cell and the flag
            persistent_info[kernel] = {}
            for form, key, base_specs in (("solo", PERSISTENT_KEY, specs),
                                          ("mesh", MESH_PERSISTENT_KEY, mspecs)):
                pspecs = parse_ptxas(build_log.get(kernel, ""), key)
                ploops = by_spec(whole, key)
                if (build_log and len(pspecs) != expect) or len(ploops) != expect:
                    raise RuntimeError(f"{kernel}: ptxas reported {len(pspecs)} and the SASS "
                                       f"{len(ploops)} of {expect} {form} persistent kernels")
                persistent_info[kernel][form] = {
                    "register_delta_to_serial": sorted({v["registers"] - base_specs[k]["registers"]
                                                        for k, v in pspecs.items()
                                                        if k in base_specs}),
                    "spill_bytes": max([v["spill_bytes"] for v in pspecs.values()], default=None),
                    "timed": {**pspecs.get(tk, {}),
                              "loop_instructions": sum(ploops[tk].values())}}
        for lib in libs:
            name, _, vw = lib.partition(".vw")
            _build.load_library(name, int(vw) if vw else None)
        # what one candidate of the timed specialization issues, by opcode
        # (ISETP and SEL are the byte placement against a runtime layout;
        # the IMAD forms apart) and by pipe
        timed = {}
        for k in issued:
            kinds = collections.Counter()
            for op, c in issued[k][timed_key(MODEL_OF[k])].items():
                kinds[opcode_kind(op)] += c
            timed[k] = dict(kinds.most_common())
        return {"build_s": build_s, "libraries": {k: os.path.relpath(v, HERE)
                                                  for k, v in paths.items()},
                "ptxas": ptxas, "loop_instructions": loop_counts,
                "timed_loop_opcodes": timed,
                "timed_loop_pipes": {k: pipe_split(issued[k][timed_key(MODEL_OF[k])])
                                     for k in issued},
                "group_kernels": group_info, "mesh_kernels": mesh_info,
                "persistent_kernels": persistent_info,
                "group_loop_pipes": {k: pipe_split(group_issued[k][group_key(MODEL_OF[k], 1)])
                                     for k in group_issued},
                "md5_specializations": {"solo": len(loops[KERNELS["md5"]]),
                                        "group": len(group_loops[KERNELS["md5"]])}}

    smoke.phase("build", build, needs=("device",))

    # 3. kernel_parity --------------------------------------------------
    def kernel_parity(model, seed, nonce_lens, difficulties):
        import numpy as np

        rng = np.random.default_rng(seed)
        cases = []  # (label, ops, spec, chunk0, batch, steps, grid)
        i = 0
        for n_len in nonce_lens:
            nonce = rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes()
            for width in range(5):
                for d in difficulties:
                    tb_lo, tbc, chunks = PARTITIONS[i % len(PARTITIONS)]
                    steps = LAUNCH_STEPS[(i // len(PARTITIONS)) % 2]
                    extra = b"\x01\x02" if i % 7 == 3 else b""
                    i += 1
                    spec = build_tail_spec(nonce, width, model, extra)
                    ops = step_operands(spec, d, model, tb_lo, tbc, dev)
                    if width == 0:
                        cases.append((f"n{n_len}_w0_d{d}", ops, spec, 0, tbc, 1, None))
                        continue
                    # segment start, and a start whose launch runs past the
                    # width's end (chunk bytes wrap as in the driver's overshoot)
                    chunk0 = 256 ** (width - 1) if i % 2 else 256 ** width - 5
                    cases.append((f"n{n_len}_w{width}_d{d}_tbc{tbc}_k{steps}", ops, spec,
                                  chunk0, chunks * tbc, steps, None))
        # synthetic sparse masks: hits in every mask bucket (also the widths
        # the wrapper pads to the full digest) and tail shape (a one-block
        # tail, a two-block one whose run crosses the block boundary), first
        # hits deep in the launch, small grids that loop
        for mw in range(1, model.digest_words + 1):
            for n_len in (13, 60 if model.block_bytes == 64 else model.block_bytes - 3):
                for (tb_lo, tbc, chunks), bits, grid in (((0, 256, 64), 6, None),
                                                         ((16, 96, 128), 13, 3)):
                    nonce = rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes()
                    spec = build_tail_spec(nonce, 3, model)
                    masks = [0] * mw
                    for b in rng.choice(32 * mw, size=bits, replace=False):
                        masks[int(b) // 32] |= 1 << (int(b) % 32)
                    ops = make_operands(spec.init_state, spec.base_words, masks, tb_lo, tbc, dev)
                    cases.append((f"mask{mw}_n{n_len}_tbc{tbc}_bits{bits}", ops, spec, 70000,
                                  chunks * tbc, 3, grid))
        # md5: every tail layout its kernels are built for, at mask words
        # 1-4, 2^14 candidates each (a whole absorbed block before every
        # other layout's tail)
        for n_blocks, var_words in KEYED_LAYOUTS.get(model.name, {}).items():
            for vw in var_words:
                rem = 4 * vw + int(rng.integers(0, 4))
                if n_blocks == 1:
                    rem = min(rem, 53)  # room for a chunk byte
                    width, extra = min(4, 54 - rem), b""
                else:
                    width = int(rng.integers(1, 5))
                    extra = bytes(rng.integers(1, 256, size=max(0, 56 - rem - 1 - width),
                                               dtype=np.uint8))
                nonce = rng.integers(0, 256, size=rem + 64 * (vw % 2), dtype=np.uint8).tobytes()
                spec = build_tail_spec(nonce, width, model, extra)
                if (spec.n_blocks, kernel_layout(spec.tb_loc, spec.chunk_locs, model)[0]) != \
                        (n_blocks, vw):
                    raise AssertionError(f"no tail at layout {(n_blocks, vw)}")
                for mw in range(1, 5):
                    masks = [0] * mw
                    for b in rng.choice(32 * mw, size=9, replace=False):
                        masks[int(b) // 32] |= 1 << (int(b) % 32)
                    tb_lo, tbc, chunks = PARTITIONS[(vw + mw) % len(PARTITIONS)]
                    ops = make_operands(spec.init_state, spec.base_words, masks, tb_lo, tbc, dev)
                    cases.append((f"layout_nb{n_blocks}_vw{vw}_mask{mw}_tbc{tbc}", ops, spec,
                                  max(0, 256 ** width - 3 * chunks), chunks * tbc, 1, None))
        mismatches, hits, max_err = [], 0, 0
        kernel_out = [hash_search(model, ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, steps,
                                  device=dev, grid=grid)
                      for _, ops, spec, chunk0, batch, steps, grid in cases]
        torch.cuda.synchronize()
        plain = judge_cases(model, [(ops, spec, chunk0, batch * steps)
                                    for _, ops, spec, chunk0, batch, steps, _ in cases])
        for (label, *_), got, want in zip(cases, kernel_out, plain):
            got = u32_value(got)
            hits += want != SENTINEL
            max_err = max(max_err, abs(got - want))
            if got != want:
                mismatches.append({"case": label, "kernel": got, "plain": want})
        if mismatches:
            raise AssertionError(f"{len(mismatches)} of {len(cases)} cases differ: "
                                 f"{mismatches[:10]}")
        layouts = sorted({(spec.n_blocks, kernel_layout(spec.tb_loc, spec.chunk_locs, model)[0])
                          for _, _, spec, *_ in cases})
        return {"cases": len(cases), "mismatches": 0, "hit_cases": hits,
                "sentinel_cases": len(cases) - hits, "layouts": len(layouts),
                "max_abs_err": max_err,
                "tolerance": "exact (integer first-hit index)"}

    def judge_cases(model, cases):
        """The plain version's first hit of each case ``(ops, spec, chunk0,
        n)``: the cases of one tail layout evaluated together
        (``plain_first_hits``, which computes ``plain_search`` and
        ``plain_search_w0`` case by case), at most ``JUDGE_CANDIDATES`` at a
        time."""
        by_layout = collections.defaultdict(list)
        for i, (ops, spec, chunk0, n) in enumerate(cases):
            by_layout[(spec.n_blocks, spec.tb_loc, spec.chunk_locs)].append(i)
        out = [None] * len(cases)
        d = model.digest_words
        for (n_blocks, tb_loc, chunk_locs), idx in by_layout.items():
            while idx:
                take, total = [], 0
                while idx and (not take or total + cases[idx[0]][3] <= JUDGE_CANDIDATES):
                    total += cases[idx[0]][3]
                    take.append(idx.pop(0))
                ops = [cases[i][0] for i in take]
                first = plain_first_hits(
                    model, n_blocks, tb_loc, chunk_locs,
                    torch.stack([o.init for o in ops]), torch.stack([o.base for o in ops]),
                    torch.stack([torch.nn.functional.pad(o.masks, (d - o.mask_words, 0))
                                 for o in ops]),
                    [o.tb_lo for o in ops], [o.tb_count for o in ops],
                    [cases[i][2] for i in take],
                    [cases[i][3] for i in take]).tolist()
                for i, v in zip(take, first):
                    out[i] = v
        return out

    # 3b. full_parity: the main path's launch (the wrapper's grid) against
    # the plain version, on inputs with hits --------------------------------
    def full_parity(model):
        steps = main_steps(model)
        n = MAIN_BATCH * steps
        grid = default_grid(n, smoke.info["device"]["sm_count"])
        stride = grid * BLOCK_THREADS

        def operands(nonce, d):
            spec = build_tail_spec(nonce, 4, model)
            return spec, step_operands(spec, d, model, 0, 256, dev)

        def kernel(spec, ops):
            return sync_value(hash_search(model, ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0,
                                          MAIN_BATCH, steps, device=dev))

        # a nonce whose first difficulty-7 hit lies in the launch's second
        # half, in a block of the grid's second half (the plain version
        # below is the judge of the index the kernel reports), and at a
        # thread byte of the upper half: on a later shard of the mesh
        # phases (mesh_full_parity, mesh_procs), which reuse the nonce
        for i in range(FULL_PARITY_TRIES):
            nonce = bytes([0x70, 0x61, 0x72, i])
            f = kernel(*operands(nonce, 7))
            if f != SENTINEL and f >= n // 2 and (f % stride) // BLOCK_THREADS >= grid // 2 \
                    and f % 256 >= 128:
                break
        else:
            raise AssertionError(f"no nonce of {FULL_PARITY_TRIES} has a deep first hit")
        cases, max_err = [], 0
        # difficulty 7: one deep first hit and few others; difficulty 6: hits
        # in many blocks at once, whose atomicMin must keep the first.  The
        # plain version judges the sub-batches up to the one holding the
        # kernel's index: it is the first hit iff the plain version finds
        # nothing before it and a hit at it
        for d in (7, 6):
            spec, ops = operands(nonce, d)
            got = kernel(spec, ops)
            if got == SENTINEL:
                raise AssertionError(f"full launch at difficulty {d}: the kernel found no hit")
            judged = got // MAIN_BATCH + 1
            want = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0,
                                          MAIN_BATCH, judged, model=model))
            max_err = max(max_err, abs(got - want))
            cases.append({"difficulty": d, "kernel": got, "plain": want,
                          "fraction_of_launch": got / n, "plain_sub_batches": judged,
                          "block": (got % stride) // BLOCK_THREADS})
            if got != want:
                raise AssertionError(f"full launch at difficulty {d}: kernel {got}, plain {want}")
        return {"nonce": nonce.hex(), "candidates": n, "launch_steps": steps, "grid": grid,
                "nonces_tried": i + 1, "cases": cases, "mismatches": 0, "max_abs_err": max_err,
                "tolerance": "exact (integer first-hit index)"}

    # 3c. persistent_parity: the persistent form of the solo and mesh
    # kernels against the plain persistent step ------------------------------
    def persistent_words(model, cases):
        """The plain persistent step's two words for each case ``(ops,
        spec, chunk0, batch, segments)`` with no flag, from the plain
        version's first hit over the whole launch (``judge_cases``) and the
        segment it lies in: what ``persistent_search_step`` computes
        segment by segment (held to it directly below)."""
        firsts = judge_cases(model, [(ops, spec, c0, batch * segs)
                                     for ops, spec, c0, batch, segs in cases])
        return [[f, segs if f == SENTINEL else f // batch + 1]
                for f, (*_, batch, segs) in zip(firsts, cases)]

    def words_of(t):
        return [u32_value(v) for v in t.reshape(-1)]

    def persistent_parity(model, seed):
        import numpy as np

        rng = np.random.default_rng(seed)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        one = torch.ones(1, dtype=torch.int32, device=dev)
        cases, labels, raised = [], [], 0
        for n_len in (4, model.block_bytes - 3):
            nonce = rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes()
            # width 0 has no persistent form: the kernel's wrapper and the
            # plain step raise
            spec = build_tail_spec(nonce, 0, model)
            ops = step_operands(spec, 1, model, 0, 256, dev)
            for fn in (lambda: hash_persistent_search(model, ops, spec.tb_loc, spec.chunk_locs,
                                                      0, 256, 1, zero, device=dev),
                       lambda: persistent_search_step(ops, spec.tb_loc, spec.chunk_locs, 0, 256,
                                                      1, zero, model=model)):
                try:
                    fn()
                except ValueError:
                    raised += 1
                else:
                    raise AssertionError("a width-0 persistent launch did not raise")
            for width in range(1, 5):
                spec = build_tail_spec(nonce, width, model)
                for tb_lo, tbc, chunks in PERSISTENT_PARTITIONS:
                    for segs in PERSISTENT_SEGMENTS:
                        for d in PERSISTENT_DIFFICULTIES if segs > 1 else \
                                PERSISTENT_DIFFICULTIES[1:2]:
                            ops = step_operands(spec, d, model, tb_lo, tbc, dev)
                            # a segment start, or a launch that runs past the
                            # width's end (chunk bytes wrap as in the driver)
                            chunk0 = 256 ** (width - 1) if len(cases) % 2 else \
                                (256 ** width - 2 * chunks) & 0xFFFFFFFF
                            cases.append((ops, spec, chunk0, chunks * tbc, segs))
                            labels.append(f"n{n_len}_w{width}_tbc{tbc}_k{segs}_d{d}")
        got = [hash_persistent_search(model, ops, spec.tb_loc, spec.chunk_locs, c0, batch, segs,
                                      zero, device=dev) for ops, spec, c0, batch, segs in cases]
        # a flag set before the launch: (SENTINEL, 0), on every third case
        stopped = [hash_persistent_search(model, ops, spec.tb_loc, spec.chunk_locs, c0, batch,
                                          segs, one, device=dev)
                   for ops, spec, c0, batch, segs in cases[::3]]
        torch.cuda.synchronize()
        want = persistent_words(model, cases)
        mismatches, kinds, tails, max_err = [], collections.Counter(), set(), 0
        for label, g, w, case in zip(labels, got, want, cases):
            g = words_of(g)
            kinds["none" if w[0] == SENTINEL else "first" if w[1] == 1 else
                  "last" if w[1] == case[4] else "middle"] += 1
            tails.add(case[1].n_blocks)
            max_err = max(max_err, *(abs(a - b) for a, b in zip(g, w)))
            if g != w:
                mismatches.append({"case": label, "kernel": g, "plain": w})
        for label, g in zip(labels[::3], stopped):
            if words_of(g) != [SENTINEL, 0]:
                mismatches.append({"case": f"{label}_stopped", "kernel": words_of(g)})
        # persistent_search_step itself: per width the case with the latest
        # first hit, and with the flag set
        direct = []
        for width in range(1, 5):
            i = max((j for j, c in enumerate(cases) if len(c[1].chunk_locs) == width),
                    key=lambda j: (want[j][0] != SENTINEL, want[j][1]))
            ops, spec, c0, batch, segs = cases[i]
            v = words_of(persistent_search_step(ops, spec.tb_loc, spec.chunk_locs, c0, batch,
                                                segs, zero, model=model))
            v1 = words_of(persistent_search_step(ops, spec.tb_loc, spec.chunk_locs, c0, batch,
                                                 segs, one, model=model))
            direct.append({"case": labels[i], "plain_step": v, "judge": want[i]})
            if v != want[i] or v1 != [SENTINEL, 0]:
                mismatches.append({**direct[-1], "stopped": v1})
        # the mesh form on 4 logical shards: a thread-byte split and two
        # chunk splits, against the plain persistent step at the partition's
        # segment
        mesh = make_mesh(shard_devices(MESH_SHARDS))
        mesh_cases = []
        for tb_lo, tbc in PERSISTENT_MESH_RUNS:
            for width in (1, 4):
                for d in PERSISTENT_DIFFICULTIES:
                    nonce = rng.integers(0, 256, size=(4, model.block_bytes - 3)[width == 4],
                                         dtype=np.uint8).tobytes()
                    spec = build_tail_spec(nonce, width, model)
                    step, each, chunks = mesh_search.mesh_persistent_factory(
                        nonce, d, tb_lo, tbc, model, mesh)(width, b"", max(1, 4096 // tbc), 4)
                    chunk0 = 256 ** (width - 1)
                    mesh_cases.append((
                        f"mesh_tbc{tbc}_w{width}_d{d}", step(chunk0, StopFlag()),
                        step(chunk0, StopFlag(set_=True)),
                        (step_operands(spec, d, model, tb_lo, tbc, dev), spec, chunk0,
                         each * tbc, chunks // each)))
        torch.cuda.synchronize()
        mesh_want = persistent_words(model, [c[3] for c in mesh_cases])
        mesh_hits = 0
        for (label, g, g1, _), w in zip(mesh_cases, mesh_want):
            mesh_hits += w[0] != SENTINEL
            max_err = max(max_err, *(abs(a - b) for a, b in zip(words_of(g), w)))
            if words_of(g) != w or words_of(g1) != [SENTINEL, 0]:
                mismatches.append({"case": label, "mesh": words_of(g), "stopped": words_of(g1),
                                   "plain": w})
        if mismatches:
            raise AssertionError(f"{len(mismatches)} of {len(cases) + len(mesh_cases)} cases "
                                 f"differ: {mismatches[:10]}")
        if tails != {1, 2} or not all(kinds[k] for k in ("first", "middle", "none")) or \
                raised != 4 or not 0 < mesh_hits < len(mesh_cases):
            raise AssertionError(f"the grid missed a case: tails {tails}, {dict(kinds)}, "
                                 f"{raised} width-0 refusals, {mesh_hits} mesh hits")
        return {"cases": len(cases), "stopped_cases": len(stopped), "mesh_cases": len(mesh_cases),
                "mismatches": 0, "segments_of_first_hit": dict(kinds), "tails": sorted(tails),
                "width0_refused": raised, "plain_step": direct, "max_abs_err": max_err,
                "tolerance": "exact (integer first-hit index and segment count)",
                "main_path": persistent_main(model, mesh)}

    def persistent_main(model, mesh):
        """The main path's persistent launch at full_parity's deep
        difficulty-7 hit, solo and on the mesh: both give (the solo kernel's
        index, its segment + 1); timed beside the solo kernel on the same
        launch (which runs on past its hit), and the plain persistent step's
        time and words on it."""
        fp = smoke.info[f"full_parity{suffix(model.name)}"]
        nonce, steps, f = bytes.fromhex(fp["nonce"]), fp["launch_steps"], fp["cases"][0]["kernel"]
        spec = build_tail_spec(nonce, 4, model)
        ops = step_operands(spec, 7, model, 0, 256, dev)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        budget = CudaBackend(hash_model=model.name, device=dev).max_launch
        mstep, each, chunks = mesh_search.mesh_persistent_factory(
            nonce, 7, 0, 256, model, mesh, max_launch=budget)(4, b"", MAIN_BATCH // 256, steps)
        if each * 256 != MAIN_BATCH or chunks * 256 != MAIN_BATCH * steps:
            raise AssertionError(f"the mesh's segments: {each} chunks, {chunks} a launch")
        # the persistent form on one resident wave and on the serial
        # kernel's grid of several waves; "persistent" is the one the
        # backends launch here (one_wave_for: one wave where the launch is
        # expected to hold half a hit or more)
        one_wave = one_wave_for(MAIN_BATCH * steps, 7)
        forms = {"solo": lambda: hash_search(model, ops, spec.tb_loc, spec.chunk_locs,
                                             MAIN_CHUNK0, MAIN_BATCH, steps, device=dev),
                 "persistent_one_wave": lambda: hash_persistent_search(
                     model, ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0, MAIN_BATCH, steps,
                     zero, device=dev, one_wave=True),
                 "persistent_waves": lambda: hash_persistent_search(
                     model, ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0, MAIN_BATCH, steps,
                     zero, device=dev, one_wave=False),
                 "mesh_persistent": lambda: mstep(MAIN_CHUNK0, StopFlag())}
        waves = default_grid(MAIN_BATCH * steps, smoke.info["device"]["sm_count"])
        expect = [f, f // MAIN_BATCH + 1]
        for name, fn in forms.items():
            out = fn()
            torch.cuda.synchronize()
            got = words_of(out)
            if got != (expect[:1] if name == "solo" else expect):
                raise AssertionError(f"main path {name}: {got}, expected {expect}")
        runs = collections.defaultdict(list)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for name in ("solo", "persistent_one_wave", "persistent_waves", "mesh_persistent",
                     "mesh_persistent", "persistent_waves", "persistent_one_wave", "solo"):
            start.record()
            for _ in range(PERSISTENT_RATE_LAUNCHES):
                forms[name]()
            end.record()
            end.synchronize()
            runs[name].append(start.elapsed_time(end) / PERSISTENT_RATE_LAUNCHES)
        runs["persistent"] = runs["persistent_one_wave" if one_wave else "persistent_waves"]
        start.record()
        plain = words_of(persistent_search_step(ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0,
                                                MAIN_BATCH, steps, zero, model=model))
        end.record()
        end.synchronize()
        if plain != expect:
            raise AssertionError(f"main path: plain persistent step {plain}, kernel {expect}")
        # the bound of this run's data: the candidates up to the end of the
        # hit's segment, the plain step's work
        mw = mask_words_for(7, model)
        var_words = {model.words_per_block * b + w for b, w, _ in (spec.tb_loc, *spec.chunk_locs)}
        needed = needed_ops(model.name, spec.n_blocks, mw, var_words)
        dev_info = smoke.info["device"]
        clocks_per_s = dev_info["sm_count"] * dev_info["clock_mhz"] * 1e6
        candidates = expect[1] * MAIN_BATCH
        return {"nonce": nonce.hex(), "difficulty": 7, "launch_steps": steps, "words": expect,
                "fraction_of_launch": f / (MAIN_BATCH * steps),
                "ms": {k: min(v) for k, v in runs.items()}, "ms_runs": dict(runs),
                "persistent_over_solo": min(runs["persistent"]) / min(runs["solo"]),
                "one_wave": one_wave, "waves_grid": waves,
                "one_wave_over_waves": (min(runs["persistent_one_wave"]) /
                                        min(runs["persistent_waves"])),
                "plain_ms": start.elapsed_time(end), "plain_words": plain,
                "bound_candidates": candidates, "needed_ops_per_hash": needed,
                "bound_ms": candidates * needed / (ISSUED_RESULTS_PER_CLOCK_PER_SM *
                                                   clocks_per_s) * 1e3,
                "card": dev_info["nvidia_smi"]}

    # 4. mine: the worker's path through get_backend("auto"), both loops ---
    def mine(model):
        if get_backend("auto", hash_model=model.name).loop != "persistent":
            raise AssertionError("the default search loop is not the persistent one")
        backends = {loop: get_backend("auto", hash_model=model.name, loop=loop)
                    for loop in ("persistent", "serial")}
        for backend in backends.values():
            if not isinstance(backend, CudaBackend) or backend.batch_size != 1 << 20 \
                    or backend.model is not model:
                raise AssertionError(f"auto resolved to {backend!r}")
        backend = backends["persistent"]
        kernel = KERNELS[model.name]
        persistent_kernel = f"{kernel}_persistent"
        nonce = bytes([1, 2, 3, 4])
        full = thread_bytes(0, worker_bits(1))

        def counts():
            return (REGISTRY.get("search.hashes"), REGISTRY.get("search.launches"),
                    LAUNCHES[kernel].value, LAUNCHES[persistent_kernel].value,
                    REGISTRY.get("search.blocking_syncs"),
                    REGISTRY.get("search.persistent_steps"))

        def deltas(before):
            return dict(zip(("hashes_dispatched", "search_launches", "kernel_launches",
                             "persistent_kernel_launches", "blocking_syncs",
                             "persistent_steps"),
                            (b - a for a, b in zip(before, counts()))))

        def digest_hex(msg):
            h = puzzle.new_hash(model.name)
            h.update(msg)
            return h.hexdigest()

        def four_way():
            """md5's 4-way prefix split on the one card, each worker in its
            own thread and stream; the first result wins and cancels the
            others."""
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
            threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                       for i in range(4)]
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
            return {"difficulty": d4, "workers": 4, "winner": winner,
                    "secret": secret.hex(), "md5": digest, "wall_s": t_win - t0,
                    **deltas(before), "loop": "persistent",
                    "finished": sum(r is not None for r in results)}

        # each loop's run on its own: every count to 0 just before it, read
        # just after.  The persistent loop (the default) is the main path:
        # its counts go into the kernels line; the serial loop's are kept
        # beside them.
        difficulties = MINE_DIFFICULTIES[model.name]
        runs, launches, totals, split = {}, {}, {}, None
        for loop in ("persistent", "serial"):
            for counter in LAUNCHES.values():
                counter.reset()
            REGISTRY.reset()
            runs[loop] = {}
            for d in difficulties:
                before = counts()
                t0 = time.monotonic()
                secret = backends[loop].search(nonce, d, full)
                runs[loop][d] = {"secret": secret, "wall_s": time.monotonic() - t0,
                                 **deltas(before)}
            if loop == "persistent" and model.name == "md5":
                split = four_way()
            launches[loop] = {k: c.value for k, c in LAUNCHES.items() if c.value}
            totals[loop] = {k: REGISTRY.get(f"search.{k}") for k in
                            ("launches", "blocking_syncs", "persistent_steps")}

        requests = []
        for d in difficulties:
            p, sr = runs["persistent"][d], runs["serial"][d]
            secret = p["secret"]
            if secret is None or not puzzle.check_secret(nonce, secret, d, model.name):
                raise AssertionError(f"difficulty {d}: {secret!r} does not solve")
            if sr["secret"] != secret:
                raise AssertionError(f"difficulty {d}: persistent {secret.hex()} != serial "
                                     f"{sr['secret']!r}")
            digest = digest_hex(nonce + secret)
            if not digest.endswith("0" * d):
                raise AssertionError(f"difficulty {d}: {model.name} digest {digest}")
            if p["kernel_launches"] + p["persistent_kernel_launches"] <= 0 or \
                    sr["kernel_launches"] <= 0:
                raise AssertionError(f"difficulty {d}: {kernel} was not launched: {p}, {sr}")
            if p["blocking_syncs"] != 0 or sr["persistent_kernel_launches"] != 0:
                raise AssertionError(f"difficulty {d}: the persistent loop blocked or the "
                                     f"serial one ran the persistent kernel: {p}, {sr}")
            serial = {k: v for k, v in sr.items() if k != "secret"}
            req = {"difficulty": d, "workers": 1, "secret": secret.hex(), model.name: digest,
                   **{k: v for k, v in p.items() if k != "secret"}, "loop": "persistent",
                   "serial": serial}
            if d == difficulties[0]:
                oracle = puzzle.python_search(nonce, d, full, algo=model.name)
                req["python_search"] = oracle.hex()
                if oracle != secret:
                    raise AssertionError(f"difficulty {d}: kernel {secret.hex()} != "
                                         f"python_search {oracle.hex()}")
            requests.append(req)
        if split is not None:
            requests.append(split)
        # the persistent loop ran the solo kernel (its width-0 probes) and
        # its persistent form; the serial loop the solo kernel alone
        path = {kernel: launches["persistent"].get(kernel, 0),
                persistent_kernel: launches["persistent"].get(persistent_kernel, 0)}
        serial_path = {kernel: launches["serial"].get(kernel, 0)}
        if min(path.values()) <= 0 or min(serial_path.values()) <= 0:
            raise AssertionError(f"a loop launched a kernel of its path no time: {path}, "
                                 f"serial {serial_path}")
        for loop, own in (("persistent", path), ("serial", serial_path)):
            others = {k: v for k, v in launches[loop].items() if k not in own}
            if others:
                raise AssertionError(f"the {model.name} {loop} loop launched other kernels: "
                                     f"{others}")
        return {"requests": requests, "kernel_launches": path,
                "search_launches": totals["persistent"]["launches"],
                "blocking_syncs": totals["persistent"]["blocking_syncs"],
                "persistent_steps": totals["persistent"]["persistent_steps"],
                "serial": {"kernel_launches": serial_path,
                           "search_launches": totals["serial"]["launches"],
                           "blocking_syncs": totals["serial"]["blocking_syncs"]}}

    # 5. cancel (md5), under both loops -----------------------------------
    def cancel():
        out = {}
        for loop in ("persistent", "serial"):
            backend = get_backend("auto", loop=loop)
            t0 = time.monotonic()
            res = backend.search(bytes([9, 9, 9, 9]), 16, thread_bytes(0, worker_bits(1)),
                                 lambda: time.monotonic() - t0 > 1.0)
            t_ret = time.monotonic() - t0
            torch.cuda.synchronize()
            if res is not None:
                raise AssertionError(f"cancelled {loop} search returned {res!r}")
            # drained_s - return_s: the device's work left behind the return
            out[loop] = {"returned": None, "time_to_cancel_s": t_ret - 1.0, "return_s": t_ret,
                         "drained_s": time.monotonic() - t0}
        return {**out["persistent"], "loop": "persistent", "serial": out["serial"]}

    # 6. rate -----------------------------------------------------------
    def rate(model):
        nonce, width = bytes([1, 2, 3, 4]), 4
        spec = build_tail_spec(nonce, width, model)
        ops = step_operands(spec, RATE_DIFFICULTY, model, 0, 256, dev)
        batch, steps, chunk0 = MAIN_BATCH, main_steps(model), MAIN_CHUNK0
        n = batch * steps
        grid = default_grid(n, smoke.info["device"]["sm_count"])

        def launch():
            return hash_search(model, ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, steps,
                               device=dev)

        first = sync_value(launch())  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with SmClock() as clock:
            start.record()
            for _ in range(RATE_LAUNCHES):
                launch()
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end) / RATE_LAUNCHES

        # the persistent form of the same launch, no hit and no flag: every
        # segment runs; timed between two more readings of the solo launch,
        # on the grid the backends give it (one_wave_for: not expected to
        # hold a hit, so the serial kernel's) and on one resident wave
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        rule = one_wave_for(n, RATE_DIFFICULTY)

        def persistent(one_wave=rule):
            return hash_persistent_search(model, ops, spec.tb_loc, spec.chunk_locs, chunk0,
                                          batch, steps, zero, device=dev, one_wave=one_wave)

        def persistent_one_wave():
            return persistent(True)

        for words in (persistent(), persistent_one_wave()):
            torch.cuda.synchronize()
            if [u32_value(v) for v in words] != [first, steps if first == SENTINEL else
                                                 first // batch + 1]:
                raise AssertionError(f"persistent launch {words.tolist()}, solo {first}")
        persistent_runs = {"solo": [], "persistent": [], "persistent_one_wave": []}
        for form, fn in (("solo", launch), ("persistent", persistent),
                         ("persistent_one_wave", persistent_one_wave),
                         ("persistent_one_wave", persistent_one_wave), ("persistent", persistent),
                         ("solo", launch)):
            start.record()
            for _ in range(PERSISTENT_RATE_LAUNCHES):
                fn()
            end.record()
            end.synchronize()
            persistent_runs[form].append(start.elapsed_time(end) / PERSISTENT_RATE_LAUNCHES)
        persistent_ms = min(persistent_runs["persistent"])

        # the plain version on the same inputs: no yardstick of speed, it
        # repeats the kernel's arithmetic in 10^3-10^4 elementwise torch ops;
        # timed over the launch's first 1/RATE_PLAIN_PART sub-batches, on
        # which it judges the kernel's result (the launch's first hit where
        # it lies there, else none)
        small = 1 << 16
        plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, small, 1, model=model)
        start.record()
        plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, small, 1, model=model)
        end.record()
        end.synchronize()
        plain_small_ms = start.elapsed_time(end)
        part = max(1, steps // RATE_PLAIN_PART)
        start.record()
        plain_part = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch,
                                            part, model=model))
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        if plain_part != (first if first < batch * part else SENTINEL):
            raise AssertionError(f"the launch's first {part} sub-batches: kernel {first} != "
                                 f"plain {plain_part}")

        # the bound: the operations the hash needs per candidate (no hit at
        # this difficulty, so every candidate is hashed) at the issue rate;
        # the kernel's own SASS loop count is a diagnostic beside it, at the
        # issue rate (sass_issue_ms), its ALU-pipe instructions at that
        # pipe's rate (alu_pipe_ms) and its FMA-pipe slots at that pipe's
        # (fma_pipe_ms): the larger of the two is the pace the loop can keep
        mw = mask_words_for(RATE_DIFFICULTY, model)
        var_words = {model.words_per_block * b + w for b, w, _ in (spec.tb_loc, *spec.chunk_locs)}
        needed = needed_ops(model.name, spec.n_blocks, mw, var_words)
        dev_info = smoke.info["device"]
        key = timed_key(model.name, kernel_mask_words(mw, model), spec.n_blocks,
                        kernel_layout(spec.tb_loc, spec.chunk_locs, model)[0])
        loop = issued[KERNELS[model.name]][key]
        sass, pipes = sum(loop.values()), pipe_split(loop)
        clocks_per_s = dev_info["sm_count"] * dev_info["clock_mhz"] * 1e6
        ops_per_s = ISSUED_RESULTS_PER_CLOCK_PER_SM * clocks_per_s
        bound_ms = n * needed / ops_per_s * 1e3
        return {"difficulty": RATE_DIFFICULTY, "mask_words": mw, "candidates_per_launch": n,
                "launch_steps": steps, "grid": grid, "launches_timed": RATE_LAUNCHES,
                "ms": ms, "ghs": n / ms / 1e6, "result": first,
                "persistent_ms": persistent_ms, "persistent_runs": persistent_runs,
                "persistent_over_solo": persistent_ms / min(persistent_runs["solo"]),
                "persistent_one_wave": rule,
                "persistent_one_wave_ms": min(persistent_runs["persistent_one_wave"]),
                "sm_clock_mhz_timed": clock.mhz,
                "plain_ms_part": plain_ms, "plain_sub_batches": part,
                "plain_part_of_launch": part / steps,
                "plain_ms_2p16_no_yardstick": plain_small_ms,
                "needed_ops_per_hash": needed, "bound_ms": bound_ms,
                "bound_ghs": n / bound_ms / 1e6, "bound_share": bound_ms / ms,
                "sass_instructions_per_hash": sass,
                "sass_loop_instructions": sum(loops[KERNELS[model.name]][key].values()),
                "alu_pipe_instructions_per_hash": pipes["alu"],
                "fma_pipe_instructions_per_hash": pipes["fma"],
                "sass_issue_ms": n * sass / ops_per_s * 1e3,
                "fma_pipe_slots_per_hash": pipes["fma_slots"],
                **pipe_ms(pipes, n, clocks_per_s),
                "card": dev_info["nvidia_smi"]}

    # 7. group_parity: the group kernel against the plain group step -----
    def group_rows(model, nonces, vw, extra, masks, log_tbc, tb_lo, chunk0):
        """A group's tail layout and its slots' operands on the card."""
        specs = [build_tail_spec(n, vw, model, extra) for n in nonces]
        if len({(sp.n_blocks, sp.tb_loc, sp.chunk_locs) for sp in specs}) != 1:
            raise AssertionError("the slots of a group must share one tail layout")
        ops = group_operands([sp.init_state for sp in specs], [sp.base_words for sp in specs],
                             masks, tb_lo, log_tbc, [c & 0xFFFFFFFF for c in chunk0], dev)
        return specs[0], ops

    def group_parity(model, seed, nonce_lens):
        import numpy as np

        rng = np.random.default_rng(seed)
        mismatches, cases, slots, hits, max_err, tails, i = [], 0, 0, 0, 0, set(), 0
        for wcase in GROUP_WIDTHS:
            # width 5: a width-4 run below one fixed high chunk byte
            vw, extra = (4, bytes([int(rng.integers(1, 256))])) if wcase == 5 else (wcase, b"")
            for n_slots in GROUP_SLOTS:
                for half in (0, 1):
                    n_len = nonce_lens[(2 * i + half) % len(nonce_lens)]
                    log_batch = GROUP_LOG_BATCH[i % len(GROUP_LOG_BATCH)]
                    i += 1
                    batch = 1 << log_batch
                    nonces = [rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes()
                              for _ in range(n_slots)]
                    ds = [int(rng.integers(1, min(8, model.max_difficulty) + 1))
                          for _ in range(n_slots)]
                    if n_slots == GROUP_SLOTS[-1]:
                        ds[-1] = model.max_difficulty  # a check over every digest word
                    logs = [GROUP_LOG_TBC[int(rng.integers(0, len(GROUP_LOG_TBC)))]
                            for _ in range(n_slots)]
                    tb_lo = [int(rng.integers(0, 256 >> lg)) << lg for lg in logs]
                    if vw == 0:
                        chunk0 = [0] * n_slots
                    elif vw == 4:
                        # every other slot's run wraps past 2^32
                        chunk0 = [(1 << 32) - int(rng.integers(1, 1 << (log_batch - lg + 1)))
                                  if s % 2 else int(rng.integers(0, 1 << 32))
                                  for s, lg in enumerate(logs)]
                    else:
                        lo = 256 ** (vw - 1)
                        chunk0 = [lo + int(rng.integers(0, 256 ** vw - lo)) for _ in logs]
                    spec, ops = group_rows(model, nonces, vw, extra,
                                           [nibble_masks(d, model) for d in ds], logs, tb_lo,
                                           chunk0)
                    tails.add(spec.n_blocks)
                    got = hash_group_search(model, ops, spec.tb_loc, spec.chunk_locs, batch,
                                            device=dev)
                    torch.cuda.synchronize()
                    got = [v & 0xFFFFFFFF for v in got.tolist()]
                    want = plain_group_search(model, ops, spec.tb_loc, spec.chunk_locs,
                                              batch).tolist()
                    cases += 1
                    slots += n_slots
                    hits += sum(w != SENTINEL for w in want)
                    max_err = max([max_err] + [abs(g - w) for g, w in zip(got, want)])
                    if got != want:
                        mismatches.append({"width": wcase, "slots": n_slots, "nonce_len": n_len,
                                           "batch": batch, "kernel": got, "plain": want})
        if mismatches:
            raise AssertionError(f"{len(mismatches)} of {cases} group launches differ: "
                                 f"{mismatches[:5]}")
        if tails != {1, 2} or not 0 < hits < slots:
            raise AssertionError(f"the grid missed a case: tails {tails}, {hits} of {slots} "
                                 f"slots hit")
        return {"launches": cases, "slots": slots, "mismatches": 0, "hit_slots": hits,
                "sentinel_slots": slots - hits, "tails": sorted(tails), "max_abs_err": max_err,
                "tolerance": "exact (integer first-hit index per slot)"}

    # 7b. group_full_parity: the scheduler's launch shape (8 slots x 2^20,
    # the wrapper's grid) against the plain group step, on slots whose first
    # hits lie deep in their range and in the grid's later blocks -----------
    def group_full_parity(model, seed, nonce_lens):
        import numpy as np

        rng = np.random.default_rng(seed)
        gx = group_grid(SCHED_BATCH, SCHED_SLOTS, smoke.info["device"]["sm_count"])
        stride = gx * BLOCK_THREADS
        d_bits = 32 * model.digest_words

        def deep(f):
            return f != SENTINEL and f >= SCHED_BATCH // 2 and \
                (f % stride) // BLOCK_THREADS >= gx // 2

        def draw(n_len, vw, k):
            """One slot: a random nonce and run, and 20 mask bits: the last
            five nibbles (a difficulty-5 request) for even k, else bits spread
            over every digest word."""
            lg = GROUP_LOG_TBC[int(rng.integers(0, len(GROUP_LOG_TBC)))]
            if k % 2 == 0:
                masks = list(nibble_masks(5, model))
            else:
                masks = [0] * model.digest_words
                for b in rng.choice(d_bits, size=GROUP_MASK_BITS, replace=False):
                    masks[b // 32] |= 1 << (b % 32)
            if vw == 4 and k % 4 == 1:  # the run wraps past 2^32
                chunk0 = (1 << 32) - int(rng.integers(1, SCHED_BATCH >> lg))
            else:
                lo = 256 ** (vw - 1)
                chunk0 = lo + int(rng.integers(0, 256 ** vw - lo))
            return (rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes(), masks, lg,
                    int(rng.integers(0, 256 >> lg)) << lg, chunk0)

        def launch(slots, vw):
            spec, ops = group_rows(model, [s[0] for s in slots], vw, b"", [s[1] for s in slots],
                                   [s[2] for s in slots], [s[3] for s in slots],
                                   [s[4] for s in slots])
            got = hash_group_search(model, ops, spec.tb_loc, spec.chunk_locs, SCHED_BATCH,
                                    device=dev)
            torch.cuda.synchronize()
            return spec, ops, [v & 0xFFFFFFFF for v in got.tolist()]

        layouts, max_err = [], 0
        for vw, n_blocks in ((3, 1), (4, 2)):
            n_len = next(n for n in nonce_lens
                         if build_tail_spec(bytes(n), vw, model).n_blocks == n_blocks)
            pool = [draw(n_len, vw, k) for k in range(GROUP_POOL_SLOTS)]
            found = []
            for i in range(0, GROUP_POOL_SLOTS, SCHED_SLOTS):
                found += launch(pool[i:i + SCHED_SLOTS], vw)[2]
            deep_k = [k for k, f in enumerate(found) if deep(f)]
            if len(deep_k) < GROUP_DEEP_SLOTS:
                raise AssertionError(f"the kernel found {len(deep_k)} deep first hits in "
                                     f"{GROUP_POOL_SLOTS} slots, not {GROUP_DEEP_SLOTS}")
            # the deep slots, two with earlier hits, and misses, in a random order
            rest = [k for k in range(GROUP_POOL_SLOTS) if k not in deep_k]
            shallow = [k for k in rest if found[k] != SENTINEL][:2]
            chosen = deep_k[:SCHED_SLOTS // 2] + shallow
            chosen += [k for k in rest if k not in shallow][:SCHED_SLOTS - len(chosen)]
            chosen = [chosen[j] for j in rng.permutation(len(chosen))]
            spec, ops, got = launch([pool[k] for k in chosen], vw)
            want = plain_group_search(model, ops, spec.tb_loc, spec.chunk_locs,
                                      SCHED_BATCH).tolist()
            max_err = max([max_err] + [abs(g - w) for g, w in zip(got, want)])
            if got != want:
                raise AssertionError(f"width {vw}, {n_blocks}-block tail: kernel {got}, "
                                     f"plain {want}")
            n_deep = sum(deep(w) for w in want)
            if n_deep < GROUP_DEEP_SLOTS or spec.n_blocks != n_blocks:
                raise AssertionError(f"width {vw}: {n_deep} deep first hits in the judged "
                                     f"launch, {spec.n_blocks}-block tail")
            layouts.append({"width": vw, "nonce_len": n_len, "n_blocks": n_blocks,
                            "kernel": got, "plain": want, "deep_slots": n_deep,
                            "hit_slots": sum(w != SENTINEL for w in want),
                            "fraction_of_range": [w / SCHED_BATCH if w != SENTINEL else None
                                                  for w in want],
                            "block": [(w % stride) // BLOCK_THREADS if w != SENTINEL else None
                                      for w in want],
                            "pool_deep_slots": len(deep_k)})
        return {"slots": SCHED_SLOTS, "batch": SCHED_BATCH, "grid_x": gx,
                "pool_slots": GROUP_POOL_SLOTS, "layouts": layouts, "mismatches": 0,
                "max_abs_err": max_err, "tolerance": "exact (integer first-hit index per slot)"}

    # 8. rate_group: one engine launch of 8 slots x batch -----------------
    def rate_group(model):
        kernel = KERNELS[model.name]
        nonces = [bytes([1, 2, 3, 4 + s]) for s in range(SCHED_SLOTS)]
        spec, ops = group_rows(model, nonces, 4, b"", [nibble_masks(RATE_DIFFICULTY, model)] *
                               SCHED_SLOTS, [8] * SCHED_SLOTS, [0] * SCHED_SLOTS,
                               [MAIN_CHUNK0 + (SCHED_BATCH >> 8) * s for s in range(SCHED_SLOTS)])

        def launch():
            return hash_group_search(model, ops, spec.tb_loc, spec.chunk_locs, SCHED_BATCH,
                                     device=dev)

        first = [v & 0xFFFFFFFF for v in launch().tolist()]  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(RATE_LAUNCHES):
            launch()
        end.record()
        end.synchronize()
        kernel_ms = start.elapsed_time(end) / RATE_LAUNCHES
        # the plain group step on the same inputs, the judge of the result
        start.record()
        plain = plain_group_search(model, ops, spec.tb_loc, spec.chunk_locs, SCHED_BATCH)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        if plain.tolist() != first:
            raise AssertionError(f"kernel {first} != plain {plain.tolist()}")

        # the engine: 8 difficulty-16 slots (no hit) for a window of launches
        m = Metrics()
        eng = BatchingScheduler(hash_model=model.name, batch_size=SCHED_BATCH,
                                max_slots=SCHED_SLOTS, start=False, metrics=m)
        slots = [eng.submit(bytes([7, 7, 7, s]), RATE_DIFFICULTY, range(256))
                 for s in range(SCHED_SLOTS)]
        eng.start()
        try:
            time.sleep(0.5)  # past widths 0-2: every launch then has the timed shape
            l0, t0 = m.get("sched.launches"), time.monotonic()
            time.sleep(RATE_GROUP_WINDOW_S)
            l1, t1 = m.get("sched.launches"), time.monotonic()
            for s in slots:
                s.cancel()
            if any(s.result(timeout=60) is not None for s in slots):
                raise AssertionError("a difficulty-16 slot found a secret")
        finally:
            eng.close()
        if l1 <= l0:
            raise AssertionError("the engine made no launch in the window")
        host_ms = (t1 - t0) * 1e3 / (l1 - l0)
        n = SCHED_SLOTS * SCHED_BATCH
        d = model.digest_words
        var_words = {model.words_per_block * b + w for b, w, _ in (spec.tb_loc, *spec.chunk_locs)}
        needed = needed_ops(model.name, spec.n_blocks, d, var_words)
        dev_info = smoke.info["device"]
        clocks_per_s = dev_info["sm_count"] * dev_info["clock_mhz"] * 1e6
        bound_ms = n * needed / (ISSUED_RESULTS_PER_CLOCK_PER_SM * clocks_per_s) * 1e3
        gkey = group_key(model.name, spec.n_blocks,
                         kernel_layout(spec.tb_loc, spec.chunk_locs, model)[0])
        loop = group_issued[kernel][gkey]
        pipes = pipe_split(loop)
        return {"difficulty": RATE_DIFFICULTY, "slots": SCHED_SLOTS, "batch": SCHED_BATCH,
                "candidates_per_launch": n, "launches_timed": RATE_LAUNCHES,
                "kernel_ms": kernel_ms, "ghs": n / kernel_ms / 1e6, "result": first,
                "plain_ms": plain_ms, "engine_launches": l1 - l0,
                "engine_window_s": t1 - t0, "host_ms_per_engine_launch": host_ms,
                "device_idle_share": max(0.0, 1 - kernel_ms / host_ms),
                "needed_ops_per_hash": needed, "bound_ms": bound_ms,
                "bound_share": bound_ms / kernel_ms,
                "sass_instructions_per_hash": sum(loop.values()),
                "sass_loop_instructions": sum(group_loops[kernel][gkey].values()),
                "alu_pipe_instructions_per_hash": pipes["alu"],
                "fma_pipe_slots_per_hash": pipes["fma_slots"],
                **pipe_ms(pipes, n, clocks_per_s), "card": dev_info["nvidia_smi"]}

    # 9. sched_*: concurrent requests through the batching scheduler ------
    def sched_serve(default, requests, extra=(), refuse=None, min_occupancy=1, lane="auto",
                    mesh=None):
        """``requests``: (model, nonce, difficulty, thread bytes), one thread
        each, all released together on one scheduler (on ``lane``, with
        ``mesh`` for the mesh lane); the launch counts are set to 0 just
        before and read just after.  Each secret is checked with hashlib and
        against the solo backend's for the same request."""
        m = Metrics()
        eng = BatchingScheduler(hash_model=default, batch_size=SCHED_BATCH,
                                max_slots=SCHED_SLOTS, extra_models=extra, metrics=m,
                                lane=lane, mesh=mesh)
        results, errors = [None] * len(requests), []
        barrier = threading.Barrier(len(requests))

        def client(i):
            model_name, nonce, d, tbs = requests[i]
            try:
                barrier.wait(timeout=60)
                t0 = time.monotonic()
                secret = eng.search(nonce, d, tbs, hash_model=model_name)
                results[i] = (secret, time.monotonic() - t0)
            except Exception as exc:  # surfaced below through errors
                errors.append(f"request {i}: {exc!r}")

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(requests))]
        for counter in LAUNCHES.values():
            counter.reset()
        # a synchronizing CUDA call (a blocking copy, a stream or device
        # synchronize) raises on the scheduler's loop and fails the requests;
        # the one wait per engine launch is an event's, which this does not see
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches = {k: c.value for k, c in LAUNCHES.items()}
        counts = {k: m.get(k) for k in ("sched.launches", "sched.mixed_hash_launches",
                                        "sched.lane_launches.cuda", "sched.lane_launches.mesh",
                                        "sched.lane_launches.torch",
                                        "sched.fallback_searches", "search.blocking_syncs",
                                        "search.found")}
        occupancy = m.get_observed("sched.batch_occupancy")
        refused = None
        try:
            if refuse is not None:
                try:
                    eng.search(*refuse[1:], hash_model=refuse[0])
                except ValueError as exc:
                    refused = str(exc)
                else:
                    raise AssertionError(f"the scheduler served {refuse[0]}")
        finally:
            eng.close()
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"requests failed or hung: {errors}")
        out = []
        for (model_name, nonce, d, tbs), (secret, wall) in zip(requests, results):
            h = puzzle.new_hash(model_name)
            h.update(nonce + (secret or b""))
            digest = h.hexdigest()
            solo = CudaBackend(hash_model=model_name, device=dev).search(nonce, d, tbs)
            if secret is None or not digest.endswith("0" * d) or secret[0] not in tbs:
                raise AssertionError(f"{model_name} {nonce.hex()} d{d}: {secret!r} ({digest})")
            if secret != solo:
                raise AssertionError(f"{model_name} {nonce.hex()} d{d}: scheduler "
                                     f"{secret.hex()} != solo {solo.hex()}")
            out.append({"model": model_name, "nonce": nonce.hex(), "difficulty": d,
                        "thread_bytes": [tbs[0], len(tbs)], "secret": secret.hex(),
                        model_name: digest, "solo_secret": solo.hex(), "wall_s": wall})
        served = {KERNELS[r[0]] for r in requests}
        group = {k: launches[f"{k}_group"] for k in sorted(served)}
        if min(group.values()) <= 0:
            raise AssertionError(f"a group kernel of the path was launched no time: {group}")
        solo_launches = {k: launches[k] for k in KERNELS.values() if launches[k]}
        if solo_launches or counts["sched.lane_launches.torch"]:
            raise AssertionError(f"the scheduler path left its group kernels: solo "
                                 f"{solo_launches}, torch lane "
                                 f"{counts['sched.lane_launches.torch']}")
        if occupancy["max"] < min_occupancy:
            raise AssertionError(f"occupancy reached {occupancy['max']}, not {min_occupancy}")
        return {"requests": out, "group_launches": group, **counts,
                "batch_occupancy": occupancy, "refused": refused,
                "sync_debug_mode": "error"}

    def sched_md5_requests():
        import numpy as np

        rng = np.random.default_rng(SCHED_SEED)
        bits = worker_bits(4)
        reqs = []
        for i in range(SCHED_SLOTS):
            nonce = rng.integers(0, 256, size=4, dtype=np.uint8).tobytes()
            # two requests on a 4-way partition (64 thread bytes), at 5
            if i < 2:
                reqs.append(("md5", nonce, 5, thread_bytes(1 + 2 * i, bits)))
            else:
                reqs.append(("md5", nonce, int(rng.integers(5, 8)), thread_bytes(0, 0)))
        return reqs

    def sched_md5():
        return sched_serve("md5", sched_md5_requests(), min_occupancy=2)

    def sched_mixed():
        import numpy as np

        rng = np.random.default_rng(SCHED_SEED + 1)
        models = MIXED_MODELS + ("md5",)
        reqs = [(m, rng.integers(0, 256, size=6, dtype=np.uint8).tobytes(),
                 int(rng.integers(4, 6)), thread_bytes(0, 0)) for m in models]
        out = sched_serve("md5", reqs, extra=MIXED_MODELS[1:],
                          refuse=("sha512", bytes([9, 2]), 2, thread_bytes(0, 0)))
        if out["sched.mixed_hash_launches"] < 1 or not out["refused"] or \
                "never admitted" not in out["refused"]:
            raise AssertionError(f"no mixed launch, or sha512 not refused: {out['refused']}")
        return out

    def sched_wide(model_name):
        reqs = [(model_name, bytes([0x51, 0x52, s]), 4, thread_bytes(0, 0)) for s in range(2)]
        return sched_serve(model_name, reqs)

    # 10. sched_cancel ------------------------------------------------------
    def sched_cancel():
        eng = BatchingScheduler(hash_model="md5", batch_size=SCHED_BATCH, max_slots=SCHED_SLOTS,
                                metrics=Metrics())
        flagged = []
        t0 = time.monotonic()

        def cancel_check():
            if time.monotonic() - t0 > 1.0:
                flagged.append(time.monotonic())
                return True
            return False

        try:
            res = eng.search(bytes([9, 9, 9, 9]), 16, thread_bytes(0, 0), cancel_check)
            t_ret = time.monotonic()
        finally:
            eng.close()
        if res is not None or not flagged:
            raise AssertionError(f"cancelled request returned {res!r}")
        # the first request of a fresh process after CudaBackend.warmup, with a
        # build directory that holds nothing yet
        fresh = os.path.join(HERE, "distpow_tpu_torch", "build", f"fresh-{os.getpid()}")
        try:
            proc = subprocess.run([sys.executable, "-c", WARM_CANCEL, HERE],
                                  env={**os.environ, "DISTPOW_TORCH_BUILD_DIR": fresh},
                                  capture_output=True, text=True, timeout=600)
        finally:
            shutil.rmtree(fresh, ignore_errors=True)
        if proc.returncode != 0:
            raise AssertionError(f"warm-up process failed: {proc.stderr[-3000:]}")
        warm = json.loads(proc.stdout.strip().splitlines()[-1])
        if warm["returned"] is not None or warm["build_s"] <= 0 or \
                not warm["build_dir_was_empty"]:
            raise AssertionError(f"warm-up process: {warm}")
        # from the moment the cancel condition holds (the solo cancel phase's
        # measure), and from the loop's first poll that saw it
        return {"time_to_cancel_s": t_ret - t0 - 1.0, "poll_to_return_s": t_ret - flagged[0],
                "return_s": t_ret - t0, "after_warmup_fresh_process": warm}

    # 11. the mesh kernels ---------------------------------------------------
    def shard_devices(n):
        """Logical shards on cuda:0, or one a card where there are more."""
        return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]

    def shard_operands(spec, d, model, shards, mesh):
        return [step_operands(spec, d, model, sh.tb_lo, sh.tb_count, dv)
                for sh, dv in zip(shards, mesh.devices)]

    def mesh_parity(model, seed, nonce_lens):
        import numpy as np

        rng = np.random.default_rng(seed)
        meshes = {}
        cases = []  # (label, spec, d, shards, origin, solo ops, candidates)
        i = 0
        for n_dev, tb_lo, tbc in MESH_LAYOUTS:
            mesh = meshes.setdefault(n_dev, make_mesh(shard_devices(n_dev)))
            for width in range(5):
                n_len = nonce_lens[int(rng.integers(0, len(nonce_lens)))]
                nonce = rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes()
                d = MESH_DIFFICULTIES[i % len(MESH_DIFFICULTIES)]
                steps = LAUNCH_STEPS[i % 2]
                i += 1
                spec = build_tail_spec(nonce, width, model)
                if width == 0:
                    chunk0, shards = 0, mesh_search._width0_probe(tb_lo, tbc)
                else:
                    split = mesh_search.tb_split_regime(tbc, n_dev)
                    per_launch = tbc * (1 if split else n_dev)
                    chunks_local = max(1, MESH_CASE_CANDIDATES // per_launch)
                    # segment start, or a launch that runs past the width's end
                    chunk0 = 256 ** (width - 1) if i % 2 else 256 ** width - 5
                    shards = mesh_search.mesh_shards(tb_lo, tbc, chunk0, n_dev, chunks_local,
                                                     steps)
                origin = MeshOrigin(chunk0, tb_lo, tbc)
                n = sum(sh.batch * sh.launch_steps for sh in shards)
                cases.append((f"s{n_dev}_tbc{tbc}_w{width}_n{n_len}_d{d}_k{steps}", spec, d, mesh,
                              shards, origin, n))
        got, solo = [], []
        for _, spec, d, mesh, shards, origin, n in cases:
            got.append(mesh_search.mesh_launch(mesh, model, shard_operands(spec, d, model, shards,
                                                                           mesh),
                                               spec.tb_loc, spec.chunk_locs, shards, origin))
            # the solo kernel on the same launch: the shards cover its candidates
            ops = step_operands(spec, d, model, origin.tb_lo, origin.tbc, dev)
            solo.append(hash_search(model, ops, spec.tb_loc, spec.chunk_locs, origin.chunk0, n, 1,
                                    device=dev))
        torch.cuda.synchronize()
        # the plain version: every shard's plain search, the cases of one
        # layout in one evaluation (judge_cases), mapped to the partition
        flat = [(case, sh) for case in cases for sh in case[4]]
        plain_local = judge_cases(model, [
            (step_operands(spec, d, model, sh.tb_lo, sh.tb_count, dev), spec, sh.chunk0,
             sh.batch * sh.launch_steps) for (_, spec, d, *_), sh in flat])
        want = collections.defaultdict(lambda: SENTINEL)
        for ((label, *_, origin, _n), sh), f in zip(flat, plain_local):
            if f != SENTINEL:
                want[label] = min(want[label], partition_index(f, sh.tb_lo, sh.tb_count,
                                                               sh.chunk0, origin))
        mismatches, hits, tails, max_err = [], 0, set(), 0
        for (label, spec, *_), g, so in zip(cases, got, solo):
            g, so, w = u32_value(g), u32_value(so), want[label]
            tails.add(spec.n_blocks)
            hits += w != SENTINEL
            max_err = max(max_err, abs(g - w))
            if not g == so == w:
                mismatches.append({"case": label, "mesh": g, "solo": so, "plain": w})
        # plain_mesh_search itself, on two cases: a thread-byte split into
        # runs of 12 and a chunk split of a run of 3, each the case of its
        # layout with the latest first hit
        direct = []
        for prefix in ("s8_tbc96_", "s8_tbc3_"):
            label, spec, d, mesh, shards, origin, n = max(
                (c for c in cases if c[0].startswith(prefix)),
                key=lambda c: (want[c[0]] != SENTINEL, want[c[0]] % SENTINEL))
            ops = step_operands(spec, d, model, origin.tb_lo, origin.tbc, dev)
            v = u32_value(plain_mesh_search(ops, spec.tb_loc, spec.chunk_locs, shards, origin,
                                            model=model))
            direct.append({"case": label, "plain_mesh_search": v, "judge": want[label]})
            if v != want[label]:
                mismatches.append(direct[-1])
        if mismatches:
            raise AssertionError(f"{len(mismatches)} of {len(cases)} cases differ: "
                                 f"{mismatches[:10]}")
        if tails != {1, 2} or not 0 < hits < len(cases) or len(direct) != 2:
            raise AssertionError(f"the grid missed a case: tails {tails}, {hits} of "
                                 f"{len(cases)} hit, {len(direct)} direct checks")
        return {"cases": len(cases), "mismatches": 0, "hit_cases": hits,
                "sentinel_cases": len(cases) - hits, "tails": sorted(tails),
                "plain_mesh_search": direct, "max_abs_err": max_err,
                "tolerance": "exact (integer first-hit index)"}

    def mesh_main_step(model, mesh, nonce, d, tbc):
        """The mesh step the driver plans for the worker's width-4 launch
        of ``nonce`` on the run [0, tbc): ``(step, candidates)``."""
        budget = CudaBackend(hash_model=model.name, device=dev).max_launch
        target = MAIN_BATCH // tbc
        k = launch_steps_for(4, target, tbc, budget)
        step, chunks = mesh_search._cuda_mesh_step_factory(nonce, d, 0, tbc, model, mesh,
                                                          max_launch=budget)(4, b"", target, k)
        return step, chunks * tbc

    def mesh_timed(model, mesh):
        """The worker's main-path launch on the mesh at difficulty 16 (no
        hit): the mesh kernels and the solo kernel on the same candidates,
        timed alike (the lower of two readings each), and the bound."""
        nonce = bytes([1, 2, 3, 4])
        step, n = mesh_main_step(model, mesh, nonce, RATE_DIFFICULTY, 256)
        spec = build_tail_spec(nonce, 4, model)
        ops = step_operands(spec, RATE_DIFFICULTY, model, 0, 256, dev)
        forms = {"mesh": lambda: step(MAIN_CHUNK0),
                 "solo": lambda: hash_search(model, ops, spec.tb_loc, spec.chunk_locs,
                                             MAIN_CHUNK0, n, 1, device=dev)}
        first = {k: sync_value(f()) for k, f in forms.items()}
        if first["mesh"] != first["solo"]:
            raise AssertionError(f"timed launch: {first}")
        ms = {}
        for name in ("mesh", "solo", "mesh", "solo"):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(MESH_RATE_LAUNCHES):
                forms[name]()
            end.record()
            end.synchronize()
            ms.setdefault(name, []).append(start.elapsed_time(end) / MESH_RATE_LAUNCHES)
        mw = mask_words_for(RATE_DIFFICULTY, model)
        var_words = {model.words_per_block * b + w for b, w, _ in (spec.tb_loc, *spec.chunk_locs)}
        needed = needed_ops(model.name, spec.n_blocks, mw, var_words)
        dev_info = smoke.info["device"]
        clocks_per_s = dev_info["sm_count"] * dev_info["clock_mhz"] * 1e6
        bound_ms = n * needed / (ISSUED_RESULTS_PER_CLOCK_PER_SM * clocks_per_s) * 1e3
        loop = mesh_issued[KERNELS[model.name]][timed_key(
            model.name, kernel_mask_words(mw, model), spec.n_blocks,
            kernel_layout(spec.tb_loc, spec.chunk_locs, model)[0])]
        return {"shards": mesh.size, "candidates": n, "difficulty": RATE_DIFFICULTY,
                "launches_timed": MESH_RATE_LAUNCHES, "result": first["mesh"],
                "ms": min(ms["mesh"]), "ms_runs": ms["mesh"],
                "solo_ms": min(ms["solo"]), "solo_ms_runs": ms["solo"],
                "mesh_over_solo": min(ms["mesh"]) / min(ms["solo"]),
                "needed_ops_per_hash": needed, "bound_ms": bound_ms,
                "sass_instructions_per_hash": sum(loop.values()),
                "card": dev_info["nvidia_smi"]}

    def mesh_full_parity(model):
        mesh = make_mesh(shard_devices(MESH_SHARDS))
        steps = main_steps(model)
        n = MAIN_BATCH * steps
        fp = smoke.info[f"full_parity{suffix(model.name)}"]

        def solo(nonce, d, tbc, n):
            spec = build_tail_spec(nonce, 4, model)
            ops = step_operands(spec, d, model, 0, tbc, dev)
            return sync_value(hash_search(model, ops, spec.tb_loc, spec.chunk_locs, MAIN_CHUNK0,
                                          n, 1, device=dev))

        # full_parity's nonce: its difficulty-7 first hit lies in the
        # launch's second half and in the second half of the shards (thread
        # byte >= 128), and full_parity's plain version judged it and the
        # difficulty-6 one on the same candidates; on the run of 2 (chunk
        # split) difficulties 6 and 5, so that its smaller range holds a hit
        nonce = bytes.fromhex(fp["nonce"])
        judged = {c["difficulty"]: c["plain"] for c in fp["cases"]}
        cases, max_err = [], 0
        # the full run (thread-byte split) and a run of 2 (chunk split)
        for tbc, difficulties in ((256, (7, 6)), (2, (6, 5))):
            for d in difficulties:
                step, cand = mesh_main_step(model, mesh, nonce, d, tbc)
                if tbc == 256 and cand != n:
                    raise AssertionError(f"the mesh step covers {cand}, the driver's launch {n}")
                got = sync_value(step(MAIN_CHUNK0))
                want = solo(nonce, d, tbc, cand)
                plain = judged[d] if tbc == 256 else None
                max_err = max(max_err, abs(got - want),
                              0 if plain is None else abs(got - plain))
                shard = (got % tbc) * MESH_SHARDS // tbc if tbc == 256 else \
                    got // (cand // MESH_SHARDS)
                cases.append({"tbc": tbc, "difficulty": d, "candidates": cand, "mesh": got,
                              "solo": want, "plain": plain, "fraction_of_launch": got / cand,
                              "shard": shard})
                # every case but the run of 2 at difficulty 6 holds a hit
                if got != want or (plain is not None and got != plain) or \
                        (want == SENTINEL and (tbc, d) != (2, 6)):
                    raise AssertionError(f"tbc {tbc}, difficulty {d}: mesh {got}, solo {want}, "
                                         f"plain {plain}")
        if cases[0]["shard"] < MESH_SHARDS // 2:
            raise AssertionError(f"the deep hit lies in shard {cases[0]['shard']}")
        # the plain mesh step, timed, on the sub-batch of the deep hit
        # (full run, difficulty 7) shard by shard: no hit before it in the
        # sub-batch (full_parity judged the sub-batches before it), the hit
        # at it
        spec = build_tail_spec(nonce, 4, model)
        ops = step_operands(spec, 7, model, 0, 256, dev)
        sub = cases[0]["mesh"] // MAIN_BATCH
        chunk0 = MAIN_CHUNK0 + sub * (MAIN_BATCH // 256)
        shards = mesh_search.mesh_shards(0, 256, chunk0, mesh.size, MAIN_BATCH // 256, 1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = u32_value(plain_mesh_search(ops, spec.tb_loc, spec.chunk_locs, shards,
                                            MeshOrigin(chunk0, 0, 256), model=model))
        end.record()
        end.synchronize()
        if plain == SENTINEL or sub * MAIN_BATCH + plain != cases[0]["mesh"]:
            raise AssertionError(f"deep-hit case: mesh {cases[0]['mesh']}, plain mesh step "
                                 f"{plain} in sub-batch {sub}")
        return {"nonce": nonce.hex(), "shards": MESH_SHARDS, "candidates": n,
                "launch_steps": steps, "cases": cases, "mismatches": 0,
                "max_abs_err": max_err, "tolerance": "exact (integer first-hit index)",
                "plain": {"tbc": 256, "difficulty": 7, "sub_batch": sub,
                          "result": sub * MAIN_BATCH + plain, "candidates": MAIN_BATCH,
                          "ms": start.elapsed_time(end)},
                "timed": mesh_timed(model, mesh)}

    def mine_mesh():
        mesh4 = make_mesh(shard_devices(MESH_SHARDS))
        nonce, full = bytes([1, 2, 3, 4]), thread_bytes(0, worker_bits(1))
        runs = []  # (how, model, nonce, d, thread bytes, secret, wall)

        def run(how, model_name, nonce, d, tbs, fn):
            t0 = time.monotonic()
            secret = fn()
            runs.append((how, model_name, nonce, d, tbs, secret, time.monotonic() - t0))

        def reset():
            for counter in LAUNCHES.values():
                counter.reset()
            REGISTRY.reset()

        def counted():
            return ({k: c.value for k, c in LAUNCHES.items() if c.value},
                    {k: REGISTRY.get(f"search.{k}") for k in
                     ("launches", "blocking_syncs", "persistent_steps")})

        # the main path, every count to 0 just before it and read just
        # after: the mesh backend's persistent loop (its default), through
        # the worker's backend over every visible GPU and on the 4 shards
        reset()
        backend = get_backend("pallas-mesh", hash_model="md5")
        if not isinstance(backend, CudaMeshBackend) or \
                backend.mesh.size != torch.cuda.device_count() or backend.loop != "persistent":
            raise AssertionError(f"pallas-mesh resolved to {backend!r} over {backend.mesh}")
        run("get_backend('pallas-mesh'), persistent", "md5", nonce, 6, full,
            lambda: backend.search(nonce, 6, full))
        for model_name in MODELS:
            be = CudaMeshBackend(hash_model=model_name, devices=mesh4.devices, device=dev)
            if be.loop != "persistent":
                raise AssertionError(f"CudaMeshBackend's loop is {be.loop}")
            run("CudaMeshBackend, persistent", model_name, nonce, 6, full,
                lambda: be.search(nonce, 6, full))
        launches, totals = counted()
        # the serial driver's mesh search (search_mesh) on its own, its
        # counts likewise
        reset()
        md5 = get_hash_model("md5")
        for d in (6, 8):
            run("search_mesh", "md5", nonce, d, full,
                lambda: mesh_search.search_mesh(nonce, d, full, mesh=mesh4, model=md5).secret)
        for model_name in MODELS[1:]:
            m = get_hash_model(model_name)
            run("search_mesh", model_name, nonce, 6, full,
                lambda: mesh_search.search_mesh(nonce, 6, full, mesh=mesh4, model=m).secret)
        # 4-way prefix split, each worker's search on the 4 shards in its own
        # thread and stream; the first result cancels the others
        nonce4, d4, bits = bytes([5, 6, 7, 8]), 8, worker_bits(4)
        done, results, errors = threading.Event(), [None] * 4, []

        def worker(i):
            try:
                with torch.cuda.stream(torch.cuda.Stream(dev)):
                    res = mesh_search.search_mesh(nonce4, d4, thread_bytes(i, bits), mesh=mesh4,
                                                  model=md5, cancel_check=done.is_set)
                    torch.cuda.current_stream(dev).synchronize()
                if res is not None:
                    results[i] = (time.monotonic(), res.secret)
                    done.set()
            except Exception as exc:  # surfaced below through errors
                errors.append(f"worker {i}: {exc!r}")
                done.set()

        t0 = time.monotonic()
        threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or errors:
            done.set()
            raise AssertionError(f"4-way split: {errors or 'a worker did not finish'}")
        found = sorted((r[0], i, r[1]) for i, r in enumerate(results) if r is not None)
        if not found:
            raise AssertionError("no 4-way worker found a secret")
        t_win, winner, secret4 = found[0]
        runs.append((f"search_mesh, 4-way split, worker {winner}", "md5", nonce4, d4,
                     thread_bytes(winner, bits), secret4, t_win - t0))
        serial_launches, serial_totals = counted()
        # the main path ran each mesh kernel (its width-0 probes) and its
        # persistent form; search_mesh the mesh kernels alone
        mesh_launches = {k: launches.get(f"{k}_mesh", 0) for k in KERNELS.values()}
        persistent_launches = {k: launches.get(f"{k}_mesh_persistent", 0)
                               for k in KERNELS.values()}
        serial_mesh_launches = {k: serial_launches.get(f"{k}_mesh", 0) for k in KERNELS.values()}
        if min(mesh_launches.values()) <= 0 or min(persistent_launches.values()) <= 0 or \
                min(serial_mesh_launches.values()) <= 0:
            raise AssertionError(f"a mesh kernel of the path was launched no time: "
                                 f"{mesh_launches}, {persistent_launches}, search_mesh "
                                 f"{serial_mesh_launches}")
        others = {k: v for k, v in launches.items()
                  if not k.endswith("_mesh") and not k.endswith("_mesh_persistent")}
        others.update({f"search_mesh {k}": v for k, v in serial_launches.items()
                       if not k.endswith("_mesh")})
        if others:
            raise AssertionError(f"the mesh path launched other kernels: {others}")
        out = []
        for how, model_name, nonce_r, d, tbs, secret, wall in runs:
            h = puzzle.new_hash(model_name)
            h.update(nonce_r + (secret or b""))
            digest = h.hexdigest()
            solo = CudaBackend(hash_model=model_name, device=dev).search(nonce_r, d, tbs)
            if secret is None or not digest.endswith("0" * d) or secret[0] not in tbs:
                raise AssertionError(f"{how} {model_name} d{d}: {secret!r} ({digest})")
            if secret != solo:
                raise AssertionError(f"{how} {model_name} d{d}: mesh {secret.hex()} != solo "
                                     f"{solo.hex()}")
            out.append({"how": how, "model": model_name, "difficulty": d, "secret": secret.hex(),
                        model_name: digest, "solo_secret": solo.hex(), "wall_s": wall})
        return {"requests": out, "mesh_kernel_launches": mesh_launches,
                "mesh_persistent_kernel_launches": persistent_launches,
                "search_launches": totals["launches"],
                "blocking_syncs": totals["blocking_syncs"],
                "persistent_steps": totals["persistent_steps"],
                "search_mesh": {"mesh_kernel_launches": serial_mesh_launches,
                                "search_launches": serial_totals["launches"],
                                "blocking_syncs": serial_totals["blocking_syncs"]},
                "shards": MESH_SHARDS, "shard_devices": [str(x) for x in mesh4.devices],
                "gpus_visible": torch.cuda.device_count(),
                "pallas_mesh_devices": [str(x) for x in backend.mesh.devices]}

    def rate_mesh():
        """md5's main-path launch on 4 shards against the solo kernel on the
        same candidates: device ms (CUDA events), host ms to enqueue one
        launch, and wall ms per launch with the driver's two launches in
        flight and one pinned fetch each, hence the device's idle share."""
        from distpow_tpu_torch.parallel.search import _enqueue_fetch

        model = get_hash_model("md5")
        mesh = make_mesh(shard_devices(MESH_SHARDS))
        nonce = bytes([1, 2, 3, 4])
        step, n = mesh_main_step(model, mesh, nonce, RATE_DIFFICULTY, 256)
        spec = build_tail_spec(nonce, 4, model)
        ops = step_operands(spec, RATE_DIFFICULTY, model, 0, 256, dev)
        forms = {"mesh": lambda: step(MAIN_CHUNK0),
                 "solo": lambda: hash_search(model, ops, spec.tb_loc, spec.chunk_locs,
                                             MAIN_CHUNK0, n, 1, device=dev)}
        first = {k: sync_value(f()) for k, f in forms.items()}
        if first["mesh"] != first["solo"]:
            raise AssertionError(f"mesh {first['mesh']} != solo {first['solo']}")
        out = {}
        for name in ("mesh", "solo", "mesh", "solo"):
            launch = forms[name]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            enqueue = []
            for _ in range(RATE_LAUNCHES):
                t0 = time.monotonic()
                launch()
                enqueue.append(time.monotonic() - t0)
            end.record()
            end.synchronize()
            inflight, t0 = collections.deque(), time.monotonic()
            for _ in range(RATE_LAUNCHES):
                inflight.append(_enqueue_fetch(launch()))
                if len(inflight) >= 2:
                    inflight.popleft()[1].synchronize()
            while inflight:
                inflight.popleft()[1].synchronize()
            wall = (time.monotonic() - t0) * 1e3 / RATE_LAUNCHES
            ms = start.elapsed_time(end) / RATE_LAUNCHES
            out.setdefault(name, []).append({"ms": ms, "host_ms_to_enqueue": 1e3 * sum(enqueue) /
                                             len(enqueue), "wall_ms_per_launch": wall,
                                             "device_idle_share": max(0.0, 1 - ms / wall)})
        mesh_ms = min(r["ms"] for r in out["mesh"])
        solo_ms = min(r["ms"] for r in out["solo"])
        return {"shards": MESH_SHARDS, "candidates_per_launch": n,
                "difficulty": RATE_DIFFICULTY, "launches_timed": RATE_LAUNCHES,
                "result": first["mesh"], "runs": out, "ms": mesh_ms, "solo_ms": solo_ms,
                "mesh_over_solo": mesh_ms / solo_ms, "ghs": n / mesh_ms / 1e6,
                "card": smoke.info["device"]["nvidia_smi"]}

    def sched_mesh():
        out = sched_serve("md5", sched_md5_requests(), lane="mesh",
                          mesh=make_mesh(shard_devices(MESH_SHARDS)), min_occupancy=2)
        if out["sched.lane_launches.mesh"] <= 0:
            raise AssertionError("the scheduler's mesh lane served no group")
        if "sched_md5" in smoke.info:
            cuda_lane = [r["secret"] for r in smoke.info["sched_md5"]["requests"]]
            mesh_lane = [r["secret"] for r in out["requests"]]
            if mesh_lane != cuda_lane:
                raise AssertionError(f"mesh lane {mesh_lane} != cuda lane {cuda_lane}")
            out["cuda_lane_secrets_equal"] = True
        return out

    # 12. worker_*: the port's worker node over its RPC plane -----------------
    class StandIn:
        """The coordinator's side of the worker protocol: the port's
        ``RPCServer`` with a ``CoordRPCHandler.Result`` that queues what
        arrives (with the time it arrived), and ``RPCClient``s that send
        ``Mine`` and ``Found`` with tracing tokens."""

        def __init__(self):
            arrived = self.results = queue.Queue()

            class CoordRPCHandler:
                def Result(self, params):
                    arrived.put((time.monotonic(), params))
                    return {}

            self.server = rpc.RPCServer()
            self.server.register("CoordRPCHandler", CoordRPCHandler())
            self.addr = self.server.listen("127.0.0.1:0")
            self.server.serve_in_background()
            self.tracer = tracing.Tracer("coordinator", tracing.MemorySink())
            self.clients = {}

        def call(self, addr, method, params):
            if addr not in self.clients:
                self.clients[addr] = rpc.RPCClient(addr)
            return self.clients[addr].call(method, params, timeout=60)

        def params(self, nonce, d, worker_byte, trace, **extra):
            return {"nonce": nonce, "num_trailing_zeros": d, "worker_byte": worker_byte,
                    "token": tracing.wire_token(trace.generate_token()), **extra}

        def mine(self, addr, nonce, d, worker_byte=0, worker_bits=0, trace=None, **extra):
            trace = trace or self.tracer.create_trace()
            self.call(addr, "WorkerRPCHandler.Mine",
                      self.params(nonce, d, worker_byte, trace, worker_bits=worker_bits, **extra))
            return trace

        def found(self, addr, nonce, d, worker_byte, secret, trace, **extra):
            self.call(addr, "WorkerRPCHandler.Found",
                      self.params(nonce, d, worker_byte, trace, secret=secret, **extra))

        def take(self, timeout=120):
            return self.results.get(timeout=timeout)

        def close(self):
            for c in self.clients.values():
                c.close()
            self.server.shutdown()

    class LaunchTimer:
        """Wraps the CUDA backend's calls of the kernel wrappers
        (``cuda_backend.hash_search`` and ``hash_persistent_search``): a
        CUDA event pair around each launch, on the stream it launches on,
        and its result cell, kept per worker (the span node the miner thread
        is bound to).  The wrappers themselves still count the launch."""

        NAMES = ("hash_search", "hash_persistent_search")

        def __init__(self):
            self.pairs = collections.defaultdict(list)
            self.lock = threading.Lock()
            self.orig = {name: getattr(cuda_backend, name) for name in self.NAMES}

            def timed(orig):
                def launch(model, ops, *args, **kwargs):
                    stream = torch.cuda.current_stream(ops.device)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                    out = orig(model, ops, *args, **kwargs)
                    end.record(stream)
                    with self.lock:
                        self.pairs[SPANS.current_node()].append((start, end, out))
                    return out

                return launch

            for name, orig in self.orig.items():
                setattr(cuda_backend, name, timed(orig))

        def take(self, node):
            """The device ms of each of ``node``'s launches since the last
            take, in launch order."""
            return [ms for ms, _ in self.take_results(node)]

        def take_results(self, node):
            """``(device ms, first word of the result)`` of each of
            ``node``'s launches since the last take, in launch order."""
            with self.lock:
                pairs = self.pairs.pop(node, [])
            for _, end, _ in pairs:
                end.synchronize()
            return [(a.elapsed_time(b), u32_value(out.reshape(-1)[0])) for a, b, out in pairs]

        def close(self):
            for name, orig in self.orig.items():
                setattr(cuda_backend, name, orig)

    def start_worker(coord, **config):
        sink = tracing.MemorySink()
        w = Worker(WorkerConfig(**{"WorkerID": "worker1", "ListenAddr": "127.0.0.1:0",
                                   "CoordAddr": coord.addr, **WORKER_CONFIG, **config}),
                   sink=sink, device=dev)
        return w, w.initialize_rpcs(), sink

    def worker_actions(sink, trace):
        names = [e["action"] for e in sink.events
                 if e["type"] == "action" and e["trace_id"] == trace.trace_id]
        if names[0] != "WorkerMine" or names[-1] != "WorkerCancel":
            raise AssertionError(f"worker actions {names}")
        return names

    def check_secret(model_name, nonce, d, secret, tbs):
        """hashlib's digest of the secret, which must also be the direct
        backend's secret for the same request."""
        h = puzzle.new_hash(model_name)
        h.update(nonce + secret)
        digest = h.hexdigest()
        direct = CudaBackend(hash_model=model_name, device=dev).search(nonce, d, tbs)
        if not digest.endswith("0" * d) or secret[0] not in tbs or secret != direct:
            raise AssertionError(f"{model_name} {nonce.hex()} d{d}: {secret.hex()} ({digest}), "
                                 f"direct backend {direct and direct.hex()}")
        return digest

    def mine_once(coord, w, addr, sink, timer, nonce, d):
        """One Mine to one worker: the result, Found, the nil ACK."""
        kernel = KERNELS["md5"]
        forms = (kernel, f"{kernel}_persistent")
        launches0 = sum(LAUNCHES[k].value for k in forms)
        syncs0 = REGISTRY.get("search.blocking_syncs")
        steps0 = REGISTRY.get("search.persistent_steps")
        t0 = time.monotonic()
        trace = coord.mine(addr, nonce, d)
        t_res, res = coord.take()
        if res["secret"] is None:
            raise AssertionError(f"{nonce.hex()} d{d}: a nil result first")
        secret = bytes(res["secret"])
        coord.found(addr, nonce, d, 0, secret, trace)
        _, ack = coord.take(30)
        if ack["secret"] is not None or not coord.results.empty():
            raise AssertionError(f"after Found: {ack}, {coord.results.qsize()} more")
        names = worker_actions(sink, trace)
        if names[1:3] != ["CacheMiss", "WorkerResult"] or \
                not all(n.startswith("Cache") for n in names[3:-1]):
            raise AssertionError(f"worker actions {names}")
        # read before the direct backend's check launches the kernel again
        kernel_launches = sum(LAUNCHES[k].value for k in forms) - launches0
        syncs = REGISTRY.get("search.blocking_syncs") - syncs0
        steps = REGISTRY.get("search.persistent_steps") - steps0
        results = timer.take_results(w.config.WorkerID)
        if kernel_launches <= 0 or len(results) != kernel_launches:
            raise AssertionError(f"{kernel}: {kernel_launches} launches, {len(results)} timed")
        times = [ms for ms, _ in results]
        wall_ms = (t_res - t0) * 1e3
        # the driver reads the launches in launch order up to the first that
        # holds a hit, and keeps the next in flight: the launches behind the
        # hit's ran after the result had left
        hit = next((i for i, (_, f) in enumerate(results) if f != SENTINEL), None)
        if hit is None:
            raise AssertionError(f"{nonce.hex()} d{d}: no launch holds the hit")
        read_ms = sum(times[:hit + 1])
        return {"nonce": nonce.hex(), "difficulty": d, "secret": secret.hex(),
                "md5": check_secret("md5", nonce, d, secret, list(range(256))),
                "direct_backend_equal": True, "actions": names,
                "loop": w.handler.backend.loop, "kernel_launches": kernel_launches,
                "launches_behind_hit": kernel_launches - hit - 1, "blocking_syncs": syncs,
                "persistent_steps": steps, "wall_ms": wall_ms, "device_ms_read": read_ms,
                "device_ms_past_hit": sum(times[hit + 1:]), "host_share": 1 - read_ms / wall_ms}

    def profile_mines(coord, w, addr, sink, timer):
        """Two difficulty-5 Mines at new nonces under ``torch.profiler``
        (CPU and CUDA), with a ``record_function`` range around each stage
        of the worker's path, wrapped here from outside the package: where
        a Mine's host time goes.  The trace goes to ``chiprun_out/``."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from distpow_tpu_torch.nodes import worker as worker_mod
        from distpow_tpu_torch.parallel import search as search_mod
        from distpow_tpu_torch.runtime import rpc as rpc_mod

        stages = [(worker_mod.WorkerRPCHandler, "Mine"), (cuda_backend.CudaBackend, "search"),
                  (cuda_backend, "persistent_search"), (cuda_backend, "build_tail_spec"),
                  (cuda_backend, "step_operands"), (cuda_backend, "hash_search"),
                  (cuda_backend, "hash_persistent_search"), (search_mod, "_enqueue_fetch"),
                  (search_mod.puzzle, "check_secret"), (search_mod.StopFlag, "operand"),
                  (search_mod.StopFlag, "set"), (rpc_mod.RPCClient, "call")]
        saved, labels = [], set()

        def ranged(label, fn):
            def call(*a, **k):
                with record_function(label):
                    return fn(*a, **k)

            return call

        def device_ms(e):
            return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 1e3

        for owner, name in stages:
            # a class's method may be its base's: restored by deleting ours
            own = not isinstance(owner, type) or name in owner.__dict__
            fn = getattr(owner, name)
            saved.append((owner, name, fn, own))
            label = ".".join(f"{owner.__name__}.{name}".split(".")[-2:])
            labels.add(label)
            setattr(owner, name, ranged(label, fn))
        out = []
        try:
            for nonce in (bytes([0x0a, 0x0b, 0x0c, 0x0d]), bytes([0x0e, 0x0f, 0x10, 0x11])):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    req = mine_once(coord, w, addr, sink, timer, nonce, 5)
                    torch.cuda.synchronize()
                path = os.path.join(OUT_DIR, f"worker_profile_{nonce.hex()}.json")
                prof.export_chrome_trace(path)
                rows = {}
                for e in prof.key_averages():
                    if e.key in labels or device_ms(e) > 0:
                        rows[e.key] = {"count": e.count, "cpu_ms": e.cpu_time_total / 1e3,
                                       "device_ms": device_ms(e)}
                top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
                out.append({"nonce": nonce.hex(), "wall_ms": req["wall_ms"],
                            "device_ms_read": req["device_ms_read"],
                            "kernel_launches": req["kernel_launches"], "stages": rows,
                            "top_self_cpu": [{"op": e.key, "count": e.count,
                                              "self_cpu_ms": e.self_cpu_time_total / 1e3}
                                             for e in top],
                            "trace": os.path.relpath(path, HERE)})
        finally:
            for owner, name, fn, own in reversed(saved):
                if own:
                    setattr(owner, name, fn)
                else:
                    delattr(owner, name)
        return out

    def worker_mine():
        """The reference's worker defaults (the persistent loop): the demo's
        Mines, then one Mine at the first demo request's nonce through a
        second worker whose SearchLoop is serial, then two profiled ones."""
        coord, timer = StandIn(), None
        w = w_serial = None
        try:
            t0 = time.monotonic()
            w, addr, sink = start_worker(coord)
            w.start_forwarder()
            if not w.warmed.wait(600) or w.warmup_error is not None:
                raise AssertionError(f"warm-up failed: {w.warmup_error!r}")
            warm_wall = time.monotonic() - t0
            if not isinstance(w.handler.backend, CudaBackend) or \
                    w.handler.backend.loop != "persistent":
                raise AssertionError(f"Backend auto gave {w.handler.backend!r}, loop "
                                     f"{getattr(w.handler.backend, 'loop', None)}")
            # nothing may be built once warm-up has finished
            builds, orig_build = [], _build.build
            _build.build = lambda names=None: builds.append(names) or orig_build(names)
            timer = LaunchTimer()
            for counter in LAUNCHES.values():
                counter.reset()
            REGISTRY.reset()
            try:
                requests = [mine_once(coord, w, addr, sink, timer, nonce, d)
                            for nonce, d in WORKER_DEMO]
                w_serial, addr_s, sink_s = start_worker(coord, WorkerID="worker2",
                                                        SearchLoop="serial",
                                                        WarmupNonceLens=[], WarmupWidths=[])
                w_serial.start_forwarder()
                serial = mine_once(coord, w_serial, addr_s, sink_s, timer, *WORKER_DEMO[0])
            finally:
                _build.build = orig_build
            if builds:
                raise AssertionError(f"libraries built after warm-up: {builds}")
            if serial["secret"] != requests[0]["secret"] or serial["loop"] != "serial" or \
                    any(r["blocking_syncs"] for r in requests):
                raise AssertionError(f"serial {serial['secret']} ({serial['loop']}) against "
                                     f"persistent {requests[0]['secret']}; blocking syncs "
                                     f"{[r['blocking_syncs'] for r in requests]}")
            profiled = profile_mines(coord, w, addr, sink, timer)
            stats = coord.call(addr, "WorkerRPCHandler.Stats", {})
            if stats["role"] != "worker" or stats["watchdog_armed"] is not True:
                raise AssertionError(f"Stats: role {stats['role']}, watchdog "
                                     f"{stats['watchdog_armed']}")
            return {"requests": requests, "serial": serial, "profiled": profiled,
                    "warmup_s": w.warmup_s, "boot_to_warm_s": warm_wall,
                    "builds_after_warmup": 0,
                    "stats_role": stats["role"], "stats_backend": stats["backend"],
                    "stats_device": stats["device"], "watchdog_armed": True,
                    "solve_s": REGISTRY.get_observed("worker.solve_s"),
                    "card": smoke.info["device"]["nvidia_smi"]}
        finally:
            if timer is not None:
                timer.close()
            for worker in (w, w_serial):
                if worker is not None:
                    worker.shutdown()
            coord.close()

    def worker_mesh():
        """One Mine through a worker whose backend is the mesh kernels' on 4
        logical shards of the card (``Backend: "pallas-mesh"``,
        ``MeshDevices: 4``, as ``tests/test_torch_worker.py`` builds one on
        the CPU; the shards named for the worker's ``get_backend``, since
        the card is one): the persistent loop's mesh form."""
        from distpow_tpu_torch.nodes import worker as worker_mod

        coord, w = StandIn(), None
        orig = worker_mod.get_backend

        def on_shards(name, **kwargs):
            return orig(name, devices=shard_devices(MESH_SHARDS), **kwargs)

        worker_mod.get_backend = on_shards
        try:
            w, addr, sink = start_worker(coord, Backend="pallas-mesh", MeshDevices=MESH_SHARDS,
                                         WarmupNonceLens=[4], WarmupWidths=[0, 1, 2, 3, 4])
        finally:
            worker_mod.get_backend = orig
        try:
            w.start_forwarder()
            backend = w.handler.backend
            if not isinstance(backend, CudaMeshBackend) or backend.mesh.size != MESH_SHARDS \
                    or backend.loop != "persistent":
                raise AssertionError(f"the worker's backend is {backend!r}")
            if not w.warmed.wait(600) or w.warmup_error is not None:
                raise AssertionError(f"warm-up failed: {w.warmup_error!r}")
            kernel = KERNELS["md5"]
            forms = (f"{kernel}_mesh", f"{kernel}_mesh_persistent")
            for counter in LAUNCHES.values():
                counter.reset()
            REGISTRY.reset()
            nonce, d = WORKER_DEMO[0]
            t0 = time.monotonic()
            trace = coord.mine(addr, nonce, d)
            t_res, res = coord.take()
            secret = bytes(res["secret"] or b"")
            coord.found(addr, nonce, d, 0, secret, trace)
            _, ack = coord.take(30)
            launches = {k: LAUNCHES[k].value for k in forms}
            names = worker_actions(sink, trace)
            if min(launches.values()) <= 0 or ack["secret"] is not None:
                raise AssertionError(f"mesh launches {launches}, ack {ack}")
            return {"nonce": nonce.hex(), "difficulty": d, "secret": secret.hex(),
                    "md5": check_secret("md5", nonce, d, secret, list(range(256))),
                    "direct_backend_equal": True, "actions": names, "kernel_launches": launches,
                    "shards": [str(x) for x in backend.mesh.devices], "wall_ms":
                    (t_res - t0) * 1e3, "blocking_syncs": REGISTRY.get("search.blocking_syncs"),
                    "persistent_steps": REGISTRY.get("search.persistent_steps"),
                    "card": smoke.info["device"]["nvidia_smi"]}
        finally:
            if w is not None:
                w.shutdown()
            coord.close()

    def worker_fanout():
        """One request to four workers on the card, each on its quarter of
        the first byte: the first result wins, Found goes to all four, and
        every worker sends two messages (the losers two nil ACKs)."""
        coord, timer = StandIn(), LaunchTimer()
        workers = []
        try:
            for i in range(WORKER_FANOUT):
                workers.append(start_worker(coord, WorkerID=f"worker{i + 1}",
                                            WarmupNonceLens=[], WarmupWidths=[]))
                workers[-1][0].start_forwarder()
            nonce, d = WORKER_FANOUT_REQUEST
            bits = worker_bits(WORKER_FANOUT)
            trace = coord.tracer.create_trace()
            t0 = time.monotonic()
            for i, (w, addr, _) in enumerate(workers):
                coord.mine(addr, nonce, d, worker_byte=i, worker_bits=bits, trace=trace)
            msgs = collections.defaultdict(list)
            while True:
                t, res = coord.take()
                msgs[res["worker_byte"]].append(res)
                if res["secret"] is not None:
                    break
            solve_s, winner, secret = t - t0, res["worker_byte"], bytes(res["secret"])
            for i, (w, addr, _) in enumerate(workers):
                coord.found(addr, nonce, d, i, secret, trace)
            while sum(len(m) for m in msgs.values()) < 2 * WORKER_FANOUT:
                t, res = coord.take(60)
                msgs[res["worker_byte"]].append(res)
            all_acks_s = t - t0
            per_worker = []
            for i, (w, _, sink) in enumerate(workers):
                got = [m["secret"] is not None for m in msgs[i]]
                if got not in ([False, False], [True, False]):
                    raise AssertionError(f"worker {i}: messages {msgs[i]}")
                times = timer.take(w.config.WorkerID)
                per_worker.append({"worker": w.config.WorkerID, "result": got[0],
                                   "nil_acks": got.count(False), "kernel_launches": len(times),
                                   "device_ms": sum(times),
                                   "actions": worker_actions(sink, trace)})
            digest = check_secret("md5", nonce, d, secret, thread_bytes(winner, bits))
            if not coord.results.empty():
                raise AssertionError("messages after the ledger closed")
            if min(p["kernel_launches"] for p in per_worker) <= 0:
                raise AssertionError(f"a worker launched no kernel: {per_worker}")
            return {"nonce": nonce.hex(), "difficulty": d, "winner": winner,
                    "secret": secret.hex(), "md5": digest, "direct_backend_equal": True,
                    "solve_s": solve_s, "all_acks_s": all_acks_s, "workers": per_worker,
                    "card": smoke.info["device"]["nvidia_smi"]}
        finally:
            timer.close()
            for w, _, _ in workers:
                w.shutdown()
            coord.close()

    def worker_sched():
        """Eight concurrent Mines, md5 and sha1, through one worker's batching
        scheduler, under sync debug mode "error" as in sched_*."""
        import numpy as np

        coord = StandIn()
        w = None
        try:
            w, addr, sink = start_worker(coord, Scheduler="batching",
                                         SchedHashModels=["sha1"])
            w.start_forwarder()
            if not w.warmed.wait(600) or w.warmup_error is not None:
                raise AssertionError(f"warm-up failed: {w.warmup_error!r}")
            rng = np.random.default_rng(SCHED_SEED + 2)
            reqs = [(m, rng.integers(0, 256, size=6, dtype=np.uint8).tobytes(),
                     int(rng.integers(5, 7)))
                    for m in WORKER_SCHED_MODELS for _ in range(WORKER_SCHED_PER_MODEL)]
            for counter in LAUNCHES.values():
                counter.reset()
            REGISTRY.reset()
            traces, got = {}, {}
            torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.monotonic()
                for model_name, nonce, d in reqs:
                    extra = {} if model_name == "md5" else {"hash_model": model_name}
                    traces[nonce] = coord.mine(addr, nonce, d, **extra)
                while len(got) < len(reqs):
                    t, res = coord.take()
                    got[bytes(res["nonce"])] = (t - t0, res)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            launches = {k: c.value for k, c in LAUNCHES.items()}
            counts = {k: REGISTRY.get(k) for k in ("sched.launches", "sched.mixed_hash_launches",
                                                   "sched.lane_launches.cuda",
                                                   "sched.lane_launches.torch",
                                                   "sched.fallback_searches",
                                                   "search.blocking_syncs")}
            out = []
            for model_name, nonce, d in reqs:
                wall, res = got[nonce]
                if res["secret"] is None:
                    raise AssertionError(f"{model_name} {nonce.hex()}: a nil result first")
                secret = bytes(res["secret"])
                extra = {} if model_name == "md5" else {"hash_model": model_name}
                if res.get("hash_model") != extra.get("hash_model"):
                    raise AssertionError(f"result tagged {res.get('hash_model')}")
                coord.found(addr, nonce, d, 0, secret, traces[nonce], **extra)
                out.append({"model": model_name, "nonce": nonce.hex(), "difficulty": d,
                            "secret": secret.hex(),
                            model_name: check_secret(model_name, nonce, d, secret,
                                                     list(range(256))),
                            "direct_backend_equal": True, "wall_s": wall})
            acks = [coord.take(30)[1] for _ in reqs]
            if any(a["secret"] is not None for a in acks):
                raise AssertionError(f"non-nil ACKs: {acks}")
            for model_name, nonce, _ in reqs:
                names = worker_actions(sink, traces[nonce])
                if "WorkerResult" not in names:
                    raise AssertionError(f"{model_name} {nonce.hex()}: {names}")
            group = {KERNELS[m]: launches[f"{KERNELS[m]}_group"] for m in WORKER_SCHED_MODELS}
            solo = {k: launches[k] for k in KERNELS.values() if launches[k]}
            if min(group.values()) <= 0 or counts["sched.lane_launches.cuda"] <= 0 or solo \
                    or counts["sched.lane_launches.torch"]:
                raise AssertionError(f"group launches {group}, solo {solo}, {counts}")
            return {"requests": out, "group_launches": group, **counts,
                    "batch_occupancy": REGISTRY.get_observed("sched.batch_occupancy"),
                    "sync_debug_mode": "error", "card": smoke.info["device"]["nvidia_smi"]}
        finally:
            if w is not None:
                w.shutdown()
            coord.close()

    def worker_cli():
        """``python -m distpow_tpu_torch.cli.worker`` in a fresh process on
        the card, its ``CompilationCacheDir`` the directory the ``build``
        phase built the libraries in: boot, warm-up (which loads them and
        builds nothing; ``sched_cancel`` measures md5's cold build), one
        Mine, SIGTERM."""
        import socket

        coord = StandIn()
        build_dir = _build.BUILD_DIR
        before = sorted(os.listdir(build_dir))
        cfg_path = os.path.join(OUT_DIR, "worker_cli_config.json")
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            listen = f"127.0.0.1:{sk.getsockname()[1]}"
        with open(cfg_path, "w") as fh:
            json.dump({"WorkerID": "worker1", "CoordAddr": coord.addr, **WORKER_CONFIG,
                       "CompilationCacheDir": build_dir}, fh)
        lines, marks = [], {}
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-m", "distpow_tpu_torch.cli.worker", "--config", cfg_path,
             "--listen", listen], cwd=HERE, env={**os.environ, "PYTHONPATH": HERE},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def reader():
            for line in proc.stdout:
                lines.append(line)
                for mark in ("serving worker1 RPCs", "warmup done", "warmup failed"):
                    if mark in line and mark not in marks:
                        marks[mark] = time.monotonic() - t0

        threading.Thread(target=reader, daemon=True).start()
        try:
            deadline = time.monotonic() + 600
            while "warmup done" not in marks and time.monotonic() < deadline:
                if proc.poll() is not None or "warmup failed" in marks:
                    break
                time.sleep(0.05)
            if "warmup done" not in marks:
                raise AssertionError(f"no warm-up: {''.join(lines)[-3000:]}")
            built = sorted(set(os.listdir(build_dir)) - set(before))
            nonce, d = bytes([1, 2, 3, 4]), 6
            t1 = time.monotonic()
            trace = coord.mine(listen, nonce, d)
            t_res, res = coord.take()
            secret = bytes(res["secret"])
            coord.found(listen, nonce, d, 0, secret, trace)
            if coord.take(30)[1]["secret"] is not None:
                raise AssertionError("the ACK carries a secret")
            digest = check_secret("md5", nonce, d, secret, list(range(256)))
            t2 = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            if rc != 0:
                raise AssertionError(f"exit code {rc} after SIGTERM: {''.join(lines)[-3000:]}")
            if built or not any(name.startswith("libmd5_search.vw") for name in before):
                raise AssertionError(f"the warm-up built {built} in {build_dir}")
            return {"boot_to_serving_s": marks["serving worker1 RPCs"],
                    "boot_to_warmup_done_s": marks["warmup done"],
                    "libraries_built_at_warmup": built,
                    "nonce": nonce.hex(), "difficulty": d, "secret": secret.hex(),
                    "md5": digest, "direct_backend_equal": True,
                    "mine_to_result_s": t_res - t1, "sigterm_to_exit_s": time.monotonic() - t2,
                    "exit_code": rc}
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            coord.close()

    # 13. native: the port's C++ CPU miner -------------------------------
    def host_cpu():
        """The host CPU as ``/proc/cpuinfo``'s first processor names it
        (model name, vendor, family and model numbers, the vector and SHA
        extensions among its flags) and the logical core count."""
        fields = {}
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
        flags = set(fields.get("flags", "").split())
        return {"model": fields.get("model name"), "vendor": fields.get("vendor_id"),
                "family": fields.get("cpu family"), "model_number": fields.get("model"),
                "flags": sorted(flags & {"avx2", "avx512f", "sha_ni", "bmi2"}),
                "cores": os.cpu_count()}

    def native():
        """g++ builds the native miner from its source into the build
        directory; each model's single-thread secret is the python
        backend's (reference enumeration order) and md5's the CUDA
        backend's; md5's rate on all cores and on one, beside the card's."""
        import ctypes

        from distpow_tpu_torch.backends import PythonBackend
        from distpow_tpu_torch.backends import native_miner

        t0 = time.monotonic()
        lib = native_miner.load_library()
        out = {"library": os.path.relpath(native_miner.library_path(), HERE),
               "cxx_flags": list(native_miner.CXX_FLAGS), "gxx_s": native_miner.last_build_s,
               "load_s": time.monotonic() - t0, "cpu": host_cpu()}
        nonce, full = bytes([1, 2, 3, 4]), list(range(256))
        models = {}
        for name in MODELS:
            t1 = time.monotonic()
            secret = native_miner.NativeBackend(hash_model=name, n_threads=1).search(
                nonce, NATIVE_DIFFICULTY, full)
            t2 = time.monotonic()
            want = PythonBackend(hash_model=name).search(nonce, NATIVE_DIFFICULTY, full)
            if secret is None or secret != want or \
                    not puzzle.check_secret(nonce, secret, NATIVE_DIFFICULTY, algo=name):
                raise AssertionError(f"{name}: native {secret and secret.hex()}, python "
                                     f"{want and want.hex()}")
            models[name] = {"secret": secret.hex(), "native_s": t2 - t1,
                            "python_s": time.monotonic() - t2}
        out["difficulty"], out["models"] = NATIVE_DIFFICULTY, models
        t1 = time.monotonic()
        secret = native_miner.NativeBackend(n_threads=1).search(nonce, NATIVE_CUDA_DIFFICULTY,
                                                                full)
        t2 = time.monotonic()
        on_card = CudaBackend(hash_model="md5", device=dev).search(nonce, NATIVE_CUDA_DIFFICULTY,
                                                                  full)
        if secret is None or secret != on_card:
            raise AssertionError(f"md5 d{NATIVE_CUDA_DIFFICULTY}: native "
                                 f"{secret and secret.hex()}, CUDA {on_card and on_card.hex()}")
        out["md5_against_cuda"] = {"difficulty": NATIVE_CUDA_DIFFICULTY, "secret": secret.hex(),
                                   "native_one_core_s": t2 - t1,
                                   "cuda_s": time.monotonic() - t2}
        # the rate: one call of the C scan over a fixed range of width-4
        # candidates that meet no difficulty-32 mask
        tbs = bytes(range(256))
        rates = {}
        for label, threads in (("all_cores", os.cpu_count() or 1), ("one_core", 1)):
            cancel, hashes = ctypes.c_int32(0), ctypes.c_uint64(0)
            buf = ctypes.create_string_buffer(16)
            t1 = time.monotonic()
            rc = lib.distpow_search_range(nonce, len(nonce), 32, native_miner.ALGO_IDS["md5"],
                                          tbs, len(tbs), 4, 0, NATIVE_RATE_CANDIDATES // 256,
                                          threads, ctypes.byref(cancel), ctypes.byref(hashes),
                                          buf)
            secs = time.monotonic() - t1
            if rc != 0 or hashes.value != NATIVE_RATE_CANDIDATES:
                raise AssertionError(f"{label}: rc {rc}, {hashes.value} hashes")
            rates[label] = {"threads": threads, "candidates": hashes.value, "s": secs,
                            "mhs": hashes.value / secs / 1e6}
        out["md5_rate"] = rates
        card_ghs = smoke.info["rate"]["ghs"] if "rate" in smoke.info else None
        out["card"] = {"nvidia_smi": nvidia_smi("name,power.limit"), "md5_ghs": card_ghs}
        out["card_over_native"] = None if card_ghs is None else {
            label: card_ghs * 1e3 / r["mhs"] for label, r in rates.items()}
        return out

    # 14. demo: the reference's process surface, every process the port's ---
    def demo():
        """``config_gen``, then ``tracing_server``, ``coordinator``, four
        workers on the card (each ``CompilationCacheDir`` the build
        directory, so none runs nvcc), and the demo client, each a fresh
        process of the port's CLIs, booted in that order, each waited for
        on its own log line.  The client's four ``MineResult`` lines are
        checked with hashlib, ``trace_check`` runs on the two logs, each
        worker's ``Stats`` must name the card and one must count the
        kernels' launches, and ``nvidia-smi`` must list the workers and
        none of the other processes.  After the sequential requests the
        observability and load CLIs run against the stack
        (``observe_stack``: stats, the cluster's OpenMetrics, the SLO gate,
        forensics, the soak attached to the coordinator), none of them
        mapping libcuda."""
        from distpow_tpu_torch.runtime.rpc import RPCClient

        demo_dir = os.path.join(OUT_DIR, "demo")
        shutil.rmtree(demo_dir, ignore_errors=True)
        os.makedirs(demo_dir)
        env = {**os.environ, "PYTHONPATH": HERE, "PYTHONUNBUFFERED": "1"}
        t_start = time.monotonic()

        def cli(*args, timeout=60):
            proc = subprocess.run([sys.executable, "-m", *args], cwd=HERE, env=env,
                                  capture_output=True, text=True, timeout=timeout)
            if proc.returncode != 0:
                raise AssertionError(f"{args[0]} exited {proc.returncode}: "
                                     f"{(proc.stdout + proc.stderr)[-3000:]}")
            return proc

        cli("distpow_tpu_torch.cli.config_gen", "--config-dir", demo_dir)

        def edit(name, **fields):
            path = os.path.join(demo_dir, name)
            with open(path) as fh:
                cfg = json.load(fh)
            cfg.update(fields)
            with open(path, "w") as fh:
                json.dump(cfg, fh, indent=1)
            return path, cfg

        trace_log = os.path.join(demo_dir, "trace_output.log")
        shiviz_log = os.path.join(demo_dir, "shiviz_output.log")
        ts_cfg, _ = edit("tracing_server_config.json", OutputFile=trace_log,
                         ShivizOutputFile=shiviz_log)
        coord_cfg, coord = edit("coordinator_config.json")
        worker_cfg, worker = edit("worker_config.json", CompilationCacheDir=_build.BUILD_DIR)
        before = sorted(os.listdir(_build.BUILD_DIR))

        class Child:
            """A child process whose output lines are read as they come,
            each with the time since it started."""

            def __init__(self, name, argv, stdin=None):
                self.name, self.lines, self.marks = name, [], {}
                self.t0 = time.monotonic()
                self.proc = subprocess.Popen([sys.executable, *argv], cwd=HERE, env=env,
                                             stdin=stdin, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)
                self.reader = threading.Thread(target=self._read, daemon=True)
                self.reader.start()

            def _read(self):
                for line in self.proc.stdout:
                    self.lines.append((time.monotonic() - self.t0, line))

            def wait_for(self, mark, timeout=DEMO_TIMEOUT_S, fail=None):
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    for t, line in list(self.lines):
                        if mark in line:
                            self.marks[mark] = t
                            return t
                        if fail is not None and fail in line:
                            raise AssertionError(f"{self.name}: {line.strip()}")
                    if self.proc.poll() is not None and not self.reader.is_alive():
                        break
                    time.sleep(0.02)
                raise AssertionError(f"{self.name}: no {mark!r} (exit {self.proc.poll()}): "
                                     f"{self.text()[-3000:]}")

            def text(self):
                return "".join(line for _, line in self.lines)

        children, signalled, passed, rpcs = [], set(), False, []

        def spawn(name, argv, stdin=None):
            children.append(Child(name, argv, stdin))
            return children[-1]

        def device_apps():
            """The card's compute processes as ``nvidia-smi`` lists them: one
            ``(pid, used memory)`` a CUDA context."""
            out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60, check=True).stdout
            return [tuple(s.strip() for s in line.split(",")) for line in out.splitlines()
                    if line.strip()]

        try:
            # the contexts on the card before each step: this process's own,
            # then as many again with the device-less processes up, then one
            # more for each worker, and no more while the client runs
            apps = {"before": device_apps()}
            tracer = spawn("tracing_server", ["-m", "distpow_tpu_torch.cli.tracing_server",
                                              "--config", ts_cfg])
            tracer.wait_for("tracing server listening")
            coordinator = spawn("coordinator", ["-m", "distpow_tpu_torch.cli.coordinator",
                                                "--config", coord_cfg])
            coordinator.wait_for("coordinator serving")
            apps["device_less_up"] = device_apps()
            workers = []
            for i, addr in enumerate(coord["Workers"]):
                wid = f"worker{i + 1}"
                workers.append(spawn(wid, [
                    "-c", DEMO_WORKER_SHIM, os.path.join(demo_dir, f"{wid}_device_ms.json"),
                    "--config", worker_cfg, "--id", wid, "--listen", addr, "--device", "cuda"]))
            for w in workers:
                w.wait_for(f"serving {w.name} RPCs")
                w.wait_for("warmup done", fail="warmup failed")
            built = sorted(set(os.listdir(_build.BUILD_DIR)) - set(before))
            if built:
                raise AssertionError(f"the workers' warm-up built {built}")
            apps["workers_up"] = device_apps()
            stats_clients = [RPCClient(a) for a in coord["Workers"]]
            coord_stats = RPCClient(coord["ClientAPIListenAddr"])
            rpcs += [*stats_clients, coord_stats]
            base = [c.call("WorkerRPCHandler.Stats", {}, timeout=60) for c in stats_clients]
            def check(nonce, d, secret, where):
                digest = hashlib.md5(nonce + secret).hexdigest()
                if not digest.endswith("0" * d):
                    raise AssertionError(f"{where}: {nonce.hex()} d{d} {secret.hex()}: md5 "
                                         f"{digest}")
                return digest

            def run_client(name, ids=(), sample=None):
                """The demo client in a fresh process: its four results, each
                with the ms from its start, and whether it mapped libcuda.  A
                second run takes client ids of its own (``ids``): a node's
                vector clock starts anew in a new process, and ``trace_check``
                holds each id's clock to +1 an event.  ``sample`` gets the
                card's contexts as the client runs, and once more after its
                work while the process is still up."""
                client = spawn(name, ["-c", DEMO_CLIENT_SHIM, "--config",
                                      os.path.join(demo_dir, "client_config.json"),
                                      "--config2",
                                      os.path.join(demo_dir, "client2_config.json"),
                                      *(a for flag, i in zip(("--id", "--id2"), ids)
                                        for a in (flag, i))], stdin=subprocess.PIPE)
                window = [time.time()]
                while DEMO_CLIENT_DONE not in client.marks:
                    if sample is not None:
                        sample.append(device_apps())
                    try:
                        client.wait_for(DEMO_CLIENT_DONE, timeout=0.02)
                    except AssertionError:
                        if client.proc.poll() is not None or \
                                time.monotonic() - client.t0 > DEMO_TIMEOUT_S:
                            raise
                if sample is not None:
                    sample.append(device_apps())
                mapped = maps_libcuda(client.proc.pid)
                client.proc.stdin.close()
                client.reader.join(DEMO_TIMEOUT_S)
                rc = client.proc.wait(timeout=DEMO_TIMEOUT_S)
                window.append(time.time())
                if rc != 0:
                    raise AssertionError(f"{name} exited {rc}: {client.text()[-3000:]}")
                results = []
                for t, line in client.lines:
                    m = re.search(r"MineResult nonce=([0-9a-f]*) difficulty=(\d+) "
                                  r"secret=([0-9a-f]*)", line)
                    if m:
                        nonce, d, secret = bytes.fromhex(m[1]), int(m[2]), bytes.fromhex(m[3])
                        results.append({"nonce": m[1], "difficulty": d, "secret": m[3],
                                        "md5": check(nonce, d, secret, name),
                                        "ms_from_client_start": t * 1e3})
                if len(results) != 4 or \
                        sorted(r["difficulty"] for r in results) != [5, 5, 7, 7]:
                    raise AssertionError(f"{name}: MineResult lines {results}: "
                                         f"{client.text()[-3000:]}")
                return (client, sorted(results, key=lambda r: r["ms_from_client_start"]),
                        window, mapped)

            def coord_hists():
                snap = coord_stats.call("CoordRPCHandler.Stats", {}, timeout=60)
                return snap["histograms"], snap["counters"]

            # the processes on the card while the client runs, and after
            during = []
            client, results, demo_window, client_maps = run_client("client", sample=during)
            apps["after_client"] = device_apps()
            hist, counters = coord_hists()
            # the cached repeat: every request a hit, no fan-out
            repeat, repeat_results, _, repeat_maps = run_client(
                "client_repeat", ids=("client1_repeat", "client2_repeat"))
            hist2, counters2 = coord_hists()
            hits = (hist2.get("coord.mine_s.hit") or {}).get("count", 0) - \
                (hist.get("coord.mine_s.hit") or {}).get("count", 0)
            if hits != 4 or counters2.get("coord.fanouts") != counters.get("coord.fanouts"):
                raise AssertionError(f"the repeat: {hits} cache hits, fan-outs "
                                     f"{counters.get('coord.fanouts')} -> "
                                     f"{counters2.get('coord.fanouts')}")
            # one request at a time, through the port's Client in this process
            from distpow_tpu_torch.nodes import Client
            from distpow_tpu_torch.runtime.config import ClientConfig, read_json_config

            ccfg = read_json_config(os.path.join(demo_dir, "client_config.json"), ClientConfig)
            ccfg.ClientID = "client3"
            seq_client = Client(ccfg)
            seq_client.initialize()
            sequential, seq_t0 = [], time.time()
            try:
                for nonce, d in DEMO_SEQUENTIAL:
                    t1 = time.monotonic()
                    seq_client.mine(nonce, d)
                    res = seq_client.notify_queue.get(timeout=DEMO_TIMEOUT_S)
                    ms = (time.monotonic() - t1) * 1e3
                    if res.error is not None or res.secret is None:
                        raise AssertionError(f"sequential {nonce.hex()} d{d}: {res.error}")
                    sequential.append({"nonce": nonce.hex(), "difficulty": d,
                                       "secret": res.secret.hex(),
                                       "md5": check(nonce, d, res.secret, "sequential"),
                                       "ms": ms})
            finally:
                seq_client.close()
            seq_window = (seq_t0, time.time())
            hist3, _ = coord_hists()
            stats = [c.call("WorkerRPCHandler.Stats", {}, timeout=60) for c in stats_clients]
            per_worker, launched = [], False
            for w, b, s in zip(workers, base, stats):
                steps = s["counters"].get("search.persistent_steps", 0) - \
                    b["counters"].get("search.persistent_steps", 0)
                launches = {k: v - b["kernel_launches"].get(k, 0)
                            for k, v in s["kernel_launches"].items()
                            if v - b["kernel_launches"].get(k, 0)}
                if not s["device"].startswith("cuda") or s["backend"] != "CudaBackend":
                    raise AssertionError(f"{w.name}: device {s['device']}, backend "
                                         f"{s['backend']}")
                launched |= steps > 0 and launches.get(f"{KERNELS['md5']}_persistent", 0) > 0
                per_worker.append({"worker": w.name, "pid": w.proc.pid, "device": s["device"],
                                   "persistent_steps": steps, "kernel_launches": launches,
                                   "solve_s": s["histograms"].get("worker.solve_s"),
                                   "boot_to_serving_s": w.marks[f"serving {w.name} RPCs"],
                                   "boot_to_warmup_done_s": w.marks["warmup done"]})
            if not launched:
                raise AssertionError(f"no worker ran the persistent kernel: {per_worker}")
            # the observability and load planes' CLIs against the stack, each a
            # fresh device-less process
            observed = observe_stack(coord["ClientAPIListenAddr"], coord["Workers"], demo_dir,
                                     env)
            # on the card: the workers, and none of the device-less processes.
            # nvidia-smi counts one process a context; where its pids are this
            # machine's (a shared pid namespace) they must be the workers'
            others = {c.name: c.proc.pid for c in (tracer, coordinator, client)}
            cuda_maps = {c.name: maps_libcuda(c.proc.pid)
                         for c in workers + [tracer, coordinator]}
            cuda_maps.update(client=client_maps, client_repeat=repeat_maps)
            n0 = len(apps["before"])
            counts = {k: len(v) for k, v in apps.items()}
            counts["during_client"] = sorted({len(v) for v in during})
            if counts["device_less_up"] != n0 or counts["workers_up"] != n0 + len(workers) or \
                    counts["during_client"] != [n0 + len(workers)] or \
                    counts["after_client"] != n0 + len(workers):
                raise AssertionError(f"contexts on the card: {counts}: {apps}")
            listed = {pid for snap in [*apps.values(), *during] for pid, _ in snap}
            ours = {c.proc.pid for c in children} | {os.getpid()}
            pids_seen = bool(listed & {str(p) for p in ours})
            if pids_seen and (not {str(w.proc.pid) for w in workers} <= listed or
                              listed & {str(p) for p in others.values()}):
                raise AssertionError(f"nvidia-smi lists {sorted(listed)}: workers "
                                     f"{[w.proc.pid for w in workers]}, others {others}")
            if not all(cuda_maps[w.name] for w in workers) or \
                    any(cuda_maps[k] is not False for k in ("tracing_server", "coordinator",
                                                             "client", "client_repeat")):
                raise AssertionError(f"libcuda mapped: {cuda_maps}")
            # stop the workers first; each writes its launches' device ms
            for w in workers:
                w.proc.send_signal(signal.SIGTERM)
                signalled.add(w.name)
            for w in workers:
                if w.proc.wait(timeout=60) != 0:
                    raise AssertionError(f"{w.name} exited {w.proc.returncode} after SIGTERM: "
                                         f"{w.text()[-3000:]}")
                with open(os.path.join(demo_dir, f"{w.name}_device_ms.json")) as fh:
                    times = json.load(fh)
                # the launches of the demo client's run and of the sequential
                # requests, by the host time each was enqueued
                for leg, (lo, hi) in (("demo", demo_window), ("sequential", seq_window)):
                    ms = [m for t, m in times if lo <= t <= hi]
                    per_worker[workers.index(w)][leg] = {"launches": len(ms),
                                                         "device_ms": sum(ms)}
                per_worker[workers.index(w)]["launches_timed"] = len(times)
            # the tracing server has written what the nodes sent once its
            # log stops growing
            last, deadline = -1, time.monotonic() + 10
            while time.monotonic() < deadline:
                size = os.path.getsize(trace_log) if os.path.exists(trace_log) else 0
                if size == last:
                    break
                last = size
                time.sleep(0.3)
            verdict = cli("distpow_tpu_torch.cli.trace_check", trace_log, shiviz_log)
            if "0 violation(s)" not in verdict.stdout:
                raise AssertionError(f"trace_check: {verdict.stdout[-3000:]}")

            def delta(name, before, after):
                """A coordinator histogram's samples between two snapshots:
                count and mean."""
                a, b = after.get(name) or {}, before.get(name) or {}
                n = a.get("count", 0) - b.get("count", 0)
                return {"count": n,
                        "mean_s": (a.get("sum", 0) - b.get("sum", 0)) / n if n else None}

            out = {
                "results": results,
                "client_wall_s": client.lines[-1][0] if client.lines else None,
                "cached_repeat": repeat_results,
                "sequential": sequential,
                "sequential_coord": {k: delta(k, hist2, hist3) for k in (
                    "coord.first_result_s", "coord.cancel_propagation_s", "coord.mine_s.miss")},
                "boot_to_serving_s": {"tracing_server": tracer.marks["tracing server listening"],
                                      "coordinator": coordinator.marks["coordinator serving"],
                                      **{w.name: w.marks[f"serving {w.name} RPCs"]
                                         for w in workers}},
                "coord": {"first_result_s": hist.get("coord.first_result_s"),
                          "cancel_propagation_s": hist.get("coord.cancel_propagation_s"),
                          "mine_s.miss": hist.get("coord.mine_s.miss"),
                          "mine_s.hit": hist.get("coord.mine_s.hit"),
                          "fanouts": counters.get("coord.fanouts")},
                "workers": per_worker,
                "nvidia_smi": {"compute_apps": apps, "counts": counts,
                               "pids_are_this_machines": pids_seen},
                "device_less_pids": others, "libcuda_mapped": cuda_maps,
                "trace_check": verdict.stdout.strip().splitlines()[-1],
                "observe": observed,
                "card": smoke.info["device"]["nvidia_smi"],
                "phase_wall_s": time.monotonic() - t_start}
            passed = True
            return out
        finally:
            for c in rpcs:
                c.close()
            # stop every child still running; a non-zero exit other than
            # the SIGTERM sent here fails the phase
            bad = []
            for c in reversed(children):
                if c.proc.poll() is None:
                    c.proc.send_signal(signal.SIGTERM)
                    signalled.add(c.name)
            for c in children:
                try:
                    rc = c.proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    c.proc.kill()
                    rc = c.proc.wait()
                    bad.append((c.name, "killed"))
                    continue
                if rc != 0 and not (c.name in signalled and rc == -signal.SIGTERM):
                    bad.append((c.name, rc))
            if bad and passed:
                raise AssertionError(f"children exited badly: {bad}")

    def load():
        """The load harness on the card: ``InProcCluster(n_workers=4,
        backend="cuda", device="cuda")`` (the harness's own worker config,
        four workers sharing this process and its CUDA context), then
        ``run_load_slo`` at ``LOAD_MIX`` judged against ``config/slo.json``,
        then a compressed ``run_soak`` on the same cluster.  Every completed
        request's secret is checked with hashlib, errors must be 0, both
        verdicts must exit 0, and md5's solo and persistent kernels must have
        launched (the counts set to 0 just before and read just after).  Each
        run's client-side exact percentiles, the coordinator's merged
        run-window percentiles, the generator's lag and the launches per
        kernel form are reported.  Last, ``demo``'s requests on this cluster
        (the demo client's four at once, then four one at a time), for the
        same requests in one process against ``demo``'s four."""
        import argparse

        from distpow_tpu_torch.cli.soak import build_shape
        from distpow_tpu_torch.cli.stats import fetch_stats
        from distpow_tpu_torch.load import (InProcCluster, LoadMix, exact_percentile,
                                            run_load_slo, run_soak)
        from distpow_tpu_torch.load.harness import keeping_results
        from distpow_tpu_torch.obs.merge import delta_merged
        from distpow_tpu_torch.obs.scrape import scrape_cluster

        def pcts(samples_or_hist):
            if isinstance(samples_or_hist, list):
                return {"n": len(samples_or_hist),
                        **{f"p{q}_ms": None if v is None else v * 1e3
                           for q, v in ((50, exact_percentile(samples_or_hist, 0.50)),
                                        (95, exact_percentile(samples_or_hist, 0.95)),
                                        (99, exact_percentile(samples_or_hist, 0.99)))}}
            h = samples_or_hist or {}
            return {"n": h.get("count", 0),
                    **{f"{q}_ms": None if h.get(q) is None else h[q] * 1e3
                       for q in ("p50", "p95", "p99")}}

        def judged(name, report, verdict, window, tracker, wall_s):
            """One run's checks and numbers."""
            for res in tracker.results:
                if res.error is not None or res.secret is None:
                    raise AssertionError(f"{name}: {res.nonce.hex()} "
                                         f"d{res.num_trailing_zeros}: {res.error}")
                digest = hashlib.md5(bytes(res.nonce) + bytes(res.secret)).hexdigest()
                if not digest.endswith("0" * res.num_trailing_zeros):
                    raise AssertionError(f"{name}: {res.nonce.hex()} d{res.num_trailing_zeros} "
                                         f"{res.secret.hex()}: md5 {digest}")
            issued = report["load"]["issued"]
            if report["request_errors"] or report["completed"] != issued or \
                    len(tracker.results) != issued or verdict.exit_code() != 0:
                raise AssertionError(f"{name}: {issued} offered, {report['completed']} "
                                     f"completed, {report['request_errors']} errors "
                                     f"({report['error_samples']}), client "
                                     f"{report['client_latency_ms']}, generator lag max "
                                     f"{report['load']['max_lag_s']} s, verdict "
                                     f"{verdict.to_dict()}")
            hists = window.get("histograms") or {}
            return {"offered": issued, "completed": report["completed"], "errors": 0,
                    "wall_s": wall_s, "verdict": verdict.status,
                    "difficulties": dict(collections.Counter(
                        r.num_trailing_zeros for r in tracker.results)),
                    "client_exact": pcts(list(tracker.latencies_s)),
                    "merged": {k: pcts(hists.get(k)) for k in (
                        "coord.mine_s.miss", "coord.mine_s.hit", "coord.first_result_s",
                        "powlib.mine_s")},
                    "cache_hits": (window.get("counters") or {}).get("cache.hit", 0),
                    "coalesced": (window.get("counters") or {}).get(
                        "sched.coalesced_requests", 0),
                    "generator_lag": {**{k: report["load"][k] for k in ("max_lag_s",
                                                                        "mean_lag_s")},
                                      "p99_s": (hists.get("load.lag_s") or {}).get("p99")},
                    "report": {k: report[k] for k in ("load", "client_latency_ms",
                                                      "achieved_solves_per_s")}}

        with keeping_results() as trackers:
            cluster = None
            try:
                t_boot = time.monotonic()
                cluster = InProcCluster(n_workers=LOAD_WORKERS, backend="cuda", device="cuda")
                boot_s = time.monotonic() - t_boot
                workers = [fetch_stats(a, role="worker", timeout=60) for a in cluster.worker_addrs]
                if any(not w["device"].startswith("cuda") or w["backend"] != "CudaBackend"
                       for w in workers):
                    raise AssertionError(
                        f"workers: {[(w['device'], w['backend']) for w in workers]}")
                for counter in LAUNCHES.values():
                    counter.reset()
                runs = {}
                before = scrape_cluster([cluster.client_addr], deadline_s=30)
                t0 = time.monotonic()
                report, verdict = run_load_slo(LoadMix(**LOAD_MIX), SLO_CONFIG, cluster=cluster,
                                               include_worker_targets=True)
                wall_s = time.monotonic() - t0
                after = scrape_cluster([cluster.client_addr], deadline_s=30)
                runs["load"] = judged("load", report, verdict, delta_merged(after, before),
                                      trackers[-1], wall_s)
                # the merged percentile over the coordinator and its workers
                # within one log bucket of the coordinator's own
                oracle = report.get("oracle_check") or {}
                if not oracle.get("ok") or oracle.get("nodes") != LOAD_WORKERS + 1:
                    raise AssertionError(f"load: merged coord.mine_s.miss against the "
                                         f"coordinator's own: {oracle}")
                runs["load"]["oracle_check"] = oracle
                shape = build_shape(argparse.Namespace(
                    minutes=LOAD_SOAK_MINUTES, compress=320.0, base_hz=6.0, amplitude_hz=4.0,
                    spike_hz=18.0, spike_frac=0.55, spike_width_frac=0.08))
                mix = LoadMix(**{**LOAD_MIX, "seed": LOAD_SOAK_SEED})
                before = after
                t0 = time.monotonic()
                report, verdict = run_soak(shape, mix, SLO_CONFIG, cluster=cluster)
                wall_s = time.monotonic() - t0
                after = scrape_cluster([cluster.client_addr], deadline_s=30)
                runs["soak"] = judged("soak", report, verdict, delta_merged(after, before),
                                      trackers[-1], wall_s)
                runs["soak"]["phases"] = [(p.name, p.status) for p in verdict.phases]
                runs["soak"]["leak_suspects"] = verdict.leak_suspects
                # demo's requests on this cluster: the demo client's four at once,
                # then DEMO_SEQUENTIAL's one at a time (four workers in one
                # process and context, where demo's are four processes)
                same = {}
                for leg, requests, together in (("concurrent", WORKER_DEMO[:4], True),
                                                ("sequential", DEMO_SEQUENTIAL, False)):
                    before = scrape_cluster([cluster.client_addr], deadline_s=30)
                    ms = []
                    for i, (nonce, d) in enumerate(requests):
                        t1 = time.monotonic()
                        cluster.client.mine(nonce, d)
                        if together and i < len(requests) - 1:
                            continue
                        for _ in range(len(requests) if together else 1):
                            res = cluster.client.notify_queue.get(timeout=DEMO_TIMEOUT_S)
                            if res.error is not None or not hashlib.md5(
                                    bytes(res.nonce) + bytes(res.secret)).hexdigest().endswith(
                                        "0" * res.num_trailing_zeros):
                                raise AssertionError(f"{leg}: {res.nonce.hex()} "
                                                     f"d{res.num_trailing_zeros}: {res.error}")
                            ms.append((time.monotonic() - t1) * 1e3)
                    window = delta_merged(scrape_cluster([cluster.client_addr], deadline_s=30),
                                          before)
                    hists = window.get("histograms") or {}
                    same[leg] = {"client_ms": ms, **{k: {
                        "n": (hists.get(k) or {}).get("count", 0),
                        "mean_ms": (hists[k]["sum"] / hists[k]["count"] * 1e3
                                    if (hists.get(k) or {}).get("count") else None)}
                        for k in ("coord.first_result_s", "coord.cancel_propagation_s",
                                  "coord.mine_s.miss")}}
                launches = {k: c.value for k, c in LAUNCHES.items() if c.value}
                kernel = KERNELS["md5"]
                if not launches.get(kernel) or not launches.get(f"{kernel}_persistent"):
                    raise AssertionError(f"md5's solo and persistent kernels: {launches}")
                return {"workers": LOAD_WORKERS, "boot_s": boot_s,
                        "devices": [w["device"] for w in workers],
                        "mix": {k: v for k, v in LOAD_MIX.items()}, **runs,
                        "demo_requests": same,
                        "kernel_launches": launches,
                        "card": smoke.info["device"]["nvidia_smi"]}
            finally:
                if cluster is not None:
                    cluster.close()

    def lock_audit():
        """The runtime lock-order audit on the card: ``python -m
        distpow_tpu_torch.tools.lock_audit`` in a fresh process loads the
        port's ``runtime/lockcheck.py`` by path and installs it before it
        imports the port, boots ``InProcCluster(n_workers=LOAD_WORKERS,
        backend="cuda", device="cuda")``, runs ``run_load_slo`` at
        ``LOAD_MIX`` for ``LOCK_AUDIT_LOAD_S``,
        then ``demo``'s requests as ``load`` does after its runs (the demo
        client's four at once, then ``DEMO_SEQUENTIAL`` one at a time),
        every secret checked with hashlib.  Fails on an observed lock-order
        inversion, on no instrumented site of the port, or on no launch of
        md5's persistent kernel (the card served).  Reports the sites and
        edges, the five sites with the most held seconds and the five with
        the longest hold, and the requests' latencies with the audit on
        beside ``load``'s without it."""
        env = {**os.environ, "PYTHONPATH": HERE, "PYTHONUNBUFFERED": "1",
               "DISTPOW_TORCH_BUILD_DIR": _build.BUILD_DIR}
        env.pop("DISTPOW_LOCK_CHECK", None)
        args = ["--backend", "cuda", "--device", "cuda", "--workers", str(LOAD_WORKERS),
                "--concurrent", *(f"{n.hex()}:{d}" for n, d in WORKER_DEMO[:4]),
                "--sequential", *(f"{n.hex()}:{d}" for n, d in DEMO_SEQUENTIAL),
                "--duration-s", str(LOCK_AUDIT_LOAD_S),
                "--difficulty", *(f"{d}:{w}" for d, w in LOAD_MIX["difficulties"])]
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, "-m", "distpow_tpu_torch.tools.lock_audit",
                               *args], cwd=HERE, env=env, capture_output=True, text=True,
                              timeout=240)
        wall_s = time.monotonic() - t0
        with open(os.path.join(OUT_DIR, "lock_audit.log"), "w") as fh:
            fh.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        if proc.returncode != 0:
            raise AssertionError(f"lock_audit exited {proc.returncode}: "
                                 f"{(proc.stdout + proc.stderr)[-3000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        audit = out["audit"]
        persistent = out["kernel_launches"].get(f"{KERNELS['md5']}_persistent", 0)
        if audit["cycles"] or not audit["port_sites_held"] or not persistent:
            raise AssertionError(f"cycles {audit['cycles']}, port sites "
                                 f"{audit['port_sites_held']}, launches "
                                 f"{out['kernel_launches']}")
        without = (smoke.info.get("load") or {}).get("demo_requests") or {}
        return {**out, "wall_s_process": wall_s,
                "demo_requests_without_audit": {
                    leg: (without.get(leg) or {}).get("client_ms") for leg in
                    ("concurrent", "sequential")},
                "load_without_audit": ((smoke.info.get("load") or {}).get("load") or {}).get(
                    "client_exact"),
                "card": smoke.info["device"]["nvidia_smi"]}

    def lint():
        """``python -m distpow_tpu_torch.cli.lint --json`` in a fresh process
        from the tree's root (``LINT_SHIM``, so its maps are read while it
        waits): exit 0, no finding, every suppression justified, no module
        of ``torch`` or JAX loaded and the CUDA driver library not
        mapped."""
        t0 = time.monotonic()
        log = os.path.join(OUT_DIR, "lint.log")
        rc, stdout, mapped = run_cli("distpow_tpu_torch.cli.lint", ["--json"], HERE,
                                     {**os.environ, "PYTHONPATH": HERE}, log, timeout=120,
                                     shim=LINT_SHIM)
        wall_s = time.monotonic() - t0
        report_text, _, loaded = stdout.rstrip("\n").rpartition("\n")
        report, loaded = json.loads(report_text), json.loads(loaded)
        if rc != 0 or report["findings"] or not report["ok"] or mapped is not False or \
                loaded or not all(s["justification"] for s in report["suppressed"]):
            raise AssertionError(f"lint: exit {rc}, findings {report['findings'][:5]}, "
                                 f"libcuda mapped {mapped}, loaded {loaded}")
        return {"exit": rc, "findings": len(report["findings"]),
                "suppressed": len(report["suppressed"]),
                "checked_files": report["checked_files"], "wall_s_process": wall_s,
                "maps_libcuda": mapped, "loaded_torch_or_jax": loaded,
                "suppressed_by_rule": dict(collections.Counter(
                    s["rule"] for s in report["suppressed"]))}

    def mesh_procs():
        """The mesh across processes: ``MESH_PROCS_RANKS`` processes of
        ``python -m distpow_tpu_torch.tools.mesh_procs`` in one
        ``torch.distributed`` group, each with ``MESH_PROCS_LOCAL`` logical
        shards (``MESH_SHARDS`` in all, as ``mine_mesh`` has), loading the
        libraries the ``build`` phase made.  On one card the group is gloo
        over CUDA tensors (NCCL refuses a card twice in one communicator);
        where two or more GPUs are visible a second group is NCCL, a card
        per rank.  Each rank runs the tool's small legs and, for each of
        ``MESH_PROCS_MODELS``, the serial and the persistent mesh step at
        the worker's main-path launch on ``full_parity``'s nonce at
        difficulty 7, whose first hit lies on rank 1's shards: both ranks
        must report the one-process mesh's index (``mesh_full_parity``)
        and the plain version's (``full_parity``), and launch each mesh
        kernel form."""
        import socket

        mains, want = [], {}
        for name in MESH_PROCS_MODELS:
            sfx = suffix(name)
            fp, mfp = smoke.info[f"full_parity{sfx}"], smoke.info[f"mesh_full_parity{sfx}"]
            deep = mfp["cases"][0]
            if (deep["tbc"], deep["difficulty"], fp["cases"][0]["difficulty"]) != (256, 7, 7):
                raise AssertionError(f"{name}: no difficulty-7 case to hold the ranks to")
            mains.append(f"{name}:{fp['nonce']}:7")
            want[name] = {"leg": f"main_{name}_{fp['nonce']}_7", "one_process_mesh": deep["mesh"],
                          "plain": fp["cases"][0]["plain"]}

        def run(backend, env_of):
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                port = sk.getsockname()[1]
            t0 = time.monotonic()
            procs = [subprocess.Popen(
                [sys.executable, "-m", "distpow_tpu_torch.tools.mesh_procs", str(rank),
                 str(MESH_PROCS_RANKS), str(port), "--backend", backend, "--timeout",
                 str(MESH_PROCS_TIMEOUT_S), *(a for _ in range(MESH_PROCS_LOCAL)
                                              for a in ("--device", "cuda:0")),
                 *(a for m in mains for a in ("--main", m))],
                cwd=HERE, env={**os.environ, "PYTHONPATH": HERE, **env_of(rank)},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for rank in range(MESH_PROCS_RANKS)]
            outs = []
            try:
                for p in procs:
                    out, err = p.communicate(timeout=MESH_PROCS_TIMEOUT_S)
                    if p.returncode != 0:
                        raise AssertionError(f"{backend} rank {len(outs)} exited "
                                             f"{p.returncode}: {err[-3000:]}")
                    # the legs' lines; a library may print lines of its own
                    outs.append({ln["leg"]: ln for ln in map(json.loads, (
                        line for line in out.splitlines() if line.startswith('{"leg"')))})
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            wall = time.monotonic() - t0
            mismatches, ranks = [], []
            for rank, lines in enumerate(outs):
                launched = collections.Counter()
                for line in lines.values():
                    launched.update(line["kernel_launches"])
                    if line["shards"] != MESH_SHARDS or line["backend"] != backend:
                        mismatches.append({"rank": rank, "leg": line["leg"], "shards":
                                           line["shards"], "backend": line["backend"]})
                for name in MESH_PROCS_MODELS:
                    for loop in ("serial", "persistent"):
                        line = lines[f"{want[name]['leg']}_{loop}"]
                        idx = want[name]["plain"]
                        secret = assemble_secret(MAIN_CHUNK0, idx, 4, b"", 0, 256)[0].hex()
                        if not line["index"] == idx == want[name]["one_process_mesh"] or \
                                line["secret"] != secret or \
                                line["shard"] < MESH_SHARDS - MESH_PROCS_LOCAL:
                            mismatches.append({"rank": rank, "leg": line["leg"],
                                               "index": line["index"], "shard": line["shard"],
                                               **want[name]})
                    kernel = KERNELS[name]
                    if not launched[f"{kernel}_mesh"] > 0 < launched[f"{kernel}_mesh_persistent"]:
                        mismatches.append({"rank": rank, "kernel": kernel,
                                           "launches": dict(launched)})
                for leg, secret in (("factory", "9001"), ("sha3_256", "cc01"),
                                    ("persistent_factory", "9001"),
                                    ("persistent_sha3_256", "cc01")):
                    if lines[leg]["secret"] != secret:
                        mismatches.append({"rank": rank, "leg": leg,
                                           "secret": lines[leg]["secret"]})
                ranks.append({"launches": dict(launched), "legs": {
                    leg: {k: line.get(k) for k in
                          ("secret", "index", "launches", "wall_s", "blocking_syncs",
                           "collective_host_waits", "collective_s", "host_waits_per_launch",
                           "ms_per_launch") if k in line}
                    for leg, line in lines.items()}})
            if any(outs[0][leg].get(k) != outs[-1][leg].get(k) for leg in outs[0]
                   for k in ("secret", "index", "rows", "words")):
                mismatches.append({"ranks_disagree": True})
            if mismatches:
                raise AssertionError(f"{backend}: {len(mismatches)} mismatches: "
                                     f"{mismatches[:6]}")
            return {"backend": backend, "ranks": MESH_PROCS_RANKS, "shards": MESH_SHARDS,
                    "wall_s": wall, "mismatches": 0, "per_rank": ranks}

        out = {"want": want, "gloo_one_card": run("gloo", lambda rank: {})}
        n_gpus = torch.cuda.device_count()
        if n_gpus >= MESH_PROCS_RANKS:
            out["nccl_card_per_rank"] = run("nccl",
                                            lambda rank: {"CUDA_VISIBLE_DEVICES": str(rank)})
        else:
            out["nccl_card_per_rank"] = f"not run: {n_gpus} GPU(s) visible, a card per rank " \
                                        f"needs {MESH_PROCS_RANKS}"
        return out

    for i, model_name in enumerate(MODELS):
        model = get_hash_model(model_name)
        sfx = suffix(model_name)
        if model_name == "md5":
            grid_args = (20261016, NONCE_LENS, DIFFICULTIES)
        else:
            grid_args = (20261016 + i, NONCE_LENS_REDUCED.get(model_name, NONCE_LENS_64),
                         DIFFICULTIES_REDUCED)
        smoke.phase(f"kernel_parity{sfx}", lambda: kernel_parity(model, *grid_args),
                    needs=("build",))
        smoke.phase(f"full_parity{sfx}", lambda: full_parity(model), needs=("build", "device"))
        smoke.phase(f"persistent_parity{sfx}", lambda: persistent_parity(model, 20261019 + i),
                    needs=("build", "device", f"full_parity{sfx}"))
        smoke.phase(f"mine{sfx}", lambda: mine(model), needs=(f"kernel_parity{sfx}",))
        if model_name == "md5":
            smoke.phase("cancel", cancel, needs=("build",))
        smoke.phase(f"rate{sfx}", lambda: rate(model), needs=("build", "device"))
        smoke.phase(f"group_parity{sfx}", lambda: group_parity(model, grid_args[0] + 100,
                                                               grid_args[1]),
                    needs=("build",))
        smoke.phase(f"group_full_parity{sfx}",
                    lambda: group_full_parity(model, grid_args[0] + 200, grid_args[1]),
                    needs=("build", "device"))
        smoke.phase(f"rate_group{sfx}", lambda: rate_group(model),
                    needs=("build", "device", f"group_parity{sfx}"))
    smoke.phase("sched_md5", sched_md5, needs=("group_parity",))
    smoke.phase("sched_mixed", sched_mixed,
                needs=tuple(f"group_parity{suffix(m)}" for m in MIXED_MODELS))
    for model_name in ("sha512", "sha384"):
        smoke.phase(f"sched_{model_name}", lambda: sched_wide(model_name),
                    needs=(f"group_parity_{model_name}",))
    smoke.phase("sched_cancel", sched_cancel, needs=("build",))
    for i, model_name in enumerate(MODELS):
        model = get_hash_model(model_name)
        sfx = suffix(model_name)
        lens = NONCE_LENS if model_name == "md5" else \
            NONCE_LENS_REDUCED.get(model_name, NONCE_LENS_64)
        smoke.phase(f"mesh_parity{sfx}", lambda: mesh_parity(model, 20261018 + i, lens),
                    needs=("build", "device"))
        smoke.phase(f"mesh_full_parity{sfx}", lambda: mesh_full_parity(model),
                    needs=("build", "device", f"full_parity{sfx}"))
    smoke.phase("mine_mesh", mine_mesh, needs=("mesh_parity", "mesh_parity_sha512"))
    smoke.phase("rate_mesh", rate_mesh, needs=("mesh_full_parity",))
    # the requests run under sync debug mode "error", as in sched_*
    smoke.phase("sched_mesh", sched_mesh, needs=("group_parity", "mesh_parity"))
    smoke.phase("worker_mine", worker_mine, needs=("build", "mine"))
    smoke.phase("worker_fanout", worker_fanout, needs=("build", "mine"))
    smoke.phase("worker_mesh", worker_mesh, needs=("build", "mesh_parity", "persistent_parity"))
    # the Mines run under sync debug mode "error", as in sched_*
    smoke.phase("worker_sched", worker_sched,
                needs=tuple(f"group_parity{suffix(m)}" for m in WORKER_SCHED_MODELS))
    smoke.phase("worker_cli", worker_cli, needs=("build", "mine"))
    smoke.phase("native", native, needs=("mine",))
    smoke.phase("demo", demo, needs=("build", "mine"))
    smoke.phase("load", load, needs=("build", "mine"))
    smoke.phase("lock_audit", lock_audit, needs=("build", "mine"))
    smoke.phase("lint", lint)
    smoke.phase("mesh_procs", mesh_procs,
                needs=("build", *(f"{p}{suffix(m)}" for m in MESH_PROCS_MODELS
                                  for p in ("full_parity", "mesh_full_parity"))))

    kernels = []
    for model_name in MODELS:
        sfx = suffix(model_name)
        phases = [f"{p}{sfx}" for p in ("kernel_parity", "full_parity", "mine", "rate")]
        if not all(p in smoke.info for p in phases):
            continue
        kernel, r = KERNELS[model_name], smoke.info[f"rate{sfx}"]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": f"distpow_tpu_torch/csrc/{kernel}.cu",
            "replaces": REPLACES[model_name],
            "launches": smoke.info[f"mine{sfx}"]["kernel_launches"][kernel],
            "max_abs_err": max(smoke.info[p]["max_abs_err"] for p in phases[:2]),
            "ms": r["ms"], "plain_ms": r["plain_ms_part"],
            "bound_ms": r["bound_ms"], "bound_by": "operations", "library_ms": None})
    for model_name in MODELS:
        sfx = suffix(model_name)
        served = {"md5": "sched_md5", "sha512": "sched_sha512",
                  "sha384": "sched_sha384"}.get(model_name, "sched_mixed")
        phases = [f"group_parity{sfx}", f"group_full_parity{sfx}", f"rate_group{sfx}", served]
        if not all(p in smoke.info for p in phases):
            continue
        kernel, r = KERNELS[model_name], smoke.info[f"rate_group{sfx}"]
        kernels.append({
            "name": f"{kernel}_group", "route": "cuda",
            "source": f"distpow_tpu_torch/csrc/{kernel}.cu", "replaces": REPLACES_GROUP,
            "launches": smoke.info[served]["group_launches"][kernel],
            "max_abs_err": max(smoke.info[p]["max_abs_err"] for p in phases[:2]),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "operations", "library_ms": None})
    for model_name in MODELS:
        sfx = suffix(model_name)
        phases = [f"mesh_parity{sfx}", f"mesh_full_parity{sfx}", "mine_mesh"]
        if not all(p in smoke.info for p in phases):
            continue
        full = smoke.info[f"mesh_full_parity{sfx}"]
        kernel, r = KERNELS[model_name], full["timed"]
        kernels.append({
            "name": f"{kernel}_mesh", "route": "cuda",
            "source": f"distpow_tpu_torch/csrc/{kernel}.cu", "replaces": REPLACES_MESH,
            "launches": smoke.info["mine_mesh"]["mesh_kernel_launches"][kernel],
            "max_abs_err": max(smoke.info[p]["max_abs_err"] for p in phases[:2]),
            "ms": r["ms"], "plain_ms": full["plain"]["ms"],
            "bound_ms": r["bound_ms"], "bound_by": "operations", "library_ms": None})
    for model_name in MODELS:
        sfx = suffix(model_name)
        phases = [f"persistent_parity{sfx}", f"mine{sfx}", "mine_mesh"]
        if not all(p in smoke.info for p in phases):
            continue
        kernel, pp = KERNELS[model_name], smoke.info[f"persistent_parity{sfx}"]
        main = pp["main_path"]
        # both forms at the main path's launch with the deep hit, each
        # against the plain persistent step on it (the mesh's segments are
        # the solo launch's, so its plain version is the same step)
        for form, launches in (
                ("persistent", smoke.info[f"mine{sfx}"]["kernel_launches"][f"{kernel}_persistent"]),
                ("mesh_persistent",
                 smoke.info["mine_mesh"]["mesh_persistent_kernel_launches"][kernel])):
            kernels.append({
                "name": f"{kernel}_{form}", "route": "cuda",
                "source": f"distpow_tpu_torch/csrc/{kernel}.cu",
                "replaces": REPLACES[model_name] if form == "persistent" else REPLACES_MESH,
                "launches": launches, "max_abs_err": pp["max_abs_err"],
                "ms": main["ms"][form], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": "operations", "library_ms": None})
    if kernels:
        emit({"kernels": kernels})
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
