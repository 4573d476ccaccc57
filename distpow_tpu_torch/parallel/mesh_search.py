"""Multi-device search over a mesh of devices: prefix -> device.

The port's counterpart of the reference's ``distpow_tpu/parallel/
mesh_search.py``.  Inside one worker process the worker's thread-byte
range is split across the shards of a mesh the way the coordinator splits
it across workers (coordinator.go:326, worker.go:301-316), and every launch
ends in the least first-hit index across the shards, so all shards stop at
the same launch boundary: the coordinator's "first result wins" without an
RPC.

A ``Mesh`` is an ordered list of explicit ``torch.device``s, one shard
each.  Shards may share a device: ``make_mesh(["cuda:0"] * 4)`` is four
logical shards on one card and runs exactly the code that four cards run
(the reference's tests force XLA's host device count for the same end);
``make_mesh(["cpu"] * 4)`` runs the plain versions on the CPU.

Two sharding regimes, chosen as the reference chooses them
(``tb_split = tbc >= n_dev and tbc % n_dev == 0``):

* **thread-byte split**: shard ``d`` owns the run ``tb_lo + d * tbl ..``
  of ``tbl = tbc / n_dev`` thread bytes and scans the launch's chunks;
* **chunk split** (fewer thread bytes than shards, or a count the shards do
  not divide): shard ``d`` owns the contiguous span of chunks ``chunk0 + d
  * span ..`` over the whole run.

Both report hits as the partition's flat index (chunk-major over the whole
run; ``search_step.MeshOrigin``), so the driver's decode and the reference
enumeration order are those of the single-device path.  Unlike the
reference's Pallas mesh step, the kernel serves any shard count, any run
and two-block tails: the layout is a runtime argument of a CUDA kernel, so
nothing is compiled per nonce and nothing falls back.

The cross-shard min (the reference's ``lax.pmin``) runs in one process:
each shard launches on its own stream behind the caller's current stream
of its device, the caller's stream waits on each shard's, the cells come
to the first shard's device (``non_blocking``) and the least uint32 is
taken there (``Mesh.run``).  Nothing waits on the host, so the driver's one
pinned fetch stays the only host wait per launch.

The persistent loop's mesh step (``mesh_persistent_factory``, the
counterpart of the reference's ``mesh_persistent_factory`` and
``mesh_persistent_step``) is the same launch with each shard's kernel in
its persistent form (``hash_mesh_persistent_search``): a shard stops about
one segment after its own first hit or after the search's stop flag, and
reports its segments in the partition's; the least of each of the two
words across the shards (``Mesh.run``) is the launch's result.  The
partition's segment is a shard segment's chunks over the whole run, so the
launch's first hit and segment count are those of the solo persistent step
at that segment.  Shards do not share a cell: a shard runs on after
another shard's hit until its own hit, its end or the flag.
"""

from __future__ import annotations

import functools
import math
from dataclasses import fields, replace
from typing import Callable, List, Optional, Sequence

import torch

from ..models.registry import HashModel, get_hash_model
from ..ops.hash_cuda import (BLOCK_THREADS, hash_group_search, hash_mesh_persistent_search,
                              hash_mesh_search, kernel_name, one_wave_for)
from ..ops.operands import MASK32, Device, GroupOperands, u32_bits, u32_min, widen
from ..ops.packing import build_tail_spec
from ..ops.search_step import MeshOrigin, MeshShard, _check_launch, step_operands
from ..runtime.metrics import REGISTRY
from .partition import contiguous_bounds
from .search import (PersistentFactory, SearchResult, StepFactory, scaled_launch_candidates,
                     search)

AXIS = "workers"


def explicit_device(device: Device) -> torch.device:
    """``device`` with its index (a bare ``cuda`` is the current GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {dev}: CUDA is not available; a mesh on the CPU "
                               f"is make_mesh(['cpu'] * n)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"mesh device {dev}: {torch.cuda.device_count()} GPU(s) visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev}")
    return dev


class Mesh:
    """Shards on explicit devices, in order; on CUDA each shard has its own
    stream.  ``run`` launches one callable per shard and returns the least
    uint32 of their results (the reference's ``lax.pmin``)."""

    def __init__(self, devices: Sequence[Device], axis: str = AXIS) -> None:
        devs = tuple(explicit_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"mesh devices of more than one type: {devs}")
        self.devices = devs
        self.axis = axis
        self.streams = (tuple(torch.cuda.Stream(d) for d in devs)
                        if devs[0].type == "cuda" else None)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def run(self, launches: Sequence[Callable[[], torch.Tensor]]) -> torch.Tensor:
        """``launches[d]()`` on shard ``d`` (at most one per shard, from the
        first), each returning a result on that shard's device; the least
        uint32 across them, as ``int32`` bit patterns on the first shard's
        device, without a host wait.  On CUDA shard ``d`` runs on its own
        stream after the caller's current stream of its device (where the
        shard's operands were written), and that stream waits for it before
        the result moves on."""
        if len(launches) > self.size:
            raise ValueError(f"{len(launches)} launches on a mesh of {self.size}")
        if self.streams is None:
            return u32_min(torch.stack([u32_bits(launch()) for launch in launches]))
        first = self.devices[0]
        cells = []
        for launch, dev, stream in zip(launches, self.devices, self.streams):
            here = torch.cuda.current_stream(dev)
            stream.wait_stream(here)
            with torch.cuda.stream(stream):
                cell = u32_bits(launch())
            here.wait_stream(stream)
            cell.record_stream(here)  # its memory is read on `here` from now on
            cells.append(cell)
        with torch.cuda.device(first):
            return u32_min(torch.stack([c.to(first, non_blocking=True) for c in cells]))


def gpu_devices(first: Device = "cuda", n: int = 0) -> List[torch.device]:
    """The GPUs of a mesh that starts at ``first`` (a bare ``cuda``: the
    current GPU), then the other visible GPUs in order: ``n`` of them (0:
    every visible GPU); more than are visible raises."""
    first = explicit_device(first)
    visible = torch.cuda.device_count()
    n = n or visible
    if n > visible:
        raise ValueError(f"a mesh of {n} GPUs from {first}, but {visible} GPU(s) are visible")
    return ([first] + [torch.device("cuda", i) for i in range(visible) if i != first.index])[:n]


def make_mesh(devices: Optional[Sequence[Device]] = None, axis: str = AXIS) -> Mesh:
    """A mesh over ``devices`` (default: every visible GPU, and none
    raises); sets the ``search.mesh_devices`` gauge."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh() spans every visible GPU and none is visible; "
                               "pass devices, e.g. make_mesh(['cpu'] * 4)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = Mesh(devices, axis)
    REGISTRY.gauge("search.mesh_devices", mesh.size)
    return mesh


def tb_split_regime(tbc: int, n_dev: int) -> bool:
    """Thread-byte split when the shards divide the run, else chunk split."""
    return tbc >= n_dev and tbc % n_dev == 0


def mesh_shards(tb_lo: int, tbc: int, chunk0: int, n_dev: int, chunks_local: int,
                launch_steps: int) -> List[MeshShard]:
    """Each shard's slice of a launch of ``launch_steps`` sub-batches from
    ``chunk0``: in the thread-byte split every shard scans ``launch_steps *
    chunks_local`` chunks on its ``tbc / n_dev`` thread bytes; in the chunk
    split shard ``d`` scans the span of ``launch_steps * chunks_local``
    chunks from ``chunk0 + d * launch_steps * chunks_local`` on the whole
    run (contiguous spans, as the reference's Pallas mesh step assigns
    them).  Together the shards cover the launch's candidates once."""
    if tb_split_regime(tbc, n_dev):
        tbl = tbc // n_dev
        return [MeshShard(tb_lo + d * tbl, tbl, chunk0, chunks_local * tbl, launch_steps)
                for d in range(n_dev)]
    span = launch_steps * chunks_local
    return [MeshShard(tb_lo, tbc, (chunk0 + d * span) & MASK32, chunks_local * tbc,
                      launch_steps) for d in range(n_dev)]


def _width0_probe(tb_lo: int, tbc: int) -> List[MeshShard]:
    """Width 0 (the ``tbc`` one-byte secrets): no mesh benefit, so one
    shard, on the first device, searches the whole run; its partition index
    is ``tb - tb_lo``, the single-device probe's."""
    return [MeshShard(tb_lo, tbc, 0, tbc, 1)]


def mesh_launch(mesh: Mesh, model: HashModel, ops: Sequence, tb_loc, chunk_locs,
                shards: Sequence[MeshShard], origin: MeshOrigin) -> torch.Tensor:
    """One launch of the mesh kernels: shard ``d`` searches ``shards[d]``
    with its operands ``ops[d]`` (on ``mesh.devices[d]``, its run that of
    the shard) through ``hash_mesh_search``; the partition's first hit, or
    SENTINEL, as an ``int32`` bit pattern on the first shard's device."""
    return mesh.run([functools.partial(hash_mesh_search, model, o, tb_loc, chunk_locs, s.chunk0,
                                       s.batch, s.launch_steps, origin, device=dev)
                     for s, o, dev in zip(shards, ops, mesh.devices)])


def _chunk_split_budget(target_chunks: int, tbc: int, n_dev: int) -> int:
    """Per-shard chunk budget of the chunk-split regime: the global budget
    divided by ``n_dev``, normalised to a multiple of 256 candidates, so
    one dispatch never covers ``n_dev`` times the configured launch volume
    and the per-shard batch does not depend on which small run a request
    carries (the reference's rule)."""
    eb_local = max(256, (target_chunks * tbc // n_dev) // 256 * 256)
    return max(1, eb_local // tbc)


def _chunks_local(target_chunks: int, tbc: int, n_dev: int) -> int:
    if tb_split_regime(tbc, n_dev):
        return max(1, target_chunks)  # every shard scans the launch's chunks
    return _chunk_split_budget(target_chunks, tbc, n_dev)


def _global_chunks(chunks_local: int, tbc: int, n_dev: int, launch_steps: int) -> int:
    """Chunks one launch covers (the driver's cursor advance)."""
    span = chunks_local if tb_split_regime(tbc, n_dev) else chunks_local * n_dev
    return span * launch_steps


def _shard_persistent(model: HashModel, ops, tb_loc, chunk_locs, shard: MeshShard,
                      origin: MeshOrigin, seg: int, total: int, stop, one_wave: bool,
                      dev: torch.device):
    """One shard's persistent launch, on the current stream of its device
    (the shard's, under ``Mesh.run``), which also reads the flag's word."""
    word = stop.operand(dev)
    if dev.type == "cuda":
        word.record_stream(torch.cuda.current_stream(dev))
    return hash_mesh_persistent_search(model, ops, tb_loc, chunk_locs, shard.chunk0, shard.batch,
                                       shard.launch_steps, origin, seg, total, word, device=dev,
                                       one_wave=one_wave)


def _mesh_binding(nonce: bytes, difficulty: int, tb_lo: int, tbc: int, model: HashModel,
                  mesh: Mesh, max_launch: Optional[int]):
    """What both mesh step factories share: ``place(target_chunks,
    launch_steps) -> (chunks_local, k, chunks)``, one launch's per-shard
    chunks, sub-batches and global chunks (the driver's cursor advance),
    and ``bind(vw, extra, chunks_local, k) -> (spec, ops)``, the tail and
    each shard's operands (cached).  The per-shard batch is rounded up to a
    whole number of the kernel's blocks (256 candidates), and the launch
    multiplier is clamped again to the rounded global batch, so a launch
    stays within ``max_launch`` and every partition index below 2^31."""
    kernel_name(model)  # raises for a model without a kernel
    n_dev = mesh.size
    tbl = tbc // n_dev if tb_split_regime(tbc, n_dev) else tbc
    budget = min(max_launch or (1 << 31) - 1, (1 << 31) - 1)

    @functools.lru_cache(maxsize=32)
    def bind(vw: int, extra: bytes, chunks_local: int, launch_steps: int):
        spec = build_tail_spec(bytes(nonce), vw, model, extra)
        runs = (mesh_shards(tb_lo, tbc, 0, n_dev, chunks_local, launch_steps)
                if vw else _width0_probe(tb_lo, tbc))
        return spec, [step_operands(spec, difficulty, model, s.tb_lo, s.tb_count, dev)
                      for s, dev in zip(runs, mesh.devices)]

    def place(target_chunks: int, launch_steps: int):
        chunks_local = _chunks_local(target_chunks, tbc, n_dev)
        # a whole number of 256-candidate blocks per shard
        whole = BLOCK_THREADS // math.gcd(BLOCK_THREADS, tbl)
        chunks_local = -(-chunks_local // whole) * whole
        batch_global = chunks_local * tbl * n_dev
        k = max(1, min(launch_steps, budget // batch_global))
        _check_launch(batch_global, k)
        return chunks_local, k, _global_chunks(chunks_local, tbc, n_dev, k)

    return bind, place


def _cuda_mesh_step_factory(nonce: bytes, difficulty: int, tb_lo: int, tbc: int,
                            model: HashModel, mesh: Mesh,
                            max_launch: Optional[int] = None) -> StepFactory:
    """Step factory over the mesh kernels (``hash_mesh_search``, one launch
    per shard on its device and stream, the least index across them by
    ``Mesh.run``): the counterpart of the reference's
    ``_pallas_mesh_step_factory``, with the shards of ``_mesh_binding``."""
    bind, place = _mesh_binding(nonce, difficulty, tb_lo, tbc, model, mesh, max_launch)

    def factory(vw: int, extra: bytes, target_chunks: int, launch_steps: int = 1):
        chunks_local, k, chunks = place(target_chunks, launch_steps) if vw else (1, 1, 1)
        spec, ops = bind(vw, bytes(extra), chunks_local, k)

        def step(chunk0: int) -> torch.Tensor:
            shards = (mesh_shards(tb_lo, tbc, chunk0, mesh.size, chunks_local, k)
                      if vw else _width0_probe(tb_lo, tbc))
            return mesh_launch(mesh, model, ops, spec.tb_loc, spec.chunk_locs, shards,
                               MeshOrigin(chunk0, tb_lo, tbc))

        return step, chunks

    return factory


def mesh_persistent_factory(nonce: bytes, difficulty: int, tb_lo: int, tbc: int,
                            model: HashModel, mesh: Mesh,
                            max_launch: Optional[int] = None) -> PersistentFactory:
    """The persistent loop's step over the mesh (the reference's
    ``mesh_persistent_factory``): ``factory(vw, extra, target_chunks,
    segments) -> (step(chunk0, stop), chunks_each, chunks_per_step)``, one
    persistent shard launch per shard (``hash_mesh_persistent_search``) on
    the shards of ``_mesh_binding`` and the least of each word across them.
    Each launch's ``k`` sub-batches are its segments, the partition's
    segment one shard segment's chunks over the whole run; width 0
    raises."""
    bind, place = _mesh_binding(nonce, difficulty, tb_lo, tbc, model, mesh, max_launch)

    def factory(vw: int, extra: bytes, target_chunks: int, segments: int):
        if vw == 0:
            raise ValueError("width 0 has no persistent form; serve it with the serial step")
        chunks_local, k, chunks = place(target_chunks, segments)
        spec, ops = bind(vw, bytes(extra), chunks_local, k)
        seg, total = chunks_local * tbc, chunks // chunks_local
        # a shard's launch holds its share of the launch's candidates
        one_wave = one_wave_for(chunks * tbc // mesh.size, difficulty)

        def step(chunk0: int, stop) -> torch.Tensor:
            shards = mesh_shards(tb_lo, tbc, chunk0, mesh.size, chunks_local, k)
            origin = MeshOrigin(chunk0, tb_lo, tbc)
            return mesh.run([functools.partial(_shard_persistent, model, o, spec.tb_loc,
                                               spec.chunk_locs, s, origin, seg, total, stop,
                                               one_wave, dev)
                             for s, o, dev in zip(shards, ops, mesh.devices)])

        return step, chunks_local, chunks

    return factory


def mesh_group_search(mesh: Mesh, model: HashModel, ops: GroupOperands, tb_loc, chunk_locs,
                      batch_local: int) -> torch.Tensor:
    """The scheduler's mesh lane, the counterpart of the reference's
    ``mesh_slot_search_step``: per slot of the group, the first hit in
    ``[0, batch_local * mesh.size)``, shard ``d`` searching the flat range
    ``[d * batch_local, (d + 1) * batch_local)`` with the group kernel
    (``hash_group_search``) at each slot's cursor moved ``d * batch_local /
    2^log_tbc`` chunks on, its hits moved up by ``d * batch_local``; the
    least across shards per slot, ``int32[n_slots]`` bit patterns on the
    mesh's first device (the rows' device)."""
    _check_launch(batch_local * mesh.size, 1)

    def shard(d: int, dev: torch.device) -> torch.Tensor:
        rows = GroupOperands(*(getattr(ops, f.name).to(dev, non_blocking=True)
                               for f in fields(GroupOperands)))
        log_tbc = widen(rows.log_tbc)
        moved = widen(rows.chunk0) + (torch.full_like(log_tbc, d * batch_local) >> log_tbc)
        rows = replace(rows, chunk0=u32_bits(moved))
        hits = u32_bits(hash_group_search(model, rows, tb_loc, chunk_locs, batch_local,
                                          device=dev))
        return torch.where(hits == -1, hits, hits + d * batch_local)

    return mesh.run([functools.partial(shard, d, dev) for d, dev in enumerate(mesh.devices)])


def search_mesh(nonce: bytes, difficulty: int, thread_bytes: Sequence[int], *,
                mesh: Optional[Mesh] = None, model: Optional[HashModel] = None,
                step_factory: Optional[StepFactory] = None,
                **kwargs) -> Optional[SearchResult]:
    """Mesh-parallel ``search`` with the same semantics and result decode.
    The default step is the mesh kernels' (``_cuda_mesh_step_factory``; on
    a mesh of CPU shards its wrapper runs the plain version); ``mesh``
    defaults to every visible GPU."""
    model = model or get_hash_model("md5")
    mesh = mesh if mesh is not None else make_mesh()
    tb_lo, tbc = contiguous_bounds(thread_bytes)
    if kwargs.get("launch_candidates") is None:
        kwargs["launch_candidates"] = scaled_launch_candidates(model.cost_ops)
    factory = step_factory or _cuda_mesh_step_factory(
        bytes(nonce), difficulty, tb_lo, tbc, model, mesh,
        max_launch=kwargs["launch_candidates"])
    kwargs.setdefault("device", mesh.devices[0])
    return search(nonce, difficulty, thread_bytes, model=model, step_factory=factory, **kwargs)
