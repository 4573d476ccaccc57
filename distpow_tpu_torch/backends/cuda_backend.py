"""Worker backend driving the hand-written CUDA search kernels.

Plugs ``ops.hash_cuda.hash_search`` into ``parallel.search.search`` through
the step-factory protocol, with the kernel of the backend's hash model
(each of the nine models has one; an unknown model raises).  Each
kernel takes every configuration the plain step takes (1- and 2-block
tails, power-of-two or not thread-byte runs, widths 0-4, every difficulty),
so there is no fallback path.

``DeviceBackend`` is what the ``cuda`` backend shares with the ``torch``
one (the plain step behind the same driver, ``backends/__init__.py``): the
device rule, the keyword arguments the reference worker passes
(``mesh_devices``, ``interpret``, ``loop``), the boot ``warmup`` and the
choice of driver: ``loop="persistent"`` (the reference's default) drives
``parallel.search.persistent_search`` over the backend's persistent step
(the kernels' persistent form; the plain persistent step for ``torch``),
``loop="serial"`` the serial ``search``.  Every backend name follows
``loop``: the port's kernels all have a persistent form, where the
reference's Pallas backends drove the serial loop whatever it said.

``CudaMeshBackend`` spreads each launch over a mesh of devices
(``parallel/mesh_search.py``, the mesh kernels): the counterpart of the
reference's ``PallasMeshBackend``, with the same search and warm-up flow;
only its step factory and the partitions it warms differ.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..models.registry import get_hash_model
from ..ops.hash_cuda import hash_persistent_search, hash_search, kernel_name, load_kernels
from ..ops.operands import Device, u32_value
from ..ops.packing import build_tail_spec
from ..ops.search_step import step_operands
from ..parallel.mesh_search import (_cuda_mesh_step_factory, gpu_devices, make_mesh,
                                    mesh_persistent_factory)
from ..parallel.partition import contiguous_bounds
from ..parallel.search import (StopFlag, effective_batch, launch_steps_for,
                               persistent_search, scaled_launch_candidates, search)
from ..runtime.metrics import REGISTRY, Metrics
from ..runtime.watchdog import FIRST_COMPILE_GRACE_S, WATCHDOG
from ..sched.lanes import lane_name

# The search loops a reference worker may ask for (WorkerConfig.SearchLoop)
SEARCH_LOOPS = ("persistent", "serial")
# The difficulty of a warm-up launch: one mask word, and a hit at once
WARMUP_DIFFICULTY = 1


def plan_launch_geometry(target_chunks: int, tbc: int, launch_steps: int,
                         max_launch: int) -> Tuple[int, int]:
    """``(chunks, k)`` for one dispatch of the kernel.

    The kernel's grid-stride loop takes any index count, so the batch is
    not rounded to the block: ``chunks * tbc`` candidates per sub-batch and
    ``k`` sub-batches re-clamped to the dispatch budget.  The wrapper sizes
    the grid.
    """
    chunks = max(1, target_chunks)
    k = max(1, min(launch_steps, max_launch // (chunks * tbc)))
    return chunks, k


def _require_device(device: Device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the CUDA backend needs a GPU and none is available; pass "
            "device='cpu' to run the plain PyTorch step instead"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_options(mesh_devices: Optional[int], interpret: bool, loop: Optional[str]) -> str:
    """Validate the reference worker's backend keywords; return the loop.

    * ``mesh_devices``: 0 (every visible GPU) or a count; more than one is
      served by the mesh backend, ``CudaMeshBackend`` (``get_backend``
      routes it there).
    * ``interpret=True`` raises: CUDA has no interpret mode, and a caller
      that wants the CPU passes ``device="cpu"``.
    * ``loop`` is ``"persistent"`` (the reference's default:
      ``persistent_search``) or ``"serial"`` (``search``)."""
    if mesh_devices is not None and int(mesh_devices) < 0:
        raise ValueError(f"mesh_devices={mesh_devices}: expected 0 (every visible GPU) or a "
                         f"device count")
    if interpret:
        raise ValueError("interpret=True: CUDA has no interpret mode; pass device='cpu' to "
                         "run the plain PyTorch step on the CPU")
    loop = (loop or "persistent").lower()
    if loop not in SEARCH_LOOPS:
        raise ValueError(f"unknown search loop {loop!r}: expected one of {SEARCH_LOOPS}")
    return loop


class DeviceBackend:
    """A step factory behind the pipelined driver, on an explicit device.

    Subclasses give ``_factory(nonce, difficulty, tb_lo, tbc)`` (a
    ``parallel.search.StepFactory``), ``_persistent_factory`` (a
    ``PersistentFactory`` with the same arguments), and may give
    ``_load(nonce_lens, widths)`` (what must be built and loaded before the
    first launch at those layouts) and ``_step_builder`` (the persistent
    loop's lane hook).  ``mesh_devices``, ``interpret`` and ``loop`` are the
    reference worker's keywords (``check_options``)."""

    name = "device"
    # the devices one search spreads over at most (None: a mesh, any count)
    max_mesh_devices: Optional[int] = 1

    def __init__(self, hash_model: str = "md5", batch_size: int = 1 << 20,
                 max_launch: Optional[int] = None, device: Device = "cuda",
                 metrics: Metrics = REGISTRY, mesh_devices: Optional[int] = 0,
                 interpret: bool = False, loop: Optional[str] = "persistent"):
        self.model = get_hash_model(hash_model)
        self.loop = check_options(mesh_devices, interpret, loop)
        self.mesh_devices = int(mesh_devices or 0)
        if self.max_mesh_devices is not None and self.mesh_devices > self.max_mesh_devices:
            raise ValueError(f"{type(self).__name__} searches on one device; mesh_devices="
                             f"{self.mesh_devices} is served by CudaMeshBackend "
                             f"(get_backend('cuda', mesh_devices={self.mesh_devices}))")
        self.device = _require_device(device)
        self.batch_size = batch_size
        self.max_launch = max_launch or scaled_launch_candidates(self.model.cost_ops)
        self.metrics = metrics

    def _factory(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        raise NotImplementedError

    def _persistent_factory(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        raise NotImplementedError

    def _step_builder(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        return None

    def _load(self, nonce_lens: Sequence[int], widths: Sequence[int]) -> None:
        pass

    def _warm_runs(self) -> Tuple[int, ...]:
        """The thread-byte counts ``warmup`` launches at: the full partition."""
        return (256,)

    def warmup(self, nonce_lens: Sequence[int], widths: Sequence[int]) -> None:
        """Build what the first request needs and launch each serving layout
        once, before the first request (the reference's ``_warm_layouts`` /
        ``_warm_factory``): for each nonce length, width and ``_warm_runs``
        count, the step the driver builds for the partition ``[0, tbc)``
        (at the driver's batch and launch multiplier) at difficulty 1, and
        read its result.  Under the persistent loop every width but 0 takes
        the persistent step, launched with a set stop flag, so that it
        stops before its first candidate (the reference's
        ``_persistent_warm_factory``).  The libraries those layouts launch
        are built first, all at once (md5's, one per tail layout, only
        those), then every layout is touched; under the watchdog, one beat
        and one first-compile grace per launch."""
        with WATCHDOG.active():
            with WATCHDOG.grace(FIRST_COMPILE_GRACE_S):
                self._load(nonce_lens, widths)
            for tbc in self._warm_runs():
                target = max(1, effective_batch(self.batch_size) // tbc)
                for n_len in nonce_lens:
                    nonce = bytes(int(n_len))
                    factory = self._factory(nonce, WARMUP_DIFFICULTY, 0, tbc)
                    persistent = (self._persistent_factory(nonce, WARMUP_DIFFICULTY, 0, tbc)
                                  if self.loop == "persistent" else None)
                    for vw in widths:
                        vw = int(vw)
                        WATCHDOG.beat()
                        k = launch_steps_for(vw, target, tbc, self.max_launch)
                        with WATCHDOG.grace(FIRST_COMPILE_GRACE_S):
                            if vw and persistent is not None:
                                step = persistent(vw, b"", target, k)[0]
                                res = step(256 ** (vw - 1), StopFlag(set_=True))
                            else:
                                step, _ = factory(vw, b"", target, k)
                                res = step(256 ** (vw - 1) if vw else 0)
                            if res.device.type == "cuda":
                                torch.cuda.synchronize(res.device)
                            u32_value(res.reshape(-1)[0])

    def search(self, nonce, difficulty, thread_bytes, cancel_check=None) -> Optional[bytes]:
        nonce = bytes(nonce)
        tb_lo, tbc = contiguous_bounds(thread_bytes)
        kwargs = {}
        drive = search
        if self.loop == "persistent":
            drive = persistent_search
            kwargs = {"persistent_factory": self._persistent_factory(nonce, difficulty, tb_lo, tbc),
                      "step_builder": self._step_builder(nonce, difficulty, tb_lo, tbc)}
        res = drive(
            nonce, difficulty, thread_bytes,
            model=self.model,
            batch_size=self.batch_size,
            cancel_check=cancel_check,
            step_factory=self._factory(nonce, difficulty, tb_lo, tbc),
            launch_candidates=self.max_launch,
            device=self.device,
            metrics=self.metrics,
            **kwargs,
        )
        return None if res is None else res.secret


class CudaBackend(DeviceBackend):
    """The solo kernels.  ``lane`` is the persistent loop's lane override
    (``sched/lanes.py persistent_step_builder``): ``auto`` (a mesh on a
    host of several GPUs where ``device`` names no card) or ``mesh`` spread
    a search over the mesh; a scheduler that pins another lane passes it to
    its solo searches, which then stay on the one device."""

    name = "cuda"

    def __init__(self, hash_model: str = "md5", lane: str = "auto", **kwargs):
        kernel_name(get_hash_model(hash_model))  # raises for a model without a kernel
        super().__init__(hash_model, **kwargs)
        self.lane = lane_name(lane)

    def _load(self, nonce_lens: Sequence[int], widths: Sequence[int]) -> None:
        if self.device.type == "cuda":
            tails = [build_tail_spec(bytes(int(n)), int(vw), self.model)
                     for n in nonce_lens for vw in widths]
            load_kernels(self.model, [(t.tb_loc, t.chunk_locs) for t in tails])

    def _factory(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        def factory(vw: int, extra: bytes, target_chunks: int, launch_steps: int = 1):
            spec = build_tail_spec(nonce, vw, self.model, extra)
            ops = step_operands(spec, difficulty, self.model, tb_lo, tbc, self.device,
                               self.metrics)
            if vw == 0:
                # width 0: the tbc candidates of one chunk value
                chunks, k, batch = 1, 1, tbc
            else:
                chunks, k = plan_launch_geometry(target_chunks, tbc, launch_steps,
                                                 self.max_launch)
                batch = chunks * tbc

            def step(chunk0: int) -> torch.Tensor:
                return hash_search(self.model, ops, spec.tb_loc, spec.chunk_locs, chunk0,
                                   batch, k, device=self.device)

            return step, chunks * k

        return factory

    def _persistent_factory(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        def factory(vw: int, extra: bytes, target_chunks: int, segments: int):
            spec = build_tail_spec(nonce, vw, self.model, extra)
            ops = step_operands(spec, difficulty, self.model, tb_lo, tbc, self.device,
                               self.metrics)
            chunks, k = plan_launch_geometry(target_chunks, tbc, segments, self.max_launch)

            def step(chunk0: int, stop: StopFlag) -> torch.Tensor:
                return hash_persistent_search(self.model, ops, spec.tb_loc, spec.chunk_locs,
                                              chunk0, chunks * tbc, k, stop.operand(ops.device),
                                              device=self.device)

            return step, chunks, chunks * k

        return factory

    def _step_builder(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        """The mesh's persistent step on a host of several GPUs where the
        backend's device names no card and its lane allows it
        (``sched/lanes.py`` ``persistent_step_builder``), else None."""
        from ..sched.lanes import persistent_step_builder

        return persistent_step_builder(nonce, difficulty, tb_lo, tbc, self.model,
                                       override=self.lane, device=self.device,
                                       max_launch=self.max_launch)


class CudaMeshBackend(CudaBackend):
    """The mesh kernels over a mesh of devices (prefix -> device): the
    counterpart of the reference's ``PallasMeshBackend``.

    ``devices`` names the mesh's devices in order (``["cuda:0"] * 4`` is
    four logical shards on one card); a ``device`` that names a card must
    be the first of them.  Otherwise ``mesh_devices`` counts them: on a
    card, the mesh starts at ``device`` (a bare ``cuda``: the current GPU)
    and goes on with the other visible GPUs in order, 0 taking every one
    and N the first N (fewer visible raises); with ``device="cpu"``, N
    logical shards of the CPU (0: one), on which the kernels' wrapper runs
    the plain version.  The kernel takes every shard count, run and tail,
    so nothing falls back.  Inside a ``torch.distributed`` group these are
    this rank's devices (its visible GPUs: on one host, ranks divide the
    cards through ``CUDA_VISIBLE_DEVICES``), and the mesh spans every
    rank's (``make_mesh``)."""

    name = "cuda-mesh"
    max_mesh_devices = None

    def __init__(self, hash_model: str = "md5", devices: Optional[Sequence[Device]] = None,
                 **kwargs):
        super().__init__(hash_model, **kwargs)
        self.mesh = make_mesh(_mesh_device_list(self.device, self.mesh_devices, devices))
        self.device = self.mesh.devices[0]

    def _factory(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        return _cuda_mesh_step_factory(nonce, difficulty, tb_lo, tbc, self.model, self.mesh,
                                       max_launch=self.max_launch)

    def _persistent_factory(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        return mesh_persistent_factory(nonce, difficulty, tb_lo, tbc, self.model, self.mesh,
                                       max_launch=self.max_launch)

    def _step_builder(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        return None  # already the mesh

    def _warm_runs(self) -> Tuple[int, ...]:
        """The full partition, and ``n_dev // 2`` thread bytes, which a mesh
        of more than one shard splits by chunks (the reference's second
        warm-up partition)."""
        n_dev = self.mesh.size
        return (256, n_dev // 2) if n_dev > 1 else (256,)


def _mesh_device_list(device: torch.device, mesh_devices: int,
                      devices: Optional[Sequence[Device]] = None) -> list:
    """The devices of the backend's mesh: ``devices`` as given, whose first
    is of ``device``'s type and is ``device`` where that names one; else
    ``mesh_devices`` of them from ``device`` on (0: every visible GPU; on
    the CPU, one shard)."""
    if devices is not None:
        first = torch.device(devices[0]) if len(devices) else device
        if first.type != device.type or (device.index is not None and first != device):
            raise ValueError(f"the mesh starts at {first}, but device={device}: name the "
                             f"backend's device first")
        return list(devices)
    if device.type == "cpu":
        return [device] * max(1, mesh_devices)
    return gpu_devices(device, mesh_devices)
