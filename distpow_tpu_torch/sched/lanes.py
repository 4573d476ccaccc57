"""Launch lanes of the scheduler: which device form serves a launch group.

The engine (``sched/engine.py``) packs its slot table into (model, tail
layout) groups.  Each group resolves per (group, batch) to a lane:

* ``cuda`` — the model's group kernel (``ops/hash_cuda.py``
  ``hash_group_search``, the counterpart of the reference's
  ``build_pallas_group_step``): one launch for all the group's slots, on
  the scheduler's stream.  On a CUDA device this lane takes every group,
  width-0 and two-block tails included.
* ``mesh`` — the group kernel on every shard of a mesh
  (``parallel/mesh_search.py`` ``mesh_group_search``, the counterpart of
  the reference's ``mesh_slot_search_step``): a launch covers ``n_shards x
  mesh_span() x batch`` candidates per slot.  Served only when asked for
  (``lane="mesh"``), and not for width 0.
* ``torch`` — the plain step (``ops/search_step.py``
  ``mixed_slot_search_step``, one for all of a launch's torch groups): the
  lane on the CPU, and on a card only when asked for (``lane="torch"``).

``auto`` takes ``cuda`` on a card and ``torch`` on the CPU; it never picks
``mesh``, also with more than one GPU (the reference ranks ``mesh`` after
``pallas``, which takes every group, so its ``auto`` never reaches it
either).  The reference's lane names map: ``pallas`` is ``cuda``, ``xla``
is ``torch``.  Where the
reference demotes a lane whose build or launch fails and serves the group
on ``xla``, here the error raises: the engine's loop-death path finishes
the slots with it (``sched.loop_failures``), so no failure hides the kernel
behind the plain step.  The engine counts ``sched.lane_launches.<lane>``
per group served.

``persistent_step_builder`` is the lane plan of one solo search in the
persistent loop (the reference's, ``distpow_tpu/sched/lanes.py:354``): the
mesh's persistent step where the lane caps see more than one GPU and the
caller names no card, else the single-device step.  As everywhere in the
port, a failure raises instead of demoting the request.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..models.registry import get_hash_model
from ..ops.hash_cuda import hash_group_search, kernel_layout, kernel_name
from ..ops.operands import Device, GroupOperands
from ..ops.search_step import _check_launch
from ..models.registry import HashModel
from ..parallel.mesh_search import (Mesh, explicit_device, gpu_devices, make_mesh,
                                    mesh_group_search, mesh_persistent_factory)

# the names a caller may give (WorkerConfig.SchedLane), the reference's included
LANE_NAMES = {"auto": "auto", "cuda": "cuda", "pallas": "cuda", "mesh": "mesh",
              "torch": "torch", "xla": "torch"}

# The mesh lane's per-shard span: each shard sweeps span x batch candidates
# per slot a launch, so the host's dispatch is paid once for more of the
# search segment (the reference's MESH_SPAN).
MESH_SPAN = 4


def mesh_span() -> int:
    """The mesh lane's span multiplier (``DISTPOW_MESH_SPAN`` to tune,
    floor 1)."""
    try:
        return max(1, int(os.environ.get("DISTPOW_MESH_SPAN", MESH_SPAN)))
    except ValueError:
        return MESH_SPAN


def lane_name(name: Optional[str]) -> str:
    """The port's lane for a caller's name (``auto``, a lane, or a reference
    name); unknown names raise."""
    name = (name or "auto").lower()
    try:
        return LANE_NAMES[name]
    except KeyError:
        raise ValueError(f"unknown scheduler lane {name!r}: expected one of "
                         f"{sorted(LANE_NAMES)}") from None


@dataclass(frozen=True)
class LaneCaps:
    """What the ranking keys on; injectable, so the rank matrix is testable
    without a card."""

    device_type: str  # the scheduler device's type: "cuda" or "cpu"
    n_devices: int = 1  # the shards of the mesh lane's mesh (its 2^31 bound)


def detect_caps(device: Device, mesh: Optional[Mesh] = None) -> LaneCaps:
    dev = torch.device(device)
    if mesh is not None:
        return LaneCaps(dev.type, mesh.size)
    return LaneCaps(dev.type, torch.cuda.device_count() if dev.type == "cuda" else 1)


def check_group(gdef: tuple, batch: int) -> None:
    """Raise ValueError for a launch group ``(model, n_blocks, tb_loc,
    chunk_locs, n_pad)`` the group kernel cannot serve at ``batch``
    candidates a slot: a model without a kernel, a layout that is not one
    contiguous run, a batch of 2^31 or more or not a multiple of 256, which
    every power-of-two run divides.  Only the real slots are launched:
    ``n_pad`` is part of the planner's key, not of the launch."""
    model_name, n_blocks, tb_loc, chunk_locs, _n_pad = gdef
    model = get_hash_model(model_name)
    kernel_name(model)
    if n_blocks not in (1, 2):
        raise ValueError(f"the group kernel takes 1 or 2 tail blocks, not {n_blocks}")
    kernel_layout(tb_loc, chunk_locs, model)
    _check_launch(batch, 1)
    if batch % 256:
        raise ValueError(f"batch {batch} is not a multiple of 256")


class LanePlanner:
    """Per-(group, batch) lane resolution.  ``override`` pins the lane
    (``auto`` takes the device's: ``cuda`` on a card, ``torch`` on the
    CPU).  ``mesh`` is the mesh lane's (default: every
    visible GPU from the scheduler's device on; on the CPU one shard); its
    first device is the scheduler's.  ``caps`` default to the device's and
    the mesh's own."""

    def __init__(self, caps: Optional[LaneCaps] = None, override: str = "auto",
                 device: Device = "cuda", mesh: Optional[Mesh] = None) -> None:
        self.override = lane_name(override)
        self.device = torch.device(device)
        if mesh is not None and mesh.devices[0] != explicit_device(self.device):
            raise ValueError(f"the mesh lane's first device is {mesh.devices[0]}, the "
                             f"scheduler's {self.device}")
        self._mesh = mesh
        self.caps = caps or detect_caps(self.device, mesh)

    @property
    def default_lane(self) -> str:
        """The lane of a group no other lane takes, and of solo searches."""
        if self.override in ("cuda", "torch"):
            return self.override
        return "cuda" if self.caps.device_type == "cuda" else "torch"

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            first = explicit_device(self.device)
            self._mesh = make_mesh(gpu_devices(first) if first.type == "cuda" else [first])
        return self._mesh

    def _eligible(self, lane: str, gdef: tuple, batch: int) -> bool:
        if lane != "mesh":
            return True
        # width 0 (no chunk bytes) is at most one run of thread bytes, far
        # below one batch: nothing to spread
        return bool(gdef[3]) and batch * mesh_span() * self.caps.n_devices < 1 << 31

    def rank(self, gdef: tuple, batch: int) -> Tuple[str, ...]:
        """The eligible lanes for a group, first first; the first serves it."""
        if self.override == "mesh":
            ranked = ("mesh", self.default_lane)
        else:
            ranked = (self.default_lane,)
        return tuple(lane for lane in ranked if self._eligible(lane, gdef, batch))

    def resolve(self, gdef: tuple, batch: int) -> Tuple[str, int]:
        """``(lane, coverage)`` for a launch group: the first ranked lane,
        after the group kernel's checks where a kernel serves it (a group it
        cannot serve raises), and the candidates a slot covers per launch."""
        lane = self.rank(gdef, batch)[0]
        if lane == "torch":
            return lane, batch
        if lane == "mesh":
            local = batch * mesh_span()
            check_group(gdef, local)
            return lane, local * self.mesh.size
        check_group(gdef, batch)
        return lane, batch

    def launch(self, lane: str, gdef: tuple, ops: GroupOperands, batch: int) -> torch.Tensor:
        """One launch of a group on the ``cuda`` or ``mesh`` lane: the
        result cells of its slots on the scheduler's device, without a
        host wait."""
        model = get_hash_model(gdef[0])
        tb_loc, chunk_locs = gdef[2], gdef[3]
        if lane == "mesh":
            return mesh_group_search(self.mesh, model, ops, tb_loc, chunk_locs,
                                     batch * mesh_span())
        return hash_group_search(model, ops, tb_loc, chunk_locs, batch, device=self.device)


def persistent_step_builder(nonce: bytes, difficulty: int, tb_lo: int, tbc: int,
                            model: HashModel, caps: Optional[LaneCaps] = None,
                            override: str = "auto", device: Device = "cuda",
                            mesh: Optional[Mesh] = None, max_launch: Optional[int] = None):
    """The ``step_builder`` hook of ``parallel.search.persistent_search`` for
    one solo search: ``None`` where the single-device persistent step is the
    plan (one GPU, a card named by ``device``, or an ``override`` other than
    ``auto`` and ``mesh``), else the mesh's persistent factory
    (``mesh_persistent_factory``) over ``mesh`` (default: every GPU the caps
    count, from ``device`` on).  Nothing is probed and nothing demotes: a
    bind or launch failure raises in the search."""
    dev = torch.device(device)
    caps = caps or detect_caps(dev, mesh)
    if lane_name(override) not in ("auto", "mesh") or caps.n_devices <= 1 \
            or dev.index is not None:
        return None
    if mesh is None:
        mesh = make_mesh(gpu_devices(dev, caps.n_devices))
    return mesh_persistent_factory(bytes(nonce), difficulty, tb_lo, tbc, model, mesh,
                                   max_launch)
