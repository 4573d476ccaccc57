"""Launch lanes of the scheduler: which device form serves a launch group.

The engine (``sched/engine.py``) packs its slot table into (model, tail
layout) groups.  Each group resolves once per (group, batch) to a lane:

* ``cuda`` — the model's group kernel (``ops/hash_cuda.py``
  ``hash_group_search``, the counterpart of the reference's
  ``build_pallas_group_step``): one launch for all the group's slots, on
  the scheduler's stream.  On a CUDA device this lane takes every group,
  width-0 and two-block tails included.
* ``torch`` — the plain step (``ops/search_step.py``
  ``mixed_slot_search_step``, one for all of a launch's torch groups): the
  lane on the CPU, and on a card only when asked for (``lane="torch"``).
* ``mesh`` — raises until the mesh is ported (ROADMAP Queue 1 item 4).

The reference's lane names map: ``pallas`` is ``cuda``, ``xla`` is
``torch``.  Where the reference demotes a lane whose build or launch fails
and serves the group on ``xla``, here the error raises: the engine's
loop-death path finishes the slots with it (``sched.loop_failures``), so no
failure hides the kernel behind the plain step.  The engine counts
``sched.lane_launches.<lane>`` per group served.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..models.registry import get_hash_model
from ..ops.hash_cuda import hash_group_search, kernel_layout, kernel_name
from ..ops.operands import Device, GroupOperands
from ..ops.search_step import _check_launch

# the names a caller may give (WorkerConfig.SchedLane), the reference's included
LANE_NAMES = {"auto": "auto", "cuda": "cuda", "pallas": "cuda", "torch": "torch",
              "xla": "torch"}


def lane_name(name: Optional[str]) -> str:
    """The port's lane for a caller's name (``auto``, a lane, or a reference
    name); ``mesh`` and unknown names raise."""
    name = (name or "auto").lower()
    if name == "mesh":
        raise ValueError("scheduler lane 'mesh' is not ported yet: it waits for the mesh "
                         "(ROADMAP Queue 1 item 4)")
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
    n_devices: int = 1


def detect_caps(device: Device) -> LaneCaps:
    dev = torch.device(device)
    return LaneCaps(dev.type, torch.cuda.device_count() if dev.type == "cuda" else 1)


class _CudaGroupStep:
    """The cuda lane of one launch group: ``step(ops)`` launches the group
    kernel over the slots of ``ops`` and returns their result cells.
    ``coverage`` is the candidates per slot per launch."""

    lane = "cuda"

    def __init__(self, model, tb_loc, chunk_locs, batch: int, device: Device) -> None:
        self.model = model
        self.tb_loc = tb_loc
        self.chunk_locs = chunk_locs
        self.coverage = batch
        self.device = device

    def __call__(self, ops: GroupOperands) -> torch.Tensor:
        return hash_group_search(self.model, ops, self.tb_loc, self.chunk_locs, self.coverage,
                                 device=self.device)


def build_cuda_group_step(gdef: tuple, batch: int, device: Device) -> _CudaGroupStep:
    """The cuda lane for one launch group ``(model, n_blocks, tb_loc,
    chunk_locs, n_pad)``; raises ValueError for a group the kernel cannot
    serve (a model without a kernel, a layout that is not one contiguous
    run, a batch of 2^31 or more or not a multiple of 256, which every
    power-of-two run divides).  Only the real slots are launched: ``n_pad``
    is part of the planner's key, not of the launch."""
    model_name, n_blocks, tb_loc, chunk_locs, _n_pad = gdef
    model = get_hash_model(model_name)
    kernel_name(model)
    if n_blocks not in (1, 2):
        raise ValueError(f"the group kernel takes 1 or 2 tail blocks, not {n_blocks}")
    kernel_layout(tb_loc, chunk_locs, model)
    _check_launch(batch, 1)
    if batch % 256:
        raise ValueError(f"batch {batch} is not a multiple of 256")
    return _CudaGroupStep(model, tb_loc, chunk_locs, batch, device)


class LanePlanner:
    """Per-(group, batch) lane resolution.  ``override`` pins the lane
    (``auto`` ranks by the device: ``cuda`` on a card, ``torch`` on the
    CPU); a step is built once per key and kept.  ``caps`` default to the
    device's own."""

    def __init__(self, caps: Optional[LaneCaps] = None, override: str = "auto",
                 device: Device = "cuda") -> None:
        self.override = lane_name(override)
        self.device = torch.device(device)
        self.caps = caps or detect_caps(self.device)
        self._steps: Dict[tuple, _CudaGroupStep] = {}

    def rank(self, gdef: tuple, batch: int) -> Tuple[str, ...]:
        """The lanes for a group, first first: one lane, since nothing demotes."""
        if self.override != "auto":
            return (self.override,)
        return ("cuda",) if self.caps.device_type == "cuda" else ("torch",)

    def resolve(self, gdef: tuple, batch: int):
        """``(lane, step)`` for a launch group: ``step`` is None for the
        ``torch`` lane (the engine runs the plain steps, one for all of a
        launch's torch groups), else a ``_CudaGroupStep``.  A build failure
        raises."""
        lane = self.rank(gdef, batch)[0]
        if lane == "torch":
            return "torch", None
        key = (gdef, batch)
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = build_cuda_group_step(gdef, batch, self.device)
        return lane, step
