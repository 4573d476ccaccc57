"""The search step's runtime operands, shared by the kernel and the plain step.

``StepOperands`` binds one (nonce, difficulty, partition) onto a search
step: the absorbed prefix state, the tail's constant words and the
trailing difficulty masks, all as ``int32`` tensors holding the words'
``uint32`` bit patterns (the CUDA kernel reads them as ``uint32``; the
plain step widens them to masked ``int64``), plus the thread-byte run
``(tb_lo, tb_count)``.  The tail layout (``tb_loc``, ``chunk_locs``) is
not an operand: it is the static shape of the step, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import numpy as np
import torch

Device = Union[str, torch.device]

MASK32 = 0xFFFFFFFF


def u32_tensor(values, device: Device = "cpu") -> torch.Tensor:
    """``int32`` tensor holding the uint32 bit patterns of ``values``."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def widen(t: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns (``int32``) -> ``int64`` values in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def u32_value(t: torch.Tensor) -> int:
    """A 0-d result tensor (``int32`` bit pattern or ``int64``) as a uint32 int."""
    return int(t) & MASK32


def u32_bits(t: torch.Tensor) -> torch.Tensor:
    """Results as ``int32`` bit patterns: a kernel's cells as they are, the
    plain version's ``int64`` values in [0, 2^32) cut to their low 32 bits
    (SENTINEL becomes -1, as in a kernel's cell)."""
    return t if t.dtype == torch.int32 else (t & MASK32).to(torch.int32)


def u32_min(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The least uint32 along ``dim`` of ``int32`` bit patterns, as bit
    patterns.  A signed min would rank SENTINEL (-1) below every hit, so the
    sign bit is flipped first, which maps uint32 order onto int32 order."""
    flip = torch.iinfo(torch.int32).min
    return torch.bitwise_xor(torch.bitwise_xor(t, flip).amin(dim), flip)


@dataclass(frozen=True)
class StepOperands:
    init: torch.Tensor   # int32 [S], the model's state words
    base: torch.Tensor   # int32 [n_blocks, model.row_words]
    masks: torch.Tensor  # int32 [mask_words], the LAST digest words' masks
    tb_lo: int
    tb_count: int

    @property
    def device(self) -> torch.device:
        return self.init.device

    @property
    def n_blocks(self) -> int:
        return int(self.base.shape[0])

    @property
    def mask_words(self) -> int:
        return int(self.masks.shape[0])


def make_operands(init: Sequence[int], base, masks: Sequence[int], tb_lo: int,
                  tb_count: int, device: Device = "cpu") -> StepOperands:
    """Operands from host words (ints or numpy arrays of uint32 values).
    ``base`` is the tail's rows, ``[n_blocks][row words]``: the row width
    is the model's (16, 32, 34 or 36 words), and the kernel wrapper holds
    it to the model."""
    base = u32_tensor(base, device)
    if base.dim() != 2:
        raise ValueError(f"base must be [n_blocks, row words], got {tuple(base.shape)}")
    return StepOperands(
        init=u32_tensor(init, device),
        base=base,
        masks=u32_tensor(masks, device).reshape(-1),
        tb_lo=int(tb_lo),
        tb_count=int(tb_count),
    )


def operands_from_numpy(init, base, masks, tb_lo: int, tb_count: int,
                        device: Device = "cpu") -> StepOperands:
    """The reference package's ``step_operands(...)`` output, as numpy
    arrays (``init[S]``, ``base[n_blocks, W]``, ``masks[mask_words]``, with
    S, W and mask_words the model's state, row and up to its digest words),
    turned into the port's operands, so a test feeds both packages from one
    source."""
    return make_operands(np.asarray(init, dtype=np.uint32), np.asarray(base, dtype=np.uint32),
                         np.asarray(masks, dtype=np.uint32), tb_lo, tb_count,
                         device)


@dataclass(frozen=True)
class GroupOperands:
    """The operands of a group of scheduler slots that share one tail layout,
    one row per slot, all ``int32`` tensors of ``uint32`` bit patterns on one
    device: the counterpart of the reference scheduler's six slot rows
    (``sched/engine.py`` ``_lane_ops``).  Each slot's run is a power of two,
    ``tb_lo .. tb_lo + 2^log_tbc - 1``, and ``chunk0`` its cursor."""

    init: torch.Tensor     # [n_slots, S]
    base: torch.Tensor     # [n_slots, n_blocks, W]
    masks: torch.Tensor    # [n_slots, digest words]
    tb_lo: torch.Tensor    # [n_slots]
    log_tbc: torch.Tensor  # [n_slots]
    chunk0: torch.Tensor   # [n_slots]

    @property
    def device(self) -> torch.device:
        return self.init.device

    @property
    def n_slots(self) -> int:
        return int(self.init.shape[0])

    @property
    def n_blocks(self) -> int:
        return int(self.base.shape[1])


def group_operands(init, base, masks, tb_lo, log_tbc, chunk0,
                   device: Device = "cpu") -> GroupOperands:
    """Group operands from host rows (ints or numpy arrays of uint32 values:
    ``init[n][S]``, ``base[n][n_blocks][W]``, ``masks[n][D]`` and the three
    per-slot scalars), packed into one buffer so that one copy moves the
    whole group to ``device``.  For a CUDA device the rows are staged in
    pinned host memory and copied ``non_blocking`` on the current stream,
    so the host does not wait for the copy (the caller's one wait for its
    results comes later on the same stream)."""
    rows = [np.asarray(x, dtype=np.uint32) for x in (init, base, masks, tb_lo, log_tbc, chunk0)]
    n = rows[0].shape[0]
    if rows[1].ndim != 3 or any(r.shape[0] != n for r in rows) or \
            any(r.ndim != 1 for r in rows[3:]):
        raise ValueError(f"bad group rows: shapes {[r.shape for r in rows]}")
    flat = np.concatenate([r.reshape(-1) for r in rows]).view(np.int32)
    if torch.device(device).type == "cuda":
        staged = torch.empty(flat.size, dtype=torch.int32, pin_memory=True)
        staged.numpy()[:] = flat
        buf = staged.to(device, non_blocking=True)
    else:
        buf = torch.from_numpy(flat).to(device)
    parts: Tuple[torch.Tensor, ...] = torch.split(buf, [r.size for r in rows])
    return GroupOperands(*(p.view(r.shape) for p, r in zip(parts, rows)))
