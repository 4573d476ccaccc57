"""Wrapper of the hand-written MD5 search kernel (``csrc/md5_search.cu``).

Counterpart of the reference's Pallas launch site
(``distpow_tpu/ops/md5_pallas.py`` ``build_pallas_search_step`` /
``cached_pallas_search_step``).  ``md5_search`` checks the operands,
allocates the result cell, launches the kernel on the current stream and
counts the launch.  For CUDA tensors it launches or raises; only for
tensors on the CPU does it run the plain version (``plain_search``, the
same function in PyTorch).  No ``try`` falls back from one to the other.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from .operands import Device, StepOperands
from .search_step import _check_launch, plain_search

# Blocks per SM of a launch's grid: a few waves of 256-thread blocks, so
# blocks that finish early (a thread stops at its first hit) leave no SM idle.
BLOCKS_PER_SM = 16
BLOCK_THREADS = 256  # csrc/md5_search.cu BLOCK_THREADS


class LaunchCounter:
    """Kernel launches, counted where the wrapper launches and nowhere else."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


LAUNCHES = LaunchCounter()


def kernel_layout(tb_loc, chunk_locs) -> Tuple[int, int, int]:
    """The kernel's layout arguments ``(var_word, var_shift, chunk_mask)``.

    The kernel takes the candidate's variable bytes as one contiguous run
    (thread byte, then chunk bytes 0..width-1), which is what packing
    builds for MD5; any other layout raises."""
    b, w, s = tb_loc
    if s % 8 or not 0 <= w < 16 or b not in (0, 1):
        raise ValueError(f"bad thread-byte location {tb_loc}")
    pos = b * 64 + w * 4 + s // 8
    for j, (cb, cw, cs) in enumerate(chunk_locs):
        if cb * 64 + cw * 4 + cs // 8 != pos + 1 + j or cs % 8:
            raise ValueError(
                f"chunk byte {j} at {(cb, cw, cs)} does not follow the thread "
                f"byte at {tb_loc}: the kernel takes one contiguous run"
            )
    width = len(chunk_locs)
    if width > 4:
        raise ValueError("at most 4 variable chunk bytes")
    return b * 16 + w, s, (1 << (8 * width)) - 1


def default_grid(n: int, sm_count: int) -> int:
    """Blocks for a launch over ``n`` indices: a few waves per SM, and no
    more blocks than there are indices for."""
    return max(1, min(-(-n // BLOCK_THREADS), sm_count * BLOCKS_PER_SM))


def _check_operands(ops: StepOperands, device: torch.device) -> None:
    tensors = {"init": ops.init, "base": ops.base, "masks": ops.masks}
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}, the call asks for {device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must hold uint32 bit patterns as int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError("operands lie on different devices")
    if tuple(ops.init.shape) != (4,):
        raise ValueError(f"init must be [4], got {tuple(ops.init.shape)}")
    if ops.base.dim() != 2 or ops.base.shape[1] != 16 or ops.n_blocks not in (1, 2):
        raise ValueError(f"base must be [1 or 2, 16], got {tuple(ops.base.shape)}")
    if ops.masks.dim() != 1 or not 1 <= ops.mask_words <= 4:
        raise ValueError(f"masks must be [1..4], got {tuple(ops.masks.shape)}")
    if ops.tb_count < 1 or ops.tb_lo < 0 or ops.tb_lo + ops.tb_count > 256:
        raise ValueError(f"bad thread-byte run ({ops.tb_lo}, {ops.tb_count})")


def md5_search(ops: StepOperands, tb_loc, chunk_locs, chunk0: int, batch: int,
               launch_steps: int = 1, *, device: Device,
               grid: Optional[int] = None) -> torch.Tensor:
    """First hitting flat index in ``[0, batch * launch_steps)``, or SENTINEL.

    On a CUDA device: launches the kernel and returns its result cell, a
    0-d ``int32`` tensor holding the uint32 bit pattern (SENTINEL is -1
    there), without synchronising.  On the CPU: the plain version, a 0-d
    ``int64``.  ``grid`` overrides the number of blocks.
    """
    device = torch.device(device)
    _check_operands(ops, device)
    _check_launch(batch, launch_steps)
    if not 0 <= chunk0 <= 0xFFFFFFFF:
        raise ValueError(f"chunk0 {chunk0} is not a uint32")
    if device.type == "cpu":
        return plain_search(ops, tb_loc, chunk_locs, chunk0, batch, launch_steps)
    if device.type != "cuda":
        raise ValueError(f"md5_search runs on cuda or cpu, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("md5_search on a CUDA device, but CUDA is not available")
    var_word, var_shift, chunk_mask = kernel_layout(tb_loc, chunk_locs)
    if var_word >= 16 * ops.n_blocks:
        raise ValueError(f"thread byte at {tb_loc} is outside the {ops.n_blocks}-block tail")
    from ._build import load_library

    lib = load_library("md5_search")
    n = batch * launch_steps
    tbc = ops.tb_count
    log_tbc = tbc.bit_length() - 1 if tbc & (tbc - 1) == 0 else -1
    dev = ops.device
    with torch.cuda.device(dev):
        if grid is None:
            grid = default_grid(n, torch.cuda.get_device_properties(dev).multi_processor_count)
        out = torch.full((), -1, dtype=torch.int32, device=dev)  # SENTINEL's bits
        rc = lib.distpow_md5_search(
            ops.init.data_ptr(), ops.base.data_ptr(), ops.masks.data_ptr(),
            ops.n_blocks, ops.mask_words,
            chunk0, ops.tb_lo, tbc, log_tbc,
            var_word, var_shift, chunk_mask,
            n, out.data_ptr(), grid, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"md5_search kernel launch failed: CUDA error {rc}")
    LAUNCHES.add()
    return out
