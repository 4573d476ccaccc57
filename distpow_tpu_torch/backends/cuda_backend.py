"""Worker backend driving the hand-written CUDA search kernels.

Plugs ``ops.hash_cuda.hash_search`` into ``parallel.search.search`` through
the step-factory protocol, with the kernel of the backend's hash model
(each of the nine models has one; an unknown model raises).  Each
kernel takes every configuration the plain step takes (1- and 2-block
tails, power-of-two or not thread-byte runs, widths 0-4, every difficulty),
so there is no fallback path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.registry import get_hash_model
from ..ops.hash_cuda import hash_search, kernel_name
from ..ops.operands import Device
from ..ops.packing import build_tail_spec
from ..ops.search_step import step_operands
from ..parallel.partition import contiguous_bounds
from ..parallel.search import scaled_launch_candidates, search
from ..runtime.metrics import REGISTRY, Metrics


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


class CudaBackend:
    name = "cuda"

    def __init__(self, hash_model: str = "md5", batch_size: int = 1 << 20,
                 max_launch: Optional[int] = None, device: Device = "cuda",
                 metrics: Metrics = REGISTRY):
        self.model = get_hash_model(hash_model)
        kernel_name(self.model)  # raises for a model without a kernel
        self.device = _require_device(device)
        self.batch_size = batch_size
        self.max_launch = max_launch or scaled_launch_candidates(self.model.cost_ops)
        self.metrics = metrics

    def _factory(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        def factory(vw: int, extra: bytes, target_chunks: int, launch_steps: int = 1):
            spec = build_tail_spec(nonce, vw, self.model, extra)
            ops = step_operands(spec, difficulty, self.model, tb_lo, tbc, self.device)
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

    def search(self, nonce, difficulty, thread_bytes, cancel_check=None) -> Optional[bytes]:
        nonce = bytes(nonce)
        tb_lo, tbc = contiguous_bounds(thread_bytes)
        res = search(
            nonce, difficulty, thread_bytes,
            model=self.model,
            batch_size=self.batch_size,
            cancel_check=cancel_check,
            step_factory=self._factory(nonce, difficulty, tb_lo, tbc),
            launch_candidates=self.max_launch,
            metrics=self.metrics,
        )
        return None if res is None else res.secret
