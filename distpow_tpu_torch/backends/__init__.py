"""Worker compute backends of the port.

* ``python`` — the hashlib loop, the behavioural-parity baseline
* ``torch``  — the plain PyTorch step behind the pipelined driver, on an
               explicit device (tests and the CPU)
* ``cuda``   — the hand-written CUDA kernel of the hash model behind the
               same driver (all nine models)
* ``auto``   — ``cuda``

Every backend implements ``search(nonce, difficulty, thread_bytes,
cancel_check) -> Optional[bytes]``: the first solving secret in reference
enumeration order, or None when cancelled.  ``torch``, ``cuda`` and
``auto`` default to ``device="cuda"`` and raise without a GPU; a caller
that wants the CPU passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

from ..models import puzzle
from ..models.registry import get_hash_model
from ..ops.operands import Device
from ..parallel.search import scaled_launch_candidates, search
from ..runtime.metrics import REGISTRY, Metrics
from .cuda_backend import CudaBackend, _require_device


class PythonBackend:
    """Reference-parity CPU loop (worker.go:318-400)."""

    name = "python"

    def __init__(self, hash_model: str = "md5", metrics: Metrics = REGISTRY, **_):
        self.hash_model = get_hash_model(hash_model).name
        self.metrics = metrics

    def search(self, nonce, difficulty, thread_bytes, cancel_check=None):
        def count_exit(reason: str) -> None:
            if reason != "exhausted":
                self.metrics.inc(f"search.{reason}")

        return puzzle.python_search(
            nonce, difficulty, thread_bytes,
            algo=self.hash_model,
            cancel_check=cancel_check,
            cancel_poll_interval=1024,
            on_progress=lambda n: self.metrics.inc("search.hashes", n),
            on_exit=count_exit,
        )


class TorchBackend:
    """The plain PyTorch step behind the pipelined driver."""

    name = "torch"

    def __init__(self, hash_model: str = "md5", batch_size: int = 1 << 20,
                 max_launch: Optional[int] = None, device: Device = "cuda",
                 metrics: Metrics = REGISTRY):
        self.model = get_hash_model(hash_model)
        self.device = _require_device(device)
        self.batch_size = batch_size
        self.max_launch = max_launch or scaled_launch_candidates(self.model.cost_ops)
        self.metrics = metrics

    def search(self, nonce, difficulty, thread_bytes, cancel_check=None):
        res = search(
            nonce, difficulty, thread_bytes,
            model=self.model,
            batch_size=self.batch_size,
            cancel_check=cancel_check,
            launch_candidates=self.max_launch,
            device=self.device,
            metrics=self.metrics,
        )
        return None if res is None else res.secret


def get_backend(name: str = "auto", **kwargs):
    name = (name or "auto").lower()
    if name in ("auto", "cuda"):
        return CudaBackend(**kwargs)
    if name == "python":
        return PythonBackend(**kwargs)
    if name == "torch":
        return TorchBackend(**kwargs)
    raise ValueError(f"unknown worker backend {name!r}: python, torch, cuda or auto")
