"""Worker compute backends of the port.

* ``python`` — the hashlib loop, the behavioural-parity baseline
* ``torch``  — the plain PyTorch step behind the pipelined driver, on an
               explicit device (tests and the CPU)
* ``cuda``   — the hand-written CUDA kernel of the hash model behind the
               same driver (all nine models)
* ``cuda-mesh`` — the kernels' mesh form over a mesh of devices
               (``CudaMeshBackend``, ``parallel/mesh_search.py``)
* ``auto``   — ``cuda-mesh`` where more than one GPU is visible (as the
               reference's ``auto`` picks ``pallas-mesh``) and ``device``
               names no card, else ``cuda``

``get_backend`` also takes the reference's ``Backend`` names: ``pallas``
and ``jax`` are ``cuda`` (on the card the CUDA kernel is the device step;
``torch`` would put the plain version on the main path), ``pallas-mesh``,
``jax-mesh`` and ``mesh`` are ``cuda-mesh``, and ``native`` raises until it
is ported (ROADMAP Queue 1 item 5).  A ``cuda`` name with ``mesh_devices``
above 1 is ``cuda-mesh``.  The device backends take the keywords the
reference worker passes (``mesh_devices``, ``interpret``, ``loop``;
``cuda_backend.check_options``) and a boot ``warmup``.

Every backend implements ``search(nonce, difficulty, thread_bytes,
cancel_check) -> Optional[bytes]``: the first solving secret in reference
enumeration order, or None when cancelled.  ``torch``, ``cuda`` and
``auto`` default to ``device="cuda"`` and raise without a GPU; a caller
that wants the CPU passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from ..models import puzzle
from ..models.registry import get_hash_model
from ..parallel.search import default_persistent_factory, default_step_factory
from ..runtime.metrics import REGISTRY, Metrics
from .cuda_backend import CudaBackend, CudaMeshBackend, DeviceBackend


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


class TorchBackend(DeviceBackend):
    """The plain PyTorch step behind the pipelined driver."""

    name = "torch"

    def _factory(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        return default_step_factory(nonce, difficulty, tb_lo, tbc, self.model, self.device)

    def _persistent_factory(self, nonce: bytes, difficulty: int, tb_lo: int, tbc: int):
        return default_persistent_factory(nonce, difficulty, tb_lo, tbc, self.model,
                                          self.device)


CUDA_NAMES = ("auto", "cuda", "pallas", "jax")
MESH_NAMES = ("cuda-mesh", "pallas-mesh", "jax-mesh", "mesh")
# The reference's Backend names that the port does not serve yet
_NOT_PORTED = {
    "native": "the native miner (ROADMAP Queue 1 item 5)",
}


def _wants_mesh(name: str, kwargs: dict) -> bool:
    """A ``cuda`` name served by the mesh: ``mesh_devices`` above 1, or
    ``auto`` on a host with more than one GPU, no count asked for and no
    card named (``device="cuda:1"`` pins that one card)."""
    n = int(kwargs.get("mesh_devices") or 0)
    if n > 1:
        return True
    dev = torch.device(kwargs.get("device", "cuda"))
    return (name == "auto" and n == 0 and dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() > 1)


def get_backend(name: str = "auto", **kwargs):
    name = (name or "auto").lower()
    if name in MESH_NAMES or (name in CUDA_NAMES and _wants_mesh(name, kwargs)):
        return CudaMeshBackend(**kwargs)
    if name in CUDA_NAMES:
        return CudaBackend(**kwargs)
    if name == "python":
        return PythonBackend(**kwargs)
    if name == "torch":
        return TorchBackend(**kwargs)
    if name in _NOT_PORTED:
        raise ValueError(f"worker backend {name!r} is not ported yet: it waits for "
                         f"{_NOT_PORTED[name]}")
    raise ValueError(f"unknown worker backend {name!r}: python, torch, cuda (pallas, jax), "
                     f"cuda-mesh (pallas-mesh, jax-mesh, mesh) or auto")
