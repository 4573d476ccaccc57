"""PyTorch/CUDA port of the distpow worker's compute plane.

A second package beside ``distpow_tpu`` (the JAX reference, which stays
as it is).  It imports ``torch`` and numpy, never ``jax``, and nothing
from ``distpow_tpu``: every module keeps its own copy of what it needs.

Layout mirrors the reference package:

* ``models/``   puzzle semantics, the nine hash models (md5, sha256,
                sha256d, sha1, ripemd160, sha512, sha384, sha3_256,
                blake2b_256), the hash-model registry
* ``ops/``      difficulty masks, tail packing, the plain torch search
                step, the CUDA kernels' build and wrapper
* ``parallel/`` partition algebra and the pipelined search driver
* ``backends/`` ``python`` / ``torch`` / ``cuda`` miners and ``get_backend``
* ``sched/``    the batching scheduler and its launch lanes
* ``nodes/``    the worker node (``Worker``, ``WorkerRPCHandler``)
* ``cli/``      ``python -m distpow_tpu_torch.cli.worker``
* ``fleet/``    the worker's side of the elastic fleet
* ``runtime/``  metrics, spans, flight recorder, watchdog, and the worker's
                RPC plane: wire codec, RPC, tracing, config, cache, faults,
                health
* ``csrc/``     the hand-written CUDA sources (built at first use)

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); without a GPU they raise instead of falling back.
"""
