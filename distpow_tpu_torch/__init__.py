"""PyTorch/CUDA port of distpow: the worker's compute plane on the card,
and the device-less processes around it.

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
* ``backends/`` ``python`` / ``native`` (C++, g++) / ``torch`` / ``cuda``
                miners and ``get_backend``
* ``sched/``    the batching scheduler and its launch lanes; the
                coordinator's admission and coalescing
* ``nodes/``    the worker node, the coordinator, the client and powlib
* ``cli/``      ``python -m distpow_tpu_torch.cli.<name>``: worker,
                coordinator, client, tracing_server, config_gen,
                trace_check, stats, slo, forensics, soak, lint
* ``cluster/``  the coordinator pool: hash ring, redirects, replication
* ``fleet/``    the elastic fleet: the worker's agent, the coordinator's
                lease registry
* ``obs/``      the cluster view: merged fleet scrapes, time series, the
                SLO engine, cross-node request forensics
* ``load/``     the open-loop load generator, rate shapes, the in-process
                cluster and its load and soak harnesses
* ``runtime/``  metrics, spans, flight recorder, watchdog, the runtime
                lock-order audit, and the RPC plane: wire codec, RPC,
                tracing, tracing server, trace check, config, cache,
                faults, health
* ``analysis/`` distpow-lint: the AST rule engine and its 17 rules
* ``csrc/``     the hand-written CUDA sources (built at first use)

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); without a GPU they raise instead of falling back.  The
coordinator, client, tracing-server, stats, SLO, forensics and lint
processes never touch a device and import no ``torch``.
"""
