"""Admission control — typed RETRY_AFTER backpressure.

The coordinator's Mine handler bounds the number of concurrently
fanned-out miss rounds (``CoordinatorConfig.SchedMaxInflight``).  A
request arriving beyond the bound is REJECTED with
:class:`AdmissionReject` instead of queueing without limit: the
exception's ``retry_after_s`` hint travels in the RPC response frame as
a dedicated ``retry_after`` field — a JSON key on wire v1, a typed
header flag + f64 on wire v2 (runtime/wire.py ``FLAG_RETRY_AFTER``;
golden-vectored in tests/test_wire.py) — which runtime/rpc.py surfaces
as ``RPCRetryAfter`` on the client, and powlib treats it as a
*server-paced, non-counting* retry — backpressure never burns the
client's transport-failure retry budget toward the terminal
``degraded:`` error (nodes/powlib.py).

Shedding at admission rather than queueing is the standard serving-
stack trade (the inference-server analogue is a 429 + Retry-After):
the coordinator's memory stays bounded under any client storm, clients
pace themselves off the server's own hint instead of a guessed
backoff, and the requests that ARE admitted keep their latency instead
of aging in an unbounded queue.

The port's own copy of the reference's ``sched/admission.py``
(``distpow_tpu/sched/admission.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations


class AdmissionReject(RuntimeError):
    """Run queue full — retry after ``retry_after_s`` seconds.

    The ``retry_after_s`` attribute is the typed payload the RPC server
    copies into the response frame (runtime/rpc.py ``_dispatch`` duck-
    types on the attribute so the runtime layer never imports sched).
    The message embeds the hint too, so an untyped transport still
    shows a human-actionable error.
    """

    def __init__(self, retry_after_s: float, detail: str = "") -> None:
        self.retry_after_s = float(retry_after_s)
        msg = f"retry-after:{self.retry_after_s:.3f}s"
        if detail:
            msg = f"{msg} {detail}"
        super().__init__(msg)
