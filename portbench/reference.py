"""The plain reference the answers are judged by: hashlib and the
reference's partition algebra, written out again.  It imports nothing of
the program.

A puzzle ``(nonce, ntz)`` under a hash model is solved by a ``secret``
whose digest of ``nonce || secret``, as lowercase hex, ends in ``ntz``
zero digits (the reference's worker.go:246-256).  The coordinator splits
the secrets by their first byte: with ``N`` workers, ``bits =
floor(log2(N))`` and worker ``w`` owns the first bytes ``((w << (8 - bits
% 9)) | i) & 0xFF`` for ``i < 2 ** (8 - bits % 9)`` (coordinator.go:326,
worker.go:301-316).

A worker tries its secrets in the reference's order (worker.go:234-244,
258-401): a secret is one of the worker's first bytes, ``tb``, then a
chunk counter of ``w`` little-endian bytes, the counter running from
``256 ** (w - 1)`` to ``256 ** w - 1`` for ``w = 0, 1, 2, ...`` (no chunk
at ``w = 0``), each counter value with every first byte in turn.  So a
secret is the worker's candidate ``chunk * count + tb - tb_lo`` (``tb_lo``
and ``count`` its first bytes' lowest and number).  ``candidates`` is one
more than that: the candidates tried up to and including the hit.
"""

from __future__ import annotations

import hashlib
import math
from typing import List


def digest(model: str, data: bytes) -> bytes:
    if model == "sha256d":
        return hashlib.sha256(hashlib.sha256(data).digest()).digest()
    return hashlib.new(model, data).digest()


def solves(model: str, nonce: bytes, secret: bytes, ntz: int) -> bool:
    """Whether ``secret`` solves ``(nonce, ntz)`` under ``model``."""
    return digest(model, nonce + secret).hex().endswith("0" * ntz)


def worker_bits(n_workers: int) -> int:
    return int(math.log2(n_workers))


def first_bytes(worker: int, n_workers: int) -> List[int]:
    """The first secret bytes worker ``worker`` of ``n_workers`` owns."""
    r = 8 - (worker_bits(n_workers) % 9)
    return [((worker << r) | i) & 0xFF for i in range(1 << r)]


def candidates(secret: bytes, n_workers: int) -> int:
    """How many candidates the worker that owns ``secret``'s first byte
    tries, in the reference's order, up to and including ``secret``.

    A secret whose chunk's top byte is 0 (``chunk < 256 ** (w - 1)``)
    lies outside its width's range; a launch that overruns its width's
    last counter value reaches it there, so it counts from the width's
    end: ``chunk + 256 ** w``."""
    count = 1 << (8 - worker_bits(n_workers) % 9)
    tb = secret[0]
    tb_lo = tb - tb % count
    width = len(secret) - 1
    chunk = int.from_bytes(secret[1:], "little")
    if width and chunk < 256 ** (width - 1):
        chunk += 256 ** width
    return chunk * count + tb - tb_lo + 1
