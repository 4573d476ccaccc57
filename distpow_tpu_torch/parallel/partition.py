"""Search-space partition algebra: byte-prefix sharding of the secret space.

The coordinator computes ``worker_bits = floor(log2(num_workers))``
(coordinator.go:326) and each worker expands its index into the first
secret bytes it owns (worker.go:301-316)::

    remainder_bits = 8 - (worker_bits % 9)
    thread_bytes[i] = uint8((worker_byte << remainder_bits) | i)

For a non-power-of-two worker count the high workers' prefixes wrap
through the uint8 conversion and overlap low shards.  That is kept
bug-for-bug: overlap is harmless, gaps would not be.  Inside a worker the
same algebra applies once more across the shards of a mesh
(``split_thread_bytes``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple


def worker_bits(num_workers: int) -> int:
    """``uint(math.Log2(num_workers))`` as in coordinator.go:326."""
    if num_workers <= 0:
        raise ValueError("num_workers must be positive")
    return int(math.log2(num_workers))


def remainder_bits(bits: int) -> int:
    """``8 - (worker_bits % 9)`` as in worker.go:302."""
    return 8 - (bits % 9)


def thread_bytes(worker_byte: int, bits: int) -> List[int]:
    """The worker's owned first-secret-byte values (worker.go:312-316);
    ``& 0xFF`` reproduces Go's uint8 wrap."""
    r = remainder_bits(bits)
    return [((worker_byte << r) | i) & 0xFF for i in range(1 << r)]


def contiguous_bounds(thread_bytes: Sequence[int]) -> Tuple[int, int]:
    """``(tb_lo, count)`` for a contiguous ascending thread-byte run."""
    tbs = list(thread_bytes)
    if not tbs:
        raise ValueError("empty thread byte set")
    lo = tbs[0]
    if tbs != list(range(lo, lo + len(tbs))):
        raise ValueError(f"thread bytes not a contiguous run: {tbs[:8]}...")
    return lo, len(tbs)


def split_thread_bytes(tbs: Sequence[int], num_shards: int) -> List[List[int]]:
    """Sub-partition a worker's thread bytes across mesh shards: contiguous
    slices, the first ``len(tbs) % num_shards`` one longer, so each shard
    owns a contiguous prefix range (prefix -> device).  With fewer thread
    bytes than shards the surplus shards get empty slices (the mesh then
    splits the chunk range instead)."""
    if num_shards <= 0:
        raise ValueError("num_shards must be positive")
    base, rem = divmod(len(tbs), num_shards)
    shards: List[List[int]] = []
    pos = 0
    for s in range(num_shards):
        size = base + (1 if s < rem else 0)
        shards.append(list(tbs[pos:pos + size]))
        pos += size
    return shards
