"""Search-space partition algebra: byte-prefix sharding of the secret space.

The coordinator computes ``worker_bits = floor(log2(num_workers))``
(coordinator.go:326) and each worker expands its index into the first
secret bytes it owns (worker.go:301-316)::

    remainder_bits = 8 - (worker_bits % 9)
    thread_bytes[i] = uint8((worker_byte << remainder_bits) | i)

For a non-power-of-two worker count the high workers' prefixes wrap
through the uint8 conversion and overlap low shards.  That is kept
bug-for-bug: overlap is harmless, gaps would not be.
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
