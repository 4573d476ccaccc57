"""Double SHA-256 (sha256d), Bitcoin's proof-of-work hash.

``sha256d(m) = sha256(sha256(m))``.  The first hash is plain SHA-256 over
the candidate's tail blocks (``models/sha256.py``).  Its 32-byte digest is
the message of a second SHA-256 whose one block has a fixed layout: the
digest, the 0x80 marker, zeros and the bit length 256.  That second stage
is the registry's ``finalize`` hook: the search step applies it after the
last compress and before the difficulty check, and nothing below the
registry sees it.  Both stages are big-endian, so the first state's words
are the second block's first 8 message words as they are.
"""

from __future__ import annotations

from typing import Tuple

from .sha256 import BLOCK_BYTES, DIGEST_WORDS, SHA256_INIT, py_compress, sha256_compress

# The second block's words 8-15: 0x80 after the 32 digest bytes, zeros, and
# the 64-bit big-endian bit length of a 32-byte message.
SECOND_BLOCK_TAIL_WORDS: Tuple[int, ...] = (0x80000000, 0, 0, 0, 0, 0, 0, 256)


def sha256d_finalize(state):
    """The second SHA-256 over the first digest, on int64-carried words."""
    return sha256_compress(SHA256_INIT, list(state[:DIGEST_WORDS]) + list(SECOND_BLOCK_TAIL_WORDS))


def py_finalize(state: Tuple[int, ...]) -> Tuple[int, ...]:
    """Pure-Python twin of ``sha256d_finalize``."""
    digest = b"".join(int(w).to_bytes(4, "big") for w in state[:DIGEST_WORDS])
    block = digest + b"\x80" + bytes(BLOCK_BYTES - len(digest) - 9) + (8 * len(digest)).to_bytes(8, "big")
    return py_compress(SHA256_INIT, block)
