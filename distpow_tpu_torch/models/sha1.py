"""SHA-1 on int64-carried 32-bit words (torch), plus a pure-Python twin.

``sha1_compress`` is the plain torch version of the hash the CUDA kernel
(``csrc/sha1.cuh``) computes, on the same word carrier as
``models/sha256.py``.  ``py_compress`` / ``py_absorb`` / ``py_digest`` are
the host-side twin.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

SHA1_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)

# One constant per 20-round group (FIPS 180-4 section 4.2.1).
SHA1_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)

BLOCK_BYTES = 64
DIGEST_WORDS = 5
WORD_BYTEORDER = "big"
LENGTH_BYTEORDER = "big"

MASK32 = 0xFFFFFFFF


def _rotl(x, s: int):
    return ((x << s) & MASK32) | (x >> (32 - s))


def _round_f(i: int, b, c, d):
    if i < 20:
        return (b & c) | ((b ^ MASK32) & d)
    if 40 <= i < 60:
        return (b & c) | (b & d) | (c & d)
    return b ^ c ^ d


def sha1_compress(state: Sequence, words: Sequence):
    """One SHA-1 block compression on int64-carried 32-bit words.

    ``state`` holds 5 ints or int64 tensors; ``words`` holds 16
    broadcast-compatible int64 tensors or ints (big-endian message words).
    """
    w = list(words)
    for i in range(16, 80):
        w.append(_rotl(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1))
    a, b, c, d, e = state
    for i in range(80):
        temp = (_rotl(a, 5) + _round_f(i, b, c, d) + e
                + ((SHA1_K[i // 20] + w[i]) & MASK32)) & MASK32
        a, b, c, d, e = temp, a, _rotl(b, 30), c, d
    return tuple((s0 + s) & MASK32 for s0, s in zip(state, (a, b, c, d, e)))


def py_compress(state: Tuple[int, ...], block: bytes) -> Tuple[int, ...]:
    """Pure-Python SHA-1 block compression on a 64-byte block."""
    if len(block) != BLOCK_BYTES:
        raise ValueError(f"sha1 block must be {BLOCK_BYTES} bytes, got {len(block)}")
    return sha1_compress(state, struct.unpack(">16I", block))


def py_absorb(prefix: bytes) -> Tuple[Tuple[int, ...], bytes, int]:
    """Absorb every complete 64-byte block of ``prefix``: ``(state,
    remainder_bytes, absorbed_len)``."""
    state = SHA1_INIT
    n_full = len(prefix) // BLOCK_BYTES
    for i in range(n_full):
        state = py_compress(state, prefix[i * BLOCK_BYTES : (i + 1) * BLOCK_BYTES])
    return state, prefix[n_full * BLOCK_BYTES :], n_full * BLOCK_BYTES


def py_digest(message: bytes) -> bytes:
    """Full SHA-1 of ``message`` via the pure-Python compression (oracle)."""
    state, rem, _ = py_absorb(message)
    tail = rem + b"\x80"
    tail += b"\x00" * ((-len(tail) - 8) % BLOCK_BYTES) + struct.pack(">Q", len(message) * 8)
    for i in range(0, len(tail), BLOCK_BYTES):
        state = py_compress(state, tail[i : i + BLOCK_BYTES])
    return b"".join(w.to_bytes(4, "big") for w in state)
