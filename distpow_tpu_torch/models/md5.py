"""MD5 on int64-carried 32-bit words (torch), plus a pure-Python twin.

``md5_compress`` is the plain torch version of the hash the CUDA kernel
(``csrc/md5.cuh``) computes.  Words are int64 tensors holding values in
``[0, 2^32)``; every add and left shift is masked back to 32 bits (the
carrier choice is recorded in ``ops/__init__.py``).  Constant message
words may be Python ints: the round constant is folded into them, as the
reference folds ``K[i] + m`` for constant words.

``py_compress`` / ``py_absorb`` / ``py_digest`` are the host-side twin:
prefix absorption for long nonces and an oracle independent of torch.
"""

from __future__ import annotations

import math
import struct
from typing import Sequence, Tuple

MD5_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)

# K[i] = floor(abs(sin(i+1)) * 2^32)
MD5_K = tuple(int(abs(math.sin(i + 1)) * (1 << 32)) & 0xFFFFFFFF for i in range(64))

MD5_S = (
    7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
    5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20,
    4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
    6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
)

BLOCK_BYTES = 64
DIGEST_WORDS = 4
WORD_BYTEORDER = "little"
LENGTH_BYTEORDER = "little"

MASK32 = 0xFFFFFFFF


def _round_g(i: int) -> int:
    if i < 16:
        return i
    if i < 32:
        return (5 * i + 1) % 16
    if i < 48:
        return (3 * i + 5) % 16
    return (7 * i) % 16


def _round_f(i: int, b, c, d):
    # ``~x & y`` on a value in [0, 2^32) is ``(x ^ MASK32) & y``
    if i < 16:
        return (b & c) | ((b ^ MASK32) & d)
    if i < 32:
        return (d & b) | ((d ^ MASK32) & c)
    if i < 48:
        return b ^ c ^ d
    return c ^ (b | (d ^ MASK32))


def _rotl(x, s: int):
    return ((x << s) & MASK32) | (x >> (32 - s))


def md5_compress(state: Sequence, words: Sequence):
    """One MD5 block compression on int64-carried 32-bit words.

    ``state`` holds 4 ints or int64 tensors; ``words`` holds 16
    broadcast-compatible int64 tensors or ints.  Returns the new state,
    each word masked to 32 bits.
    """
    a0, b0, c0, d0 = state
    a, b, c, d = a0, b0, c0, d0
    for i in range(64):
        f = _round_f(i, b, c, d)
        m = words[_round_g(i)]
        if isinstance(m, int):
            f = (f + a + ((MD5_K[i] + m) & MASK32)) & MASK32
        else:
            f = (f + a + MD5_K[i] + m) & MASK32
        a, d, c = d, c, b
        b = (b + _rotl(f, MD5_S[i])) & MASK32
    return ((a0 + a) & MASK32, (b0 + b) & MASK32,
            (c0 + c) & MASK32, (d0 + d) & MASK32)


def py_compress(state: Tuple[int, int, int, int], block: bytes) -> Tuple[int, int, int, int]:
    """Pure-Python MD5 block compression on a 64-byte block."""
    if len(block) != BLOCK_BYTES:
        raise ValueError(f"md5 block must be {BLOCK_BYTES} bytes, got {len(block)}")
    return md5_compress(state, struct.unpack("<16I", block))


def py_absorb(prefix: bytes) -> Tuple[Tuple[int, int, int, int], bytes, int]:
    """Absorb every complete 64-byte block of ``prefix``.

    Returns ``(state, remainder_bytes, absorbed_len)``: the device only
    hashes the tail block(s) that hold per-candidate bytes.
    """
    state = MD5_INIT
    n_full = len(prefix) // BLOCK_BYTES
    for i in range(n_full):
        state = py_compress(state, prefix[i * BLOCK_BYTES : (i + 1) * BLOCK_BYTES])
    return state, prefix[n_full * BLOCK_BYTES :], n_full * BLOCK_BYTES


def py_digest(message: bytes) -> bytes:
    """Full MD5 of ``message`` via the pure-Python compression (oracle)."""
    state, rem, _ = py_absorb(message)
    tail = rem + b"\x80"
    tail += b"\x00" * ((-len(tail) - 8) % BLOCK_BYTES) + struct.pack("<Q", len(message) * 8)
    for i in range(0, len(tail), BLOCK_BYTES):
        state = py_compress(state, tail[i : i + BLOCK_BYTES])
    return b"".join(w.to_bytes(4, "little") for w in state)
