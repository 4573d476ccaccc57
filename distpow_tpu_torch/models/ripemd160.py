"""RIPEMD-160 on int64-carried 32-bit words (torch), plus a pure-Python twin.

``ripemd160_compress`` is the plain torch version of the hash the CUDA
kernel (``csrc/ripemd160.cuh``) computes: two independent 80-round lines
over the same 16 little-endian message words, combined across the lines at
the end.  It uses no torch function, only operators, so on ints it is also
the pure-Python compression behind ``py_absorb``, ``py_digest`` and
``Ripemd160``, the hashlib-shaped object ``models/puzzle.py`` hands out
where ``hashlib.new("ripemd160")`` is missing (OpenSSL 3 without its legacy
provider).

Tables from the RIPEMD-160 specification (Dobbertin, Bosselaers, Preneel;
ISO/IEC 10118-3).
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

RIPEMD160_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)

BLOCK_BYTES = 64
DIGEST_WORDS = 5
WORD_BYTEORDER = "little"
LENGTH_BYTEORDER = "little"

# Per-16-round-group additive constants (left line, right line).
KL = (0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E)
KR = (0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000)

# Message-word selection order, left line.
RL = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
)
# Message-word selection order, right line.
RR = (
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
)
# Rotation amounts, left line.
SL = (
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
)
# Rotation amounts, right line.
SR = (
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
)

MASK32 = 0xFFFFFFFF


def round_f(j: int, x, y, z):
    """Boolean function of round ``j`` (left-line order; the right line
    runs them in reverse, ``round_f(79 - j, ...)``).  ``~v`` on a value in
    ``[0, 2^32)`` is written ``v ^ MASK32``."""
    g = j // 16
    if g == 0:
        return x ^ y ^ z
    if g == 1:
        return (x & y) | ((x ^ MASK32) & z)
    if g == 2:
        return (x | (y ^ MASK32)) ^ z
    if g == 3:
        return (x & z) | (y & (z ^ MASK32))
    return x ^ (y | (z ^ MASK32))


def _rotl(x, s: int):
    return ((x << s) & MASK32) | (x >> (32 - s))


def ripemd160_compress(state: Sequence, words: Sequence):
    """One RIPEMD-160 block compression on int64-carried 32-bit words.

    ``state`` holds 5 ints or int64 tensors; ``words`` holds 16
    broadcast-compatible int64 tensors or ints (little-endian message
    words).  Returns the new state, each word masked to 32 bits.
    """
    h0, h1, h2, h3, h4 = state
    al, bl, cl, dl, el = state
    ar, br, cr, dr, er = state
    for j in range(80):
        t = (al + round_f(j, bl, cl, dl) + words[RL[j]] + KL[j // 16]) & MASK32
        t = (_rotl(t, SL[j]) + el) & MASK32
        al, el, dl, cl, bl = el, dl, _rotl(cl, 10), bl, t
        t = (ar + round_f(79 - j, br, cr, dr) + words[RR[j]] + KR[j // 16]) & MASK32
        t = (_rotl(t, SR[j]) + er) & MASK32
        ar, er, dr, cr, br = er, dr, _rotl(cr, 10), br, t
    return (
        (h1 + cl + dr) & MASK32,
        (h2 + dl + er) & MASK32,
        (h3 + el + ar) & MASK32,
        (h4 + al + br) & MASK32,
        (h0 + bl + cr) & MASK32,
    )


def py_compress(state: Tuple[int, ...], block: bytes) -> Tuple[int, ...]:
    """Pure-Python RIPEMD-160 block compression on a 64-byte block."""
    if len(block) != BLOCK_BYTES:
        raise ValueError(f"ripemd160 block must be {BLOCK_BYTES} bytes, got {len(block)}")
    return ripemd160_compress(state, struct.unpack("<16I", block))


def py_absorb(prefix: bytes) -> Tuple[Tuple[int, ...], bytes, int]:
    """Absorb every complete 64-byte block of ``prefix``: ``(state,
    remainder_bytes, absorbed_len)``."""
    state = RIPEMD160_INIT
    n_full = len(prefix) // BLOCK_BYTES
    for i in range(n_full):
        state = py_compress(state, prefix[i * BLOCK_BYTES : (i + 1) * BLOCK_BYTES])
    return state, prefix[n_full * BLOCK_BYTES :], n_full * BLOCK_BYTES


def py_digest(message: bytes) -> bytes:
    """Full RIPEMD-160 of ``message`` via the pure-Python compression."""
    state, rem, _ = py_absorb(message)
    tail = rem + b"\x80"
    tail += b"\x00" * ((-len(tail) - 8) % BLOCK_BYTES) + struct.pack("<Q", len(message) * 8)
    for i in range(0, len(tail), BLOCK_BYTES):
        state = py_compress(state, tail[i : i + BLOCK_BYTES])
    return b"".join(w.to_bytes(4, "little") for w in state)


class Ripemd160:
    """hashlib-shaped RIPEMD-160 over ``py_digest`` (the fallback where
    ``hashlib.new("ripemd160")`` raises)."""

    name = "ripemd160"
    digest_size = 20
    block_size = BLOCK_BYTES

    def __init__(self, data: bytes = b""):
        self._buf = bytearray(data)

    def update(self, data: bytes) -> None:
        self._buf += data

    def digest(self) -> bytes:
        return py_digest(bytes(self._buf))

    def hexdigest(self) -> str:
        return self.digest().hex()

    def copy(self) -> "Ripemd160":
        return Ripemd160(bytes(self._buf))
