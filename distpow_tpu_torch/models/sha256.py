"""SHA-256 on int64-carried 32-bit words (torch), plus a pure-Python twin.

``sha256_compress`` is the plain torch version of the hash the CUDA kernel
(``csrc/sha256.cuh``) computes.  Words are int64 tensors holding values in
``[0, 2^32)``, masked back to 32 bits after every add and left shift (the
carrier choice is recorded in ``ops/__init__.py``); constant words may be
Python ints, and the schedule words computed only from them stay ints.
Torch runs eagerly, so the rounds are a plain loop: the reference's split
into a loop form and an unrolled form is a matter of XLA:CPU compile time.

``py_compress`` / ``py_absorb`` / ``py_digest`` are the host-side twin:
prefix absorption for long nonces and an oracle independent of torch.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

SHA256_INIT = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

SHA256_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

BLOCK_BYTES = 64
DIGEST_WORDS = 8
WORD_BYTEORDER = "big"
LENGTH_BYTEORDER = "big"

MASK32 = 0xFFFFFFFF


def _rotr(x, s: int):
    return (x >> s) | ((x << (32 - s)) & MASK32)


def _schedule(words: Sequence) -> list:
    w = list(words)
    for i in range(16, 64):
        w15, w2 = w[i - 15], w[i - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & MASK32)
    return w


def sha256_compress(state: Sequence, words: Sequence):
    """One SHA-256 block compression on int64-carried 32-bit words.

    ``state`` holds 8 ints or int64 tensors; ``words`` holds 16
    broadcast-compatible int64 tensors or ints (big-endian message words).
    Returns the new state, each word masked to 32 bits.
    """
    w = _schedule(words)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ MASK32) & g)
        t1 = (h + s1 + ch + ((SHA256_K[i] + w[i]) & MASK32)) & MASK32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & MASK32, c, b, a, (t1 + s0 + maj) & MASK32
    return tuple((s0 + s) & MASK32 for s0, s in zip(state, (a, b, c, d, e, f, g, h)))


def py_compress(state: Tuple[int, ...], block: bytes) -> Tuple[int, ...]:
    """Pure-Python SHA-256 block compression on a 64-byte block."""
    if len(block) != BLOCK_BYTES:
        raise ValueError(f"sha256 block must be {BLOCK_BYTES} bytes, got {len(block)}")
    return sha256_compress(state, struct.unpack(">16I", block))


def py_absorb(prefix: bytes) -> Tuple[Tuple[int, ...], bytes, int]:
    """Absorb every complete 64-byte block of ``prefix``: ``(state,
    remainder_bytes, absorbed_len)``."""
    state = SHA256_INIT
    n_full = len(prefix) // BLOCK_BYTES
    for i in range(n_full):
        state = py_compress(state, prefix[i * BLOCK_BYTES : (i + 1) * BLOCK_BYTES])
    return state, prefix[n_full * BLOCK_BYTES :], n_full * BLOCK_BYTES


def py_digest(message: bytes) -> bytes:
    """Full SHA-256 of ``message`` via the pure-Python compression (oracle)."""
    state, rem, _ = py_absorb(message)
    tail = rem + b"\x80"
    tail += b"\x00" * ((-len(tail) - 8) % BLOCK_BYTES) + struct.pack(">Q", len(message) * 8)
    for i in range(0, len(tail), BLOCK_BYTES):
        state = py_compress(state, tail[i : i + BLOCK_BYTES])
    return b"".join(w.to_bytes(4, "big") for w in state)
