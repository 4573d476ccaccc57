"""SHA-512 on limb pairs of int64-carried 32-bit words (torch), plus a
pure-Python twin.

``sha512_compress`` is the plain torch version of the hash the CUDA kernel
(``csrc/sha512.cuh``) computes.  The search layers speak 32-bit words, so
every 64-bit word of SHA-512 is a pair of them, (hi, lo), in the order of
the big-endian serialization: the state is 16 words, a 128-byte block 32,
the digest 16.  Each 32-bit word is an int64 tensor (or a Python int)
holding a value in ``[0, 2^32)``, as everywhere in the port
(``ops/__init__.py``).  A 64-bit add sums the low words, carries
``lo >> 32`` into the sum of the high words and masks both; a 64-bit
rotation or shift moves bits across the pair.  A 64-bit value is never
carried in one int64: torch's int64 ``>>`` is arithmetic, and CPU torch
implements no uint64 arithmetic.  The compress uses no torch function,
only operators, so it also runs on Python ints.

``py_compress`` / ``py_absorb`` / ``py_digest`` are the host-side twin on
Python's 64-bit ints (FIPS 180-4): prefix absorption for long nonces and
an oracle independent of the limb algebra.  SHA-384 (``models/sha384.py``)
shares the compression with its own initial value.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

BLOCK_BYTES = 128
DIGEST_WORDS = 16          # 8 64-bit words as (hi, lo) 32-bit pairs
WORD_BYTEORDER = "big"
LENGTH_BYTEORDER = "big"
LENGTH_BYTES = 16          # the 128-bit message bit-length field

# FIPS 180-4 section 5.3.5: initial hash value.
SHA512_INIT64 = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

# Section 4.2.3: the 80 round constants.
SHA512_K64 = (
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F,
    0xE9B5DBA58189DBBC, 0x3956C25BF348B538, 0x59F111F1B605D019,
    0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118, 0xD807AA98A3030242,
    0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235,
    0xC19BF174CF692694, 0xE49B69C19EF14AD2, 0xEFBE4786384F25E3,
    0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65, 0x2DE92C6F592B0275,
    0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F,
    0xBF597FC7BEEF0EE4, 0xC6E00BF33DA88FC2, 0xD5A79147930AA725,
    0x06CA6351E003826F, 0x142929670A0E6E70, 0x27B70A8546D22FFC,
    0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6,
    0x92722C851482353B, 0xA2BFE8A14CF10364, 0xA81A664BBC423001,
    0xC24B8B70D0F89791, 0xC76C51A30654BE30, 0xD192E819D6EF5218,
    0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99,
    0x34B0BCB5E19B48A8, 0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB,
    0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3, 0x748F82EE5DEFB2FC,
    0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915,
    0xC67178F2E372532B, 0xCA273ECEEA26619C, 0xD186B8C721C0C207,
    0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178, 0x06F067AA72176FBA,
    0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC,
    0x431D67C49C100D4C, 0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A,
    0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
)

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1


def split64(values) -> Tuple[int, ...]:
    """64-bit words -> their (hi, lo) 32-bit pairs, flattened."""
    return tuple(w for v in values for w in ((v >> 32) & MASK32, v & MASK32))


SHA512_INIT = split64(SHA512_INIT64)
_K = tuple((k >> 32, k & MASK32) for k in SHA512_K64)


def _add(*pairs):
    """Sum of (hi, lo) pairs mod 2^64: the low words' carry goes high."""
    lo = pairs[0][1]
    hi = pairs[0][0]
    for p in pairs[1:]:
        lo = lo + p[1]
        hi = hi + p[0]
    return (hi + (lo >> 32)) & MASK32, lo & MASK32


def _rotr(x, n: int):
    """Rotate a (hi, lo) pair right by ``n`` (0 < n < 64, n != 32)."""
    hi, lo = x
    if n > 32:
        hi, lo, n = lo, hi, n - 32
    return ((hi >> n) | ((lo << (32 - n)) & MASK32),
            (lo >> n) | ((hi << (32 - n)) & MASK32))


def _shr(x, n: int):
    """Shift a (hi, lo) pair right by ``n`` (0 < n < 32)."""
    hi, lo = x
    return hi >> n, (lo >> n) | ((hi << (32 - n)) & MASK32)


def _xor(*pairs):
    hi, lo = pairs[0]
    for p in pairs[1:]:
        hi, lo = hi ^ p[0], lo ^ p[1]
    return hi, lo


def sha512_compress(state: Sequence, words: Sequence):
    """One SHA-512 block compression on (hi, lo) pairs of 32-bit words.

    ``state`` holds 16 ints or int64 tensors, ``words`` 32 broadcast-
    compatible ones (the block's 16 big-endian 64-bit words, hi first).
    Returns the new 16-word state, each word in ``[0, 2^32)``."""
    w = [(words[2 * i], words[2 * i + 1]) for i in range(16)]
    for i in range(16, 80):
        w15, w2 = w[i - 15], w[i - 2]
        s0 = _xor(_rotr(w15, 1), _rotr(w15, 8), _shr(w15, 7))
        s1 = _xor(_rotr(w2, 19), _rotr(w2, 61), _shr(w2, 6))
        w.append(_add(w[i - 16], s0, w[i - 7], s1))
    h0 = [(state[2 * i], state[2 * i + 1]) for i in range(8)]
    a, b, c, d, e, f, g, h = h0
    for i in range(80):
        s1 = _xor(_rotr(e, 14), _rotr(e, 18), _rotr(e, 41))
        ch = tuple((e[j] & f[j]) ^ ((e[j] ^ MASK32) & g[j]) for j in (0, 1))
        t1 = _add(h, s1, ch, _K[i], w[i])
        s0 = _xor(_rotr(a, 28), _rotr(a, 34), _rotr(a, 39))
        maj = tuple((a[j] & b[j]) ^ (a[j] & c[j]) ^ (b[j] & c[j]) for j in (0, 1))
        h, g, f, e, d, c, b, a = g, f, e, _add(d, t1), c, b, a, _add(t1, s0, maj)
    out = []
    for x, y in zip(h0, (a, b, c, d, e, f, g, h)):
        out.extend(_add(x, y))
    return tuple(out)


def _rotr64(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & MASK64


def py_compress(state: Tuple[int, ...], block: bytes) -> Tuple[int, ...]:
    """Pure-Python SHA-512 compression of a 128-byte block on 64-bit ints;
    ``state`` and the result in the 16-word (hi, lo) form."""
    if len(block) != BLOCK_BYTES:
        raise ValueError(f"sha512 block must be {BLOCK_BYTES} bytes, got {len(block)}")
    w = list(struct.unpack(">16Q", block))
    for i in range(16, 80):
        s0 = _rotr64(w[i - 15], 1) ^ _rotr64(w[i - 15], 8) ^ (w[i - 15] >> 7)
        s1 = _rotr64(w[i - 2], 19) ^ _rotr64(w[i - 2], 61) ^ (w[i - 2] >> 6)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & MASK64)
    hs = [(state[2 * i] << 32) | state[2 * i + 1] for i in range(8)]
    a, b, c, d, e, f, g, h = hs
    for i in range(80):
        s1 = _rotr64(e, 14) ^ _rotr64(e, 18) ^ _rotr64(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + SHA512_K64[i] + w[i]) & MASK64
        s0 = _rotr64(a, 28) ^ _rotr64(a, 34) ^ _rotr64(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & MASK64
        d, c, b, a = c, b, a, (t1 + s0 + maj) & MASK64
    return split64((x + y) & MASK64 for x, y in zip(hs, (a, b, c, d, e, f, g, h)))


def py_absorb(prefix: bytes, init: Tuple[int, ...] = SHA512_INIT
              ) -> Tuple[Tuple[int, ...], bytes, int]:
    """Absorb every complete 128-byte block of ``prefix`` from ``init``
    (SHA-384 passes its own): ``(state, remainder_bytes, absorbed_len)``."""
    state = init
    n_full = len(prefix) // BLOCK_BYTES
    for i in range(n_full):
        state = py_compress(state, prefix[i * BLOCK_BYTES : (i + 1) * BLOCK_BYTES])
    return state, prefix[n_full * BLOCK_BYTES :], n_full * BLOCK_BYTES


def py_digest(message: bytes, init: Tuple[int, ...] = SHA512_INIT,
              digest_words: int = DIGEST_WORDS) -> bytes:
    """SHA-512 (or, with SHA-384's init and 12 words, SHA-384) of
    ``message`` via the pure-Python compression (oracle)."""
    state, rem, _ = py_absorb(message, init)
    tail = rem + b"\x80"
    tail += b"\x00" * ((-len(tail) - LENGTH_BYTES) % BLOCK_BYTES)
    tail += (len(message) * 8).to_bytes(LENGTH_BYTES, "big")
    for i in range(0, len(tail), BLOCK_BYTES):
        state = py_compress(state, tail[i : i + BLOCK_BYTES])
    return b"".join(w.to_bytes(4, "big") for w in state[:digest_words])
