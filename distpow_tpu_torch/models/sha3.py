"""SHA3-256 on limb pairs of int64-carried 32-bit words (torch), plus a
pure-Python twin.

Keccak is a sponge: the state is 25 64-bit lanes, all zero at the start, a
block is the 136-byte rate (17 lanes) XORed into the leading lanes before
the permutation Keccak-f[1600], and the digest is the first 4 lanes (FIPS
202).  The search layers speak 32-bit words, so each lane is a (lo, hi)
pair in the order of its little-endian serialization (the opposite of
SHA-512's (hi, lo)): the state is 50 words, a block 34, the digest the
first 8.  ``sha3_256_compress`` (absorb one block: XOR, then permute) is
the plain torch version of what the CUDA kernel (``csrc/sha3.cuh``)
computes; like the other models it uses only operators, so it also runs
on Python ints.

``py_compress`` / ``py_absorb`` / ``py_digest`` are the host-side twin on
Python's 64-bit ints.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

BLOCK_BYTES = 136          # the rate: 1088 bits
DIGEST_WORDS = 8           # 4 lanes
WORD_BYTEORDER = "little"
LENGTH_BYTEORDER = "little"  # no length field in the sponge's padding
STATE_WORDS = 50           # 25 lanes as (lo, hi) pairs
RATE_LANES = BLOCK_BYTES // 8

SHA3_INIT: Tuple[int, ...] = (0,) * STATE_WORDS

# Round constants of the iota step.
KECCAK_RC: Tuple[int, ...] = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rotation offsets of the rho step, KECCAK_ROT[x][y] for lane x + 5y.
KECCAK_ROT: Tuple[Tuple[int, ...], ...] = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1


def _rotl(p, n: int):
    """Rotate a (lo, hi) pair left by ``n`` (0 <= n < 64)."""
    lo, hi = p
    if n >= 32:
        lo, hi, n = hi, lo, n - 32
    if n == 0:
        return lo, hi
    return (((lo << n) & MASK32) | (hi >> (32 - n)),
            ((hi << n) & MASK32) | (lo >> (32 - n)))


def _xor(*pairs):
    lo, hi = pairs[0]
    for p in pairs[1:]:
        lo, hi = lo ^ p[0], hi ^ p[1]
    return lo, hi


def keccak_f_pairs(lanes: List) -> List:
    """Keccak-f[1600] on 25 (lo, hi) pairs (lane index x + 5y)."""
    A = list(lanes)
    for rc in KECCAK_RC:
        C = [_xor(A[x], A[x + 5], A[x + 10], A[x + 15], A[x + 20]) for x in range(5)]
        D = [_xor(C[(x + 4) % 5], _rotl(C[(x + 1) % 5], 1)) for x in range(5)]
        A = [_xor(A[i], D[i % 5]) for i in range(25)]
        B = [None] * 25
        for x in range(5):
            for y in range(5):
                B[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(A[x + 5 * y], KECCAK_ROT[x][y])
        A = [tuple(B[x + 5 * y][j] ^ ((B[(x + 1) % 5 + 5 * y][j] ^ MASK32)
                                       & B[(x + 2) % 5 + 5 * y][j]) for j in (0, 1))
             for y in range(5) for x in range(5)]
        A[0] = (A[0][0] ^ (rc & MASK32), A[0][1] ^ (rc >> 32))
    return A


def sha3_256_compress(state: Sequence, words: Sequence):
    """Absorb one rate block: XOR the 34 words into the leading state
    words, then permute.  ``state`` holds 50 ints or int64 tensors,
    ``words`` 34 broadcast-compatible ones; returns the 50-word state."""
    limbs = [state[i] ^ words[i] if i < len(words) else state[i] for i in range(STATE_WORDS)]
    out = keccak_f_pairs([(limbs[2 * i], limbs[2 * i + 1]) for i in range(25)])
    return tuple(w for pair in out for w in pair)


def _rotl64(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & MASK64 if n else v


def keccak_f(lanes: List[int]) -> List[int]:
    """Keccak-f[1600] on 25 64-bit ints (lane index x + 5y)."""
    A = list(lanes)
    for rc in KECCAK_RC:
        C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rotl64(C[(x + 1) % 5], 1) for x in range(5)]
        A = [A[i] ^ D[i % 5] for i in range(25)]
        B = [0] * 25
        for x in range(5):
            for y in range(5):
                B[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(A[x + 5 * y], KECCAK_ROT[x][y])
        A = [B[x + 5 * y] ^ (~B[(x + 1) % 5 + 5 * y] & B[(x + 2) % 5 + 5 * y] & MASK64)
             for y in range(5) for x in range(5)]
        A[0] ^= rc
    return A


def py_compress(state: Tuple[int, ...], block: bytes) -> Tuple[int, ...]:
    """Absorb one 136-byte rate block on 64-bit ints; ``state`` and the
    result in the 50-word (lo, hi) form."""
    if len(block) != BLOCK_BYTES:
        raise ValueError(f"sha3_256 block must be {BLOCK_BYTES} bytes, got {len(block)}")
    lanes = [state[2 * i] | (state[2 * i + 1] << 32) for i in range(25)]
    for i in range(RATE_LANES):
        lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
    return tuple(w for v in keccak_f(lanes) for w in (v & MASK32, v >> 32))


def py_absorb(prefix: bytes) -> Tuple[Tuple[int, ...], bytes, int]:
    """Absorb every complete rate block of ``prefix``: ``(state,
    remainder_bytes, absorbed_len)``."""
    state = SHA3_INIT
    n_full = len(prefix) // BLOCK_BYTES
    for i in range(n_full):
        state = py_compress(state, prefix[i * BLOCK_BYTES : (i + 1) * BLOCK_BYTES])
    return state, prefix[n_full * BLOCK_BYTES :], n_full * BLOCK_BYTES


def py_digest(message: bytes) -> bytes:
    """SHA3-256 of ``message`` via the pure-Python twin (oracle)."""
    state, rem, _ = py_absorb(message)
    tail = bytearray(BLOCK_BYTES)
    tail[: len(rem)] = rem
    tail[len(rem)] ^= 0x06  # domain bits and the first pad bit
    tail[-1] ^= 0x80        # the last pad bit (0x86 when the two meet)
    state = py_compress(state, bytes(tail))
    return b"".join(w.to_bytes(4, "little") for w in state[:DIGEST_WORDS])
