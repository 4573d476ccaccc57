"""BLAKE2b-256 on limb pairs of int64-carried 32-bit words (torch), plus a
pure-Python twin.

RFC 7693, sequential mode, no key, 32-byte digest: 128-byte blocks, 12
rounds of 8 G mixes, everything little-endian.  A compression reads more
than the state and the message: the byte count ``t`` through this block
and the finalization word ``f0`` (all ones on the last block).  For a
fixed search layout both are constants, so packing appends them to each
tail block's row as 4 parameter words (``block_param_words``):
t_lo, t_hi, f_lo, f_hi.  There is no padding marker: the last block is
zero-filled and told apart by ``t`` and ``f0`` alone.

The search layers speak 32-bit words, so each 64-bit word is a (lo, hi)
pair in little-endian order: the state is 16 words, a block's row 36
(32 message words, then the 4 parameter words), the digest the first 8.
``blake2b_256_compress`` is the plain torch version of what the CUDA
kernel (``csrc/blake2b.cuh``) computes, in operators only, so it also
runs on Python ints.  ``py_compress`` / ``py_absorb`` / ``py_digest`` are
the host-side twin on 64-bit ints.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

BLOCK_BYTES = 128
DIGEST_WORDS = 8           # 4 64-bit words
WORD_BYTEORDER = "little"
LENGTH_BYTEORDER = "little"  # no length field in the padding
STATE_WORDS = 16
ROUNDS = 12
PARAM_WORDS = 4            # t_lo, t_hi, f_lo, f_hi after the 32 message words

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1

BLAKE2B_IV: Tuple[int, ...] = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

# h[0] ^= 0x0101kknn: fanout 1, depth 1, no key, a 32-byte digest
BLAKE2B_INIT64: Tuple[int, ...] = (BLAKE2B_IV[0] ^ 0x01010020,) + BLAKE2B_IV[1:]
BLAKE2B_INIT: Tuple[int, ...] = tuple(
    w for v in BLAKE2B_INIT64 for w in (v & MASK32, v >> 32))

# The message schedule; rounds 10 and 11 reuse rows 0 and 1.
BLAKE2B_SIGMA: Tuple[Tuple[int, ...], ...] = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
)

# The lanes (a, b, c, d) of each G of a round: four columns, four diagonals.
G_LANES = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
           (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def block_param_words(absorbed: int, content: int, block_idx: int,
                      n_blocks: int) -> Tuple[int, int, int, int]:
    """The parameter words of tail block ``block_idx`` of ``n_blocks``:
    ``t``, the message bytes through this block (``absorbed`` before the
    tail, ``content`` in it; zero fill is not counted), and ``f0``, all
    ones on the last block.  The tail always holds the message's end, so
    which block is last is known when the template is built."""
    last = block_idx == n_blocks - 1
    t = absorbed + (content if last else (block_idx + 1) * BLOCK_BYTES)
    f = MASK32 if last else 0
    return t & MASK32, t >> 32, f, f


def _add(*pairs):
    """Sum of (lo, hi) pairs mod 2^64."""
    lo, hi = pairs[0]
    for p in pairs[1:]:
        lo, hi = lo + p[0], hi + p[1]
    return lo & MASK32, (hi + (lo >> 32)) & MASK32


def _rotr_xor(x, y, n: int):
    """Rotate ``x ^ y`` right by ``n`` (16, 24, 32 or 63), on (lo, hi) pairs."""
    lo, hi = x[0] ^ y[0], x[1] ^ y[1]
    if n >= 32:
        lo, hi, n = hi, lo, n - 32
    if n == 0:
        return lo, hi
    return ((lo >> n) | ((hi << (32 - n)) & MASK32),
            (hi >> n) | ((lo << (32 - n)) & MASK32))


def _g(v: List, a: int, b: int, c: int, d: int, x, y) -> None:
    v[a] = _add(v[a], v[b], x)
    v[d] = _rotr_xor(v[d], v[a], 32)
    v[c] = _add(v[c], v[d])
    v[b] = _rotr_xor(v[b], v[c], 24)
    v[a] = _add(v[a], v[b], y)
    v[d] = _rotr_xor(v[d], v[a], 16)
    v[c] = _add(v[c], v[d])
    v[b] = _rotr_xor(v[b], v[c], 63)


def blake2b_256_compress(state: Sequence, words: Sequence):
    """One BLAKE2b compression on (lo, hi) pairs of 32-bit words.

    ``state`` holds 16 ints or int64 tensors; ``words`` 36 broadcast-
    compatible ones: the block's 32 message words, then t_lo, t_hi, f_lo,
    f_hi.  Returns the new 16-word state."""
    h = [(state[2 * i], state[2 * i + 1]) for i in range(8)]
    m = [(words[2 * i], words[2 * i + 1]) for i in range(16)]
    v = h + [(iv & MASK32, iv >> 32) for iv in BLAKE2B_IV]
    v[12] = (v[12][0] ^ words[32], v[12][1] ^ words[33])  # t (its high 64 bits are 0)
    v[14] = (v[14][0] ^ words[34], v[14][1] ^ words[35])  # f0
    for r in range(ROUNDS):
        s = BLAKE2B_SIGMA[r]
        for gi, (a, b, c, d) in enumerate(G_LANES):
            _g(v, a, b, c, d, m[s[2 * gi]], m[s[2 * gi + 1]])
    return tuple(h[i][j] ^ v[i][j] ^ v[i + 8][j] for i in range(8) for j in (0, 1))


def _rotr64(v: int, n: int) -> int:
    return ((v >> n) | (v << (64 - n))) & MASK64


def blake2b_f(h: List[int], m: List[int], t: int, last: bool) -> List[int]:
    """One BLAKE2b compression on 64-bit ints: 8 state words, 16 message
    words, byte count ``t``, finalization flag ``last``."""
    v = list(h) + list(BLAKE2B_IV)
    v[12] ^= t & MASK64
    v[13] ^= t >> 64
    if last:
        v[14] ^= MASK64
    for r in range(ROUNDS):
        s = BLAKE2B_SIGMA[r]
        for gi, (a, b, c, d) in enumerate(G_LANES):
            x, y = m[s[2 * gi]], m[s[2 * gi + 1]]
            v[a] = (v[a] + v[b] + x) & MASK64
            v[d] = _rotr64(v[d] ^ v[a], 32)
            v[c] = (v[c] + v[d]) & MASK64
            v[b] = _rotr64(v[b] ^ v[c], 24)
            v[a] = (v[a] + v[b] + y) & MASK64
            v[d] = _rotr64(v[d] ^ v[a], 16)
            v[c] = (v[c] + v[d]) & MASK64
            v[b] = _rotr64(v[b] ^ v[c], 63)
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _lanes(data, n: int) -> List[int]:
    return [int.from_bytes(data[8 * i : 8 * i + 8], "little") for i in range(n)]


def py_compress(state: Tuple[int, ...], block: bytes, *, t: Optional[int] = None,
                last: Optional[bool] = None) -> Tuple[int, ...]:
    """Compress one block, on 64-bit ints; ``state`` and the result in the
    16-word (lo, hi) form.  ``block`` is either a template row as bytes
    (128 message bytes, then the 16 bytes of the parameter words; ``t``
    and ``last`` must not be given) or a plain 128-byte block, which needs
    an explicit ``t``: the bytes absorbed through it.  A counter left to a
    default would chain a multi-block input into a wrong digest without
    an error.  ``last`` defaults to False."""
    if len(block) == BLOCK_BYTES + 4 * PARAM_WORDS:
        if t is not None or last is not None:
            raise TypeError("a template row carries its t and f0; do not also pass t= or last=")
        t = int.from_bytes(block[128:136], "little")
        last = int.from_bytes(block[136:144], "little") != 0
    elif len(block) == BLOCK_BYTES:
        if t is None:
            raise TypeError("a plain 128-byte blake2b block needs t=, the bytes absorbed "
                            "through it")
        last = bool(last)
    else:
        raise ValueError(f"blake2b block must be {BLOCK_BYTES} or "
                         f"{BLOCK_BYTES + 4 * PARAM_WORDS} bytes, got {len(block)}")
    h = [state[2 * i] | (state[2 * i + 1] << 32) for i in range(8)]
    out = blake2b_f(h, _lanes(block, 16), t, last)
    return tuple(w for v in out for w in (v & MASK32, v >> 32))


def py_absorb(prefix: bytes) -> Tuple[Tuple[int, ...], bytes, int]:
    """Absorb every complete 128-byte block of ``prefix`` as a non-final
    block: every search candidate appends at least the thread byte, so no
    block of the nonce is the last.  ``(state, remainder, absorbed_len)``."""
    state = BLAKE2B_INIT
    n_full = len(prefix) // BLOCK_BYTES
    for i in range(n_full):
        state = py_compress(state, prefix[i * BLOCK_BYTES : (i + 1) * BLOCK_BYTES],
                            t=(i + 1) * BLOCK_BYTES)
    return state, prefix[n_full * BLOCK_BYTES :], n_full * BLOCK_BYTES


def py_digest(message: bytes) -> bytes:
    """BLAKE2b-256 of ``message`` via the pure-Python twin (oracle).  The
    whole message is at hand, so its last block, even a full one, is
    compressed as the final block."""
    n_before = max(0, (len(message) - 1) // BLOCK_BYTES)
    state = BLAKE2B_INIT
    for i in range(n_before):
        state = py_compress(state, message[i * BLOCK_BYTES : (i + 1) * BLOCK_BYTES],
                            t=(i + 1) * BLOCK_BYTES)
    rem = message[n_before * BLOCK_BYTES :]
    state = py_compress(state, rem + bytes(BLOCK_BYTES - len(rem)), t=len(message), last=True)
    return b"".join(w.to_bytes(4, "little") for w in state[:DIGEST_WORDS])
