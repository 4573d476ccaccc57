"""Hash-model registry.

A ``HashModel`` bundles what packing and the search step read.  The port
serves the reference registry's nine models, each with a CUDA kernel: md5,
sha256, sha256d, sha1, ripemd160, sha512, sha384, sha3_256 and blake2b_256.
The 64-bit hashes carry each 64-bit word as a pair of 32-bit words, so
every layer above the models speaks 32-bit words only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

from . import blake2b, md5, ripemd160, sha1, sha3, sha256, sha256d, sha384, sha512


@dataclass(frozen=True)
class HashModel:
    name: str
    block_bytes: int
    digest_words: int          # uint32 words in the digest
    word_byteorder: str        # how digest words map to digest bytes
    length_byteorder: str      # byte order of the bit-length field
    init_state: Tuple[int, ...]
    compress: Callable         # (state, row words) -> state, int64-carried torch
    py_absorb: Callable        # prefix -> (state, remainder, absorbed_len)
    # Compute cost per hash that scales the per-dispatch launch budget
    # (parallel/search.py scaled_launch_candidates); md5 is the
    # reference point of that scale.  The reference registry's operation
    # counts, carried over as they are.
    cost_ops: int
    # Bytes of the bit-length field of the "md" padding: 16 for sha512/384.
    length_bytes: int = 8
    # Padding family (ops/packing.py build_tail_spec): "md" (0x80, zeros,
    # the bit length), "sha3" (0x06 after the message and 0x80 into the
    # last rate byte, one 0x86 byte when they meet) or "blake2" (zero fill;
    # the parameter words mark the end).
    padding: str = "md"
    # Words appended to each tail block's row after the message words, the
    # compression's parameters (blake2b's byte count t and finalization
    # word f0), from ``block_param_words(absorbed, content, block, n_blocks)``.
    param_words: int = 0
    block_param_words: Optional[Callable] = None
    # Hash composition (sha256d): a state -> state stage the search step
    # applies after the last compress and before the difficulty check;
    # packing never sees it.  ``py_finalize`` is its pure-Python twin.
    finalize: Optional[Callable] = None
    py_finalize: Optional[Callable] = None

    @property
    def digest_bytes(self) -> int:
        return self.digest_words * 4

    @property
    def words_per_block(self) -> int:
        return self.block_bytes // 4

    @property
    def row_words(self) -> int:
        """Words of one tail block's row: message words, then parameters."""
        return self.words_per_block + self.param_words

    @property
    def max_difficulty(self) -> int:
        """Digest nibble count: higher difficulties are unsatisfiable."""
        return self.digest_bytes * 2

    def state_to_digest(self, state: Sequence[int]) -> bytes:
        return b"".join(
            int(w).to_bytes(4, self.word_byteorder)
            for w in state[: self.digest_words]
        )


MD5 = HashModel(
    name="md5",
    block_bytes=md5.BLOCK_BYTES,
    digest_words=md5.DIGEST_WORDS,
    word_byteorder=md5.WORD_BYTEORDER,
    length_byteorder=md5.LENGTH_BYTEORDER,
    init_state=md5.MD5_INIT,
    compress=md5.md5_compress,
    py_absorb=md5.py_absorb,
    cost_ops=584,
)

SHA256 = HashModel(
    name="sha256",
    block_bytes=sha256.BLOCK_BYTES,
    digest_words=sha256.DIGEST_WORDS,
    word_byteorder=sha256.WORD_BYTEORDER,
    length_byteorder=sha256.LENGTH_BYTEORDER,
    init_state=sha256.SHA256_INIT,
    compress=sha256.sha256_compress,
    py_absorb=sha256.py_absorb,
    cost_ops=2909,
)

SHA256D = HashModel(
    name="sha256d",
    block_bytes=sha256.BLOCK_BYTES,
    digest_words=sha256.DIGEST_WORDS,
    word_byteorder=sha256.WORD_BYTEORDER,
    length_byteorder=sha256.LENGTH_BYTEORDER,
    init_state=sha256.SHA256_INIT,
    compress=sha256.sha256_compress,
    py_absorb=sha256.py_absorb,
    cost_ops=6074,
    finalize=sha256d.sha256d_finalize,
    py_finalize=sha256d.py_finalize,
)

SHA1 = HashModel(
    name="sha1",
    block_bytes=sha1.BLOCK_BYTES,
    digest_words=sha1.DIGEST_WORDS,
    word_byteorder=sha1.WORD_BYTEORDER,
    length_byteorder=sha1.LENGTH_BYTEORDER,
    init_state=sha1.SHA1_INIT,
    compress=sha1.sha1_compress,
    py_absorb=sha1.py_absorb,
    cost_ops=1341,
)

RIPEMD160 = HashModel(
    name="ripemd160",
    block_bytes=ripemd160.BLOCK_BYTES,
    digest_words=ripemd160.DIGEST_WORDS,
    word_byteorder=ripemd160.WORD_BYTEORDER,
    length_byteorder=ripemd160.LENGTH_BYTEORDER,
    init_state=ripemd160.RIPEMD160_INIT,
    compress=ripemd160.ripemd160_compress,
    py_absorb=ripemd160.py_absorb,
    cost_ops=1854,
)

SHA512 = HashModel(
    name="sha512",
    block_bytes=sha512.BLOCK_BYTES,
    digest_words=sha512.DIGEST_WORDS,
    word_byteorder=sha512.WORD_BYTEORDER,
    length_byteorder=sha512.LENGTH_BYTEORDER,
    init_state=sha512.SHA512_INIT,
    compress=sha512.sha512_compress,
    py_absorb=sha512.py_absorb,
    cost_ops=9782,
    length_bytes=sha512.LENGTH_BYTES,
)

SHA384 = HashModel(
    name="sha384",
    block_bytes=sha384.BLOCK_BYTES,
    digest_words=sha384.DIGEST_WORDS,  # 12 of the 16 state words
    word_byteorder=sha384.WORD_BYTEORDER,
    length_byteorder=sha384.LENGTH_BYTEORDER,
    init_state=sha384.SHA384_INIT,
    compress=sha384.sha384_compress,
    py_absorb=sha384.py_absorb,
    cost_ops=9782,
    length_bytes=sha384.LENGTH_BYTES,
)

SHA3_256 = HashModel(
    name="sha3_256",
    block_bytes=sha3.BLOCK_BYTES,      # the rate
    digest_words=sha3.DIGEST_WORDS,    # 8 of the 50 state words
    word_byteorder=sha3.WORD_BYTEORDER,
    length_byteorder=sha3.LENGTH_BYTEORDER,
    init_state=sha3.SHA3_INIT,
    compress=sha3.sha3_256_compress,
    py_absorb=sha3.py_absorb,
    cost_ops=9900,
    padding="sha3",
)

BLAKE2B_256 = HashModel(
    name="blake2b_256",
    block_bytes=blake2b.BLOCK_BYTES,
    digest_words=blake2b.DIGEST_WORDS,  # 8 of the 16 state words
    word_byteorder=blake2b.WORD_BYTEORDER,
    length_byteorder=blake2b.LENGTH_BYTEORDER,
    init_state=blake2b.BLAKE2B_INIT,
    compress=blake2b.blake2b_256_compress,
    py_absorb=blake2b.py_absorb,
    cost_ops=5205,
    padding="blake2",
    param_words=blake2b.PARAM_WORDS,
    block_param_words=blake2b.block_param_words,
)

_REGISTRY = {m.name: m for m in (MD5, SHA256, SHA256D, SHA1, RIPEMD160, SHA512, SHA384,
                                 SHA3_256, BLAKE2B_256)}


def get_hash_model(name: str) -> HashModel:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown hash model {name!r}; available: {sorted(_REGISTRY)}") from None
