"""Hash-model registry.

A ``HashModel`` bundles what packing and the search step read.  The
reference registry has nine models; this port serves md5, sha256, sha256d,
sha1 and ripemd160, each with a CUDA kernel, and raises for the other
four, which are queued in ROADMAP.md (Queue 2 G-I).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

from . import md5, ripemd160, sha1, sha256, sha256d

# Queued for later slices of the port (ROADMAP.md Queue 2 G-I).
NOT_YET_PORTED = ("sha512", "sha384", "sha3_256", "blake2b_256")


@dataclass(frozen=True)
class HashModel:
    name: str
    block_bytes: int
    digest_words: int          # uint32 words in the digest
    word_byteorder: str        # how digest words map to digest bytes
    length_byteorder: str      # byte order of the bit-length field
    init_state: Tuple[int, ...]
    compress: Callable         # (state, words[16]) -> state, int64-carried torch
    py_absorb: Callable        # prefix -> (state, remainder, absorbed_len)
    # Compute cost per hash that scales the per-dispatch launch budget
    # (parallel/search.py scaled_launch_candidates); md5 is the
    # reference point of that scale.  The reference registry's operation
    # counts, carried over as they are.
    cost_ops: int
    length_bytes: int = 8
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

_REGISTRY = {m.name: m for m in (MD5, SHA256, SHA256D, SHA1, RIPEMD160)}


def get_hash_model(name: str) -> HashModel:
    key = name.lower()
    if key in _REGISTRY:
        return _REGISTRY[key]
    if key in NOT_YET_PORTED:
        raise ValueError(
            f"hash model {name!r} is not ported yet: it is queued in "
            f"ROADMAP.md (Queue 2 G-I); this port serves {sorted(_REGISTRY)}"
        )
    raise ValueError(f"unknown hash model {name!r}; available: {sorted(_REGISTRY)}")
