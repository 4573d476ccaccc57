"""Hash-model registry (the MD5 slice).

A ``HashModel`` bundles what packing and the search step read.  The
reference registry has nine models; this port serves MD5 and raises for
the other eight, which are queued in ROADMAP.md (Queue 2 C-I).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

from . import md5

# Queued for later slices of the port (ROADMAP.md Queue 2 C-I).
NOT_YET_PORTED = ("sha256", "sha256d", "sha1", "ripemd160", "sha512",
                  "sha384", "sha3_256", "blake2b_256")


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
    # reference point of that scale.
    cost_ops: int
    length_bytes: int = 8

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


def get_hash_model(name: str) -> HashModel:
    key = name.lower()
    if key == "md5":
        return MD5
    if key in NOT_YET_PORTED:
        raise ValueError(
            f"hash model {name!r} is not ported yet: it is queued in "
            f"ROADMAP.md (Queue 2, the other eight tiles); this port serves md5"
        )
    raise ValueError(f"unknown hash model {name!r}; available: ['md5']")
