"""SHA-384: SHA-512's compression and padding from its own initial value,
with the digest cut to the first six of the eight 64-bit words (FIPS
180-4 section 5.3.4).

The state stays 16 32-bit words; the digest is its first 12
(``HashModel.state_to_digest`` takes the leading words), so the mask fold
reads trailing digest words 0..11 and never the last four state words.
"""

from __future__ import annotations

from typing import Tuple

from . import sha512
from .sha512 import BLOCK_BYTES, LENGTH_BYTEORDER, LENGTH_BYTES, WORD_BYTEORDER  # noqa: F401
from .sha512 import sha512_compress as sha384_compress  # noqa: F401
from .sha512 import py_compress  # noqa: F401

DIGEST_WORDS = 12  # 6 64-bit words

SHA384_INIT64 = (
    0xCBBB9D5DC1059ED8, 0x629A292A367CD507, 0x9159015A3070DD17,
    0x152FECD8F70E5939, 0x67332667FFC00B31, 0x8EB44A8768581511,
    0xDB0C2E0D64F98FA7, 0x47B5481DBEFA4FA4,
)
SHA384_INIT = sha512.split64(SHA384_INIT64)


def py_absorb(prefix: bytes) -> Tuple[Tuple[int, ...], bytes, int]:
    return sha512.py_absorb(prefix, SHA384_INIT)


def py_digest(message: bytes) -> bytes:
    return sha512.py_digest(message, SHA384_INIT, DIGEST_WORDS)
