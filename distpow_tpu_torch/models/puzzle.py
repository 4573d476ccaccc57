"""Core proof-of-work puzzle semantics (pure Python).

The contract (reference: worker.go:353-356): given ``nonce`` and
``num_trailing_zeros``, find ``secret`` such that the lowercase hex of
``md5(nonce + secret)`` ends in at least ``num_trailing_zeros`` ``'0'``
characters.  The difficulty counts trailing zero nibbles of the digest.

Secrets are enumerated as ``bytes([thread_byte]) + chunk`` where the
chunk counter walks the minimal little-endian encodings of 0, 1, 2, ...
and, for each chunk value, every thread byte of the worker is tried in
ascending order (worker.go:234-244, 301-319).  That integer <-> chunk
bijection lets a kernel map a flat index to a candidate arithmetically.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Iterator, Optional, Sequence, Tuple


class _DoubleSha256:
    """hashlib-shaped sha256(sha256(.)), Bitcoin's proof-of-work digest."""

    name = "sha256d"
    digest_size = 32

    def __init__(self, data: bytes = b""):
        self._inner = hashlib.sha256(data)

    def update(self, data: bytes) -> None:
        self._inner.update(data)

    def digest(self) -> bytes:
        return hashlib.sha256(self._inner.digest()).digest()

    def hexdigest(self) -> str:
        return self.digest().hex()

    def copy(self) -> "_DoubleSha256":
        c = _DoubleSha256()
        c._inner = self._inner.copy()
        return c


def new_hash(algo: str):
    """``hashlib.new(algo)``, for every model the port serves.

    sha256d is a composition that hashlib has no name for, and blake2b_256
    is ``blake2b`` at a 32-byte digest.  ripemd160 is outside hashlib's
    guaranteed set: an OpenSSL 3 build without its legacy provider raises
    for it, and then the pure-Python ``Ripemd160`` stands in.  Every
    verification path hashes through here."""
    if algo == "sha256d":
        return _DoubleSha256()
    if algo == "blake2b_256":
        return hashlib.blake2b(digest_size=32)
    try:
        return hashlib.new(algo)
    except ValueError:
        if algo == "ripemd160":
            from .ripemd160 import Ripemd160

            return Ripemd160()
        raise


def hash_hex(nonce: bytes, secret: bytes, algo: str = "md5") -> str:
    """Lowercase hex digest of ``algo(nonce + secret)`` (worker.go:353-355)."""
    h = new_hash(algo)
    h.update(bytes(nonce) + bytes(secret))
    return h.hexdigest()


def count_trailing_zero_chars(s: str) -> int:
    """Number of trailing ``'0'`` characters of ``s`` (worker.go:246-256)."""
    return len(s) - len(s.rstrip("0"))


def count_trailing_zero_nibbles(digest: bytes) -> int:
    """Trailing zero nibbles of a raw digest, the same count as
    ``count_trailing_zero_chars(digest.hex())``: low nibble of the last
    byte first, then its high nibble, then the byte before."""
    n = 0
    for b in reversed(digest):
        if b == 0:
            n += 2
            continue
        if b & 0x0F == 0:
            n += 1
        break
    return n


def check_secret(
    nonce: bytes, secret: bytes, num_trailing_zeros: int, algo: str = "md5"
) -> bool:
    """True iff ``secret`` solves the puzzle (worker.go:353-356)."""
    h = new_hash(algo)
    h.update(bytes(nonce) + bytes(secret))
    return count_trailing_zero_nibbles(h.digest()) >= num_trailing_zeros


def next_chunk(chunk: bytearray) -> bytearray:
    """Advance the append-carry chunk counter in place (worker.go:234-244)."""
    for i in range(len(chunk)):
        if chunk[i] == 0xFF:
            chunk[i] = 0
        else:
            chunk[i] += 1
            return chunk
    chunk.append(1)
    return chunk


def chunk_to_int(chunk: bytes) -> int:
    """Little-endian integer value of a chunk."""
    return int.from_bytes(chunk, "little")


def int_to_chunk(n: int) -> bytes:
    """Minimal little-endian encoding of ``n``; 0 is the empty chunk."""
    if n == 0:
        return b""
    return n.to_bytes((n.bit_length() + 7) // 8, "little")


def chunk_width(n: int) -> int:
    """Byte width of ``int_to_chunk(n)``."""
    return 0 if n == 0 else (n.bit_length() + 7) // 8


def iter_candidates(
    thread_bytes: Sequence[int], start: int = 0
) -> Iterator[Tuple[int, int, bytes]]:
    """Yield ``(chunk_int, thread_byte, secret)`` in reference order."""
    n = start
    while True:
        chunk = int_to_chunk(n)
        for tb in thread_bytes:
            yield n, tb, bytes([tb]) + chunk
        n += 1


def python_search(
    nonce: bytes,
    num_trailing_zeros: int,
    thread_bytes: Sequence[int],
    algo: str = "md5",
    start_chunk: int = 0,
    max_candidates: Optional[int] = None,
    cancel_check: Optional[Callable[[], bool]] = None,
    cancel_poll_interval: int = 4096,
    on_progress: Optional[Callable[[int], None]] = None,
    on_exit: Optional[Callable[[str], None]] = None,
) -> Optional[bytes]:
    """Reference-order brute force with hashlib: the behavioural oracle
    for every accelerated path (worker.go:318-400).

    Returns the first solving secret, or None when ``max_candidates`` is
    exhausted or ``cancel_check`` fires.  ``on_progress(n)`` receives the
    candidates hashed and ``on_exit(reason)`` one of ``"found"``,
    ``"cancelled"``, ``"exhausted"`` before every return.
    """
    nonce = bytes(nonce)
    tried = 0

    def done(result, reason):
        if on_progress is not None:
            on_progress(tried)
        if on_exit is not None:
            on_exit(reason)
        return result

    for _, _, secret in iter_candidates(thread_bytes, start=start_chunk):
        if cancel_check is not None and tried % cancel_poll_interval == 0:
            if cancel_check():
                return done(None, "cancelled")
        if max_candidates is not None and tried >= max_candidates:
            return done(None, "exhausted")
        tried += 1
        h = new_hash(algo)
        h.update(nonce)
        h.update(secret)
        if count_trailing_zero_nibbles(h.digest()) >= num_trailing_zeros:
            return done(secret, "found")
    return done(None, "exhausted")
