"""The one traffic generator: a mix's data file in, the run's requests out.

A mix (``traffic/<name>.json``) is parameters only, every one of them
required:

* ``source``: where the mix's shape comes from, in one line;
* ``clients``: a closed loop of that many callers, each sending its next
  request when its last one is answered;
* ``nonce_len`` and ``difficulties``, a blend ``[[ntz, weight], ...]``;
* ``pool_seed``: the requests are drawn from one fixed sequence of puzzles
  that every seed shares.  Entry ``i`` is ``key_nonce(pool_seed, i)`` at a
  difficulty drawn from the blend by ``i`` alone.  The loop sends the
  sequence in blocks of ``block`` entries, each block shuffled by the run's
  seed: every seed sends the same puzzles in another order, so a window's
  work (the position of each puzzle's first hit) does not change with the
  seed;
* ``warmup``: ``{"requests": n}``, puzzles of the same blend from the
  pool's own warm-up namespace, sent before the window, ``clients`` at a
  time.

``key_nonce`` and the blend draw are copied from the port's
``load/loadgen.py`` (``key_nonce``, ``_cum_weights``, ``_pick``), so that
a change to the program cannot move the yardstick.
"""

from __future__ import annotations

import hashlib
import random
from bisect import bisect_left
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

KEYS = {"source", "clients", "nonce_len", "difficulties", "pool_seed", "block", "warmup"}


@dataclass(frozen=True)
class Request:
    nonce: bytes
    ntz: int


# --- copied from load/loadgen.py --------------------------------------------

def key_nonce(seed, key: int, nonce_len: int) -> bytes:
    """Deterministic per-key nonce (load/loadgen.py ``key_nonce``)."""
    digest = hashlib.sha256(f"loadgen:{seed}:{key}".encode()).digest()
    return digest[:nonce_len]


def _cum_weights(blend: Sequence[Tuple[object, float]]) -> List[float]:
    total = 0.0
    out = []
    for _, w in blend:
        total += float(w)
        out.append(total)
    return out


def _pick(cdf: List[float], rng: random.Random) -> int:
    return bisect_left(cdf, rng.random() * cdf[-1])

# -----------------------------------------------------------------------------


class Mix:
    """One traffic mix, read from its data file."""

    def __init__(self, params: dict):
        if set(params) != KEYS:
            raise ValueError(f"a mix has the keys {sorted(KEYS)}; "
                             f"this one has {sorted(params)}")
        self.source = params["source"]
        self.clients = int(params["clients"])
        self.nonce_len = int(params["nonce_len"])
        self.difficulties = [(int(d), float(w)) for d, w in params["difficulties"]]
        if not self.difficulties or any(w <= 0 for _, w in self.difficulties):
            raise ValueError("difficulties needs positive-weight entries")
        self.pool_seed = params["pool_seed"]
        self.block = int(params["block"])
        self.warmup_requests = int(params["warmup"]["requests"])
        if self.clients < 1 or self.block < 1 or self.nonce_len < 1:
            raise ValueError("clients, block and nonce_len must be >= 1")
        self._cum = _cum_weights(self.difficulties)

    def entry(self, space: str, i: int) -> Request:
        """Entry ``i`` of the pool (``space`` "pool") or of its warm-up
        namespace ("warm"): the same for every seed."""
        rng = random.Random(f"ntz:{space}:{self.pool_seed}:{i}")
        ntz = self.difficulties[_pick(self._cum, rng)][0]
        return Request(key_nonce(f"{space}:{self.pool_seed}", i, self.nonce_len), ntz)

    def warmup(self) -> List[Request]:
        return [self.entry("warm", i) for i in range(self.warmup_requests)]

    def closed(self, seed: int) -> Iterator[Request]:
        """The requests, in the seed's order, without end."""
        b = 0
        while True:
            idx = list(range(b * self.block, (b + 1) * self.block))
            random.Random(f"order:{seed}:{b}").shuffle(idx)
            for i in idx:
                yield self.entry("pool", i)
            b += 1
