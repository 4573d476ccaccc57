"""Worker capability advertisement (docs/FLEET.md "Capability").

What a worker tells the coordinator at registration time so shard
assignment can stop pretending the fleet is homogeneous (ROADMAP item
4; HashCore in PAPERS.md motivates capability-aware scheduling across
heterogeneous provers): the compute backend, the hash models it can
serve, a MEASURED hash rate from a short boot-time self-calibration,
and the batching scheduler's slot width.  The measured MH/s feeds the
capability-weighted prefix split (parallel/partition.py
``weighted_ranges``); the rest is operator-facing (``Fleet.Members``,
``stats --discover``) and reserved for future placement policy.

The port's own copy of the reference's ``fleet/capability.py``
(``distpow_tpu/fleet/capability.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional, Tuple

log = logging.getLogger("distpow.fleet")


@dataclass(frozen=True)
class Capability:
    """One worker's advertisement; travels as a plain dict on the wire
    (both codecs encode dicts natively, so no schema machinery)."""

    backend: str = "python"
    hash_models: Tuple[str, ...] = ("md5",)
    #: measured hash rate in MH/s; 0.0 = unknown (calibration skipped
    #: or failed) — an unknown rate makes the whole plan fall back to
    #: the reference equal split (membership.py round_plan)
    mhs: float = 0.0
    #: batching-scheduler slot width (WorkerConfig.SchedMaxSlots); 0 =
    #: no batching scheduler
    max_slots: int = 0

    def to_wire(self) -> dict:
        return {
            "backend": self.backend,
            "hash_models": list(self.hash_models),
            "mhs": float(self.mhs),
            "max_slots": int(self.max_slots),
        }

    @classmethod
    def from_wire(cls, d: Optional[dict]) -> "Capability":
        d = d or {}
        return cls(
            backend=str(d.get("backend") or "unknown"),
            hash_models=tuple(str(m) for m in (d.get("hash_models") or ())),
            mhs=max(0.0, float(d.get("mhs") or 0.0)),
            max_slots=int(d.get("max_slots") or 0),
        )


def calibrate_mhs(backend: object, budget_s: float = 0.2,
                  nonce: bytes = b"\xfc\x01", difficulty: int = 8) -> float:
    """Measure the backend's hash rate with a short budgeted search.

    Runs ``backend.search`` over the full first-byte space at a
    satisfiable-but-hard difficulty (md5 at ntz=8 is ~16^-8 per
    candidate — statistically unreachable inside the budget, but every
    candidate is hashed and counted, unlike an UNSATISFIABLE difficulty
    which the serving path parks without hashing) and reads the
    ``search.hashes`` counter delta around it.  The counter is
    process-global, so a calibration racing live traffic reads high —
    acceptable for an ADVERTISEMENT (this runs once at boot, before the
    worker registers), and the weighted split degrades gracefully:
    weights shift shares, they never drop coverage.

    Best-effort by contract: any failure (a backend without the counter
    discipline, a compile error, a zero-length budget) returns 0.0 —
    "unknown", which keeps the fleet on the reference equal split
    rather than poisoning it with a garbage weight.
    """
    if budget_s <= 0:
        return 0.0
    from ..runtime.metrics import REGISTRY as metrics

    deadline = time.monotonic() + budget_s
    try:
        before = metrics.get("search.hashes")
        t0 = time.monotonic()
        backend.search(
            bytes(nonce), int(difficulty), list(range(256)),
            cancel_check=lambda: time.monotonic() >= deadline,
        )
        elapsed = time.monotonic() - t0
        hashed = metrics.get("search.hashes") - before
        if elapsed <= 0 or hashed <= 0:
            return 0.0
        return round(hashed / elapsed / 1e6, 4)
    except Exception as exc:  # calibration must never kill worker boot
        log.warning("self-calibration failed (%s); advertising unknown "
                    "rate", exc)
        return 0.0
