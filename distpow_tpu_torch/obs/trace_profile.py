"""Per-round critical path of the coordinator's Mines, in wall-clock
seconds: the SLO engine's breach dump attaches it (``obs/slo.py``).

The port's own copy of the part of the reference's
``scripts/trace_profile.py`` that the engine loads from the repo root by
path: :func:`profile_journal`, the flight-recorder journal's rounds.
Inside the package, a breach dump finds its critical path without a file
outside it.  One row a fan-out round, in the order the rounds began::

    {"round", "nonce", "ntz", "fanout_ts", "first_result_s",
     "winner_byte", "cancel_propagation_s", "late_results"}
"""

from __future__ import annotations

import json
from typing import Dict, List


def profile_journal(path: str) -> List[dict]:
    """Flight-recorder JSONL -> per-round wall-clock stage timings."""
    rounds: Dict[str, dict] = {}
    order: List[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            kind = ev.get("kind", "")
            rid = ev.get("round")
            if not kind.startswith("coord.") or rid is None:
                continue
            r = rounds.get(rid)
            if r is None:
                r = rounds[rid] = {"round": rid, "nonce": ev.get("nonce"),
                                   "ntz": ev.get("ntz")}
                order.append(rid)
            if kind == "coord.fanout":
                r["fanout_ts"] = ev.get("ts")
            elif kind == "coord.first_result":
                r["first_result_s"] = ev.get("latency_s")
                r["winner_byte"] = ev.get("worker_byte")
            elif kind == "coord.cancel_complete":
                r["cancel_propagation_s"] = ev.get("latency_s")
                r["late_results"] = ev.get("late_results")
    return [rounds[rid] for rid in order]
