"""Whether a run is correct: every number here has to be at or below its
limit, and every limit is 0 (an exact comparison).

Over the puzzles sent in the window, each judged by the plain reference
(``reference.py``) once the window has closed and the processes are gone:

* ``unanswered``: no result a minute after the window closed;
* ``errors``: the client library delivered an error;
* ``bad_secrets``: the secret does not solve its puzzle.

Over the run's protocol, from every node's counters once every puzzle is
answered (each round fans a Mine out to every worker, sends every worker
``Found``, and waits for two messages from each, plus one for each
repeated ``Found``):

* ``fanout_short``: over the workers, how far each one's Mines miss the
  coordinator's rounds (``coord.fanouts`` against ``worker.mine_rpcs``);
* ``found_short``: rounds whose ``Found`` a worker never received;
* ``ack_short``: over the workers, how far the messages each one sent
  miss one a Mine and one a ``Found``.

Over a sample of the window's answers, with the worker that won each from
the coordinator's ``coord.first_result`` span:

* ``partition_misses``: the secret's first byte is not one the winning
  worker owns under the coordinator's prefix split.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .reference import first_bytes, solves as _solves


def solves(config: dict, sent) -> bool:
    return (sent.t1 is not None and sent.error is None and sent.secret is not None
            and _solves(config["hash_model"], sent.nonce, sent.secret, sent.ntz))


def judge(config: dict, window: list, coordinator: dict, workers: List[dict],
          winners: List[Tuple[bytes, int]]) -> Dict[str, dict]:
    n = int(config["Workers"])
    answered = [s for s in window if s.t1 is not None]
    fanouts = coordinator["counters"].get("coord.fanouts", 0)
    counts = [{k: w["counters"].get(f"worker.{k}", 0)
               for k in ("mine_rpcs", "found_rpcs", "results_sent")} for w in workers]
    values = {
        "unanswered": len(window) - len(answered),
        "errors": sum(1 for s in answered if s.error is not None),
        "bad_secrets": sum(1 for s in answered if s.error is None and not solves(config, s)),
        "fanout_short": sum(abs(fanouts - c["mine_rpcs"]) for c in counts),
        "found_short": sum(max(0, c["mine_rpcs"] - c["found_rpcs"]) for c in counts),
        "ack_short": sum(abs(c["mine_rpcs"] + c["found_rpcs"] - c["results_sent"])
                         for c in counts),
        "partition_misses": sum(1 for secret, w in winners
                                if not 0 <= w < n or secret[0] not in first_bytes(w, n)),
    }
    return {name: {"value": v, "limit": 0} for name, v in values.items()}
