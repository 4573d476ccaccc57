"""transitive-blocking-under-lock — a helper that blocks is a
blocking call.

``no-blocking-under-lock`` is deliberately lexical: ``with self._lock:
self._flush()`` passes it even when ``_flush`` ends in ``sendall``.
This rule closes the indirection hole with the shared call-graph
summaries (``analysis/concur.py``): a call made while a lock is held
whose callee reaches a known blocking operation — RPC ``.call``,
socket send, ``sleep``, event/condition ``wait``, fsync, subprocess —
within ≤3 call hops is flagged at the call site, naming the chain.

Two deliberate seams with the direct rule:

* a call the direct rule already flags (the call itself IS a blocking
  name) is skipped here — one finding per site, never two;
* a DIRECT blocking call under a lock the direct rule cannot see
  (held via a discovered lock whose name is not lock-ish, e.g. a
  ``Condition`` named ``_cond``) is flagged here instead.

Fix by moving the call outside the critical section (snapshot under
the lock, act after release — the tree's standard shape), or suppress
at the call site with the invariant that bounds the hold.
"""

from __future__ import annotations

from typing import Iterator

from .. import concur
from .blocking_under_lock import _blocking_reason

RULE_ID = "transitive-blocking-under-lock"
DESCRIPTION = (
    "no call chain (≤3 hops) that reaches blocking I/O, sleep, or "
    "subprocess work while a threading lock is held"
)


def check_project(modules, context) -> Iterator:
    model = concur.get_model(modules)
    by_mod = {m.path: m for m in modules}
    for info in model.methods.values():
        for c in info.calls:
            if not c.held:
                continue
            if _blocking_reason(c.node):
                continue  # the direct rule's finding, not ours
            hit = model.block_depth.get(c.callee)
            if hit is None:
                continue
            hops, chain, reason = hit
            if hops > concur.CALL_DEPTH:
                continue
            held = sorted(c.held)
            chain_s = " -> ".join(q.split("::")[-1] for q in chain)
            mod = by_mod.get(info.module.path)
            if mod is None:
                continue
            yield mod.finding(
                RULE_ID, c.node,
                f"call to {chain[0].split('::')[-1]} while holding "
                f"{concur.fmt_lock(held[0])} reaches blocking work in "
                f"{hops} hop{'s' if hops > 1 else ''} "
                f"({chain_s}: {reason}); move it outside the critical "
                f"section or suppress with the bounding invariant",
            )
        for b in info.blocking:
            if not b.held or b.lock_named_hold or b.self_wait:
                continue  # bare, direct-rule territory, or cond-wait
            held = sorted(b.held)
            mod = by_mod.get(info.module.path)
            if mod is None:
                continue
            yield mod.finding(
                RULE_ID, b.node,
                f"{b.reason} while holding {concur.fmt_lock(held[0])} "
                f"(a discovered lock the lexical rule cannot name); "
                f"move it outside the critical section or suppress "
                f"with the bounding invariant",
            )
