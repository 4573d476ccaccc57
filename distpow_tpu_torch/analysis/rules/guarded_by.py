"""unguarded-shared-write — lock-guarded attributes must not be
written bare.

Every cross-thread capability in the tree — the worker task table,
the fleet lease map, the replicator queue set — is a plain attribute
whose only memory model is "hold the lock".  An attribute written
under ``with self._mu`` in one method and bare in another is a data
race waiting for a scheduler interleaving (the bug class most PR
review passes here have caught by hand: docs/CONCURRENCY.md).

Two tiers, both interprocedural (``analysis/concur.py``):

* **Discovered discipline**: an attribute written at least once with a
  lock held AND at least once bare (outside ``__init__``-like methods
  and freshly-constructed receivers) is flagged at each bare write.
  Reads are not flagged at this tier — too noisy for idioms like
  snapshot-read-then-act.
* **Declared discipline**: a ``# guarded-by: self._mu`` comment on the
  attribute's assignment or class-body annotation makes EVERY bare
  access — reads included — a hard finding.  Matching is by the
  lock's terminal name, so ``# guarded-by: registry._lock`` declares a
  cross-object guard.

"Under a lock" includes helper methods: a private method only ever
called with the lock held inherits it (entry-lock credit), and lock
aliases (``wlock = self._wlock``) count.  Deliberate invariants
(write-once before thread start, monotonic flags read locklessly) are
suppressed at the bare site with ``# distpow: ok
unguarded-shared-write -- <invariant>``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from .. import concur

RULE_ID = "unguarded-shared-write"
DESCRIPTION = (
    "attributes written under a lock (or declared # guarded-by) must "
    "not be accessed bare from other methods"
)


def check_project(modules, context) -> Iterator:
    model = concur.get_model(modules)
    by_mod = {m.path: m for m in modules}

    # aggregate accesses per (owner class, attr)
    groups: Dict[Tuple[str, str], List[concur.Access]] = {}
    for info in model.methods.values():
        for a in info.accesses:
            if a.fresh or a.method.name in concur.INIT_METHODS:
                continue
            groups.setdefault((a.owner, a.attr), []).append(a)

    for (owner, attr), accesses in sorted(groups.items()):
        guard = model.guard_for(owner, attr)
        cls_name = owner.split("::")[-1]
        if guard is not None:
            lock_name, decl_line = guard
            for a in accesses:
                held = model.held_effective(a)
                if any(lid[1].rstrip("()") == lock_name for lid in held):
                    continue
                mod = by_mod.get(a.method.module.path)
                if mod is None:
                    continue
                yield mod.finding(
                    RULE_ID, a.node,
                    f"{cls_name}.{attr} is declared guarded-by "
                    f"{lock_name} ({mod.path.rsplit('/', 1)[-1]}:"
                    f"{decl_line}) but is "
                    f"{'written' if a.write else 'read'} here with no "
                    f"matching lock held",
                )
            continue
        locked = [a for a in accesses
                  if a.write and model.held_effective(a)]
        bare = [a for a in accesses
                if a.write and not model.held_effective(a)]
        if not locked or not bare:
            continue
        sample = locked[0]
        lock = sorted(model.held_effective(sample))[0]
        for a in bare:
            mod = by_mod.get(a.method.module.path)
            if mod is None:
                continue
            yield mod.finding(
                RULE_ID, a.node,
                f"{cls_name}.{attr} is written under "
                f"{concur.fmt_lock(lock)} in {sample.method.short} "
                f"(line {sample.node.lineno}) but bare here in "
                f"{a.method.short}; hold the lock, or suppress with "
                f"the invariant that makes the lock-free write safe",
            )
