"""Runtime lock-order audit — the dynamic twin of the static
``lock-order-inversion`` rule (docs/CONCURRENCY.md).

The port's own copy of the reference's ``runtime/lockcheck.py``
(``distpow_tpu/runtime/lockcheck.py``): stdlib-only, so it loads by file
path before anything imports the port (module-level singletons build
their locks at import), and importing it the normal way pulls in no
``torch`` either.

The static rule sees lexical nesting and bounded call summaries; this
module sees what the process actually did.  With ``DISTPOW_LOCK_CHECK=1``
(and an explicit :func:`install`), the ``threading.Lock`` / ``RLock`` /
``Condition`` factories are replaced with wrappers that tag each lock
with its construction site.  Only locks constructed from files under
this repository are instrumented — torch, the stdlib, and third-party
locks pass through untouched, so the audit never perturbs code it
cannot fix.

Every acquisition records, per thread, the set of already-held
instrumented locks; each (held-site → acquired-site) pair becomes an
edge in a global acquisition-order graph, aggregated by construction
site (not lock instance — ten per-key locks made on one line are one
node, matching the static model's ``LockId`` granularity).  Held
durations are accumulated per site as a cheap contention profile.

:func:`check` condenses the observed graph: any strongly-connected
component of two or more sites is an *observed inversion* — two
threads really did take those locks in opposite orders, which is a
latent deadlock even if the run happened not to hang.  The port's
``tools/lock_audit.py`` fails on a non-empty report.

Design notes:

* ``RLock`` re-entry pushes a re-entrant marker and records no edges —
  re-acquiring a lock you hold orders nothing.
* ``Condition.wait`` needs no special casing: the condition delegates
  ``_release_save`` / ``_acquire_restore`` straight to the inner lock
  (via ``__getattr__``), so the bookkeeping stack shows the lock held
  across the wait — exactly the window in which the blocked thread can
  acquire nothing, so no spurious edges are possible.
* The audit's own bookkeeping uses a pre-patch ``threading.Lock`` so it
  never instruments itself.
* One audit per process: :func:`install` refuses, with a RuntimeError,
  when ``threading``'s factories are not the stdlib's (another audit,
  such as the reference's, is installed, or was when this module was
  imported) — stacked on another audit this one would take that audit's
  proxies for the real factories.
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass, field
from time import monotonic
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "enabled", "install", "uninstall", "reset", "check",
    "format_report", "stats", "Report",
]

ENV_FLAG = "DISTPOW_LOCK_CHECK"

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_THIS_FILE = os.path.abspath(__file__)

# real factories, captured at import time — the audit's own state uses
# these so instrumentation never recurses into itself
_real_Lock = threading.Lock
_real_RLock = threading.RLock
_real_Condition = threading.Condition

_state_lock = _real_Lock()
# (held_site, acquired_site) -> observation count
_edges: Dict[Tuple[str, str], int] = {}
# site -> [acquisitions, total_held_s, max_held_s]
_held: Dict[str, List[float]] = {}
_tls = threading.local()
_installed = False


def _stdlib_factories(lock: object, rlock: object, cond: object) -> bool:
    """True when the three factories are the stdlib's own: ``Lock`` from
    ``_thread``, ``RLock`` and ``Condition`` from ``threading``."""
    return (getattr(lock, "__module__", None) == "_thread"
            and getattr(rlock, "__module__", None) == "threading"
            and getattr(cond, "__module__", None) == "threading")


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "") == "1"


def _construction_site() -> Optional[str]:
    """Repo-relative ``path:line`` of the frame that constructed the
    lock, or ``None`` when the construction site is outside this
    repository (→ the lock stays uninstrumented)."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.abspath(fn) != _THIS_FILE:
            break
        f = f.f_back
    if f is None:
        return None
    fn = os.path.abspath(f.f_code.co_filename)
    if not fn.startswith(_ROOT + os.sep):
        return None
    return f"{os.path.relpath(fn, _ROOT)}:{f.f_lineno}"


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _LockProxy:
    """Construction-site-tagged wrapper around a real lock.

    Everything not explicitly intercepted delegates to the inner lock,
    which is what lets ``threading.Condition`` drive an RLock-backed
    proxy correctly (``_release_save`` et al. resolve via
    ``__getattr__``)."""

    def __init__(self, inner: object, site: str) -> None:
        self._inner = inner
        self._site = site

    # -- bookkeeping ---------------------------------------------------------
    def _note_acquired(self) -> None:
        st = _stack()
        reentrant = any(e[0] is self for e in st)
        if not reentrant and st:
            held_sites = {e[0]._site for e in st}
            held_sites.discard(self._site)  # same-line sibling locks
            with _state_lock:
                for hs in held_sites:
                    key = (hs, self._site)
                    _edges[key] = _edges.get(key, 0) + 1
        st.append((self, monotonic(), reentrant))

    def _note_released(self) -> None:
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] is self:
                _, t0, reentrant = st.pop(i)
                if not reentrant:
                    dt = monotonic() - t0
                    with _state_lock:
                        rec = _held.setdefault(self._site, [0, 0.0, 0.0])
                        rec[0] += 1
                        rec[1] += dt
                        if dt > rec[2]:
                            rec[2] = dt
                return

    # -- lock protocol -------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        self._note_released()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, name: str) -> object:
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"<lockcheck proxy {self._site} of {self._inner!r}>"


def _wrap(inner: object, site: Optional[str]) -> object:
    return inner if site is None else _LockProxy(inner, site)


def _lock_factory() -> object:
    return _wrap(_real_Lock(), _construction_site())


def _rlock_factory() -> object:
    return _wrap(_real_RLock(), _construction_site())


def _condition_factory(lock: object = None) -> threading.Condition:
    site = _construction_site()
    if lock is None:
        lock = _wrap(_real_RLock(), site)
    elif not isinstance(lock, _LockProxy):
        # caller-supplied foreign lock: tag it with the condition's site
        lock = _wrap(lock, site)
    return _real_Condition(lock)


def install() -> None:
    """Patch the ``threading`` factories.  Idempotent.  Call before the
    code under audit constructs its locks (e.g. at conftest import).
    Raises RuntimeError when another audit patched ``threading`` first
    (see the module's design notes)."""
    global _installed
    if _installed:
        return
    live = (threading.Lock, threading.RLock, threading.Condition)
    captured = (_real_Lock, _real_RLock, _real_Condition)
    for what in (live, captured):
        if not _stdlib_factories(*what):
            owner = getattr(what[0], "__module__", None)
            raise RuntimeError(
                f"lockcheck: threading's lock factories are already "
                f"patched (threading.Lock from {owner!r}); one lock audit "
                f"per process — run this audit in a fresh interpreter")
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory  # type: ignore[misc, assignment]
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _real_Lock
    threading.RLock = _real_RLock
    threading.Condition = _real_Condition  # type: ignore[misc]
    _installed = False


def reset() -> None:
    """Drop all recorded edges and hold stats (not the patch state)."""
    with _state_lock:
        _edges.clear()
        _held.clear()


# -- analysis ----------------------------------------------------------------

@dataclass
class Report:
    """Condensed view of the observed acquisition-order graph."""
    edges: Dict[Tuple[str, str], int] = field(default_factory=dict)
    cycles: List[List[str]] = field(default_factory=list)


def _sccs(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Iterative Tarjan; returns SCCs with ≥2 nodes (observed cycles)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in sorted(graph):
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on.add(nxt)
                    work.append((nxt, iter(sorted(graph.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) >= 2:
                    out.append(sorted(comp))
    return out


def check() -> Report:
    """Snapshot the observed graph and condense it; ``cycles`` is the
    list of observed lock-order inversions (empty == clean run)."""
    with _state_lock:
        edges = dict(_edges)
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    return Report(edges=edges, cycles=_sccs(graph))


def format_report(report: Report) -> str:
    if not report.cycles:
        return (f"lockcheck: clean — {len(report.edges)} ordered "
                f"site pair(s), no inversions")
    lines = [f"lockcheck: {len(report.cycles)} lock-order inversion(s) "
             f"observed at runtime:"]
    for comp in report.cycles:
        members = set(comp)
        lines.append("  cycle: " + " <-> ".join(comp))
        for (a, b), n in sorted(report.edges.items()):
            if a in members and b in members:
                lines.append(f"    {a} -> {b}  ({n}x)")
    lines.append("  (two threads really took these locks in opposite "
                 "orders — a latent deadlock; fix the ordering or drop "
                 "one nesting level)")
    return "\n".join(lines)


def stats() -> Dict[str, Dict[str, float]]:
    """Per-site hold profile: acquisitions, total and max held seconds."""
    with _state_lock:
        return {site: {"n": rec[0], "total_s": rec[1], "max_s": rec[2]}
                for site, rec in _held.items()}
