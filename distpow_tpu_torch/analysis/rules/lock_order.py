"""lock-order-inversion — cycles in the static lock acquisition graph.

Two threads acquiring the same pair of locks in opposite orders
deadlock the process the day the scheduler interleaves them — the
failure mode the Replicator pusher / anti-entropy / handoff triangle
and the coordinator's per-key locks vs the FleetRegistry lock could
reach as more subsystems take locks while calling each other.

The graph (``analysis/concur.py``) has an edge ``A -> B`` when B is
acquired while A is held, either lexically (nested ``with``) or
through a call made under A that transitively acquires B
(bounded-depth call summaries, ≤3 hops).  Lock identity aggregates by
``(declaring class, attribute)`` so per-instance locks map onto the
class-level discipline; unresolvable locals stay unique per function
and cannot fabricate cross-function cycles.  Reentrant self-edges are
skipped (RLock reentry is a different discipline, not an inversion).

Any cycle is reported ONCE, anchored at the participating edge with
the smallest source location; a justified suppression there (a trylock
fallback, a documented global order) silences the cycle.  The runtime
twin, ``runtime/lockcheck.py``, catches the orders this static
over-approximation cannot see.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from .. import concur

RULE_ID = "lock-order-inversion"
DESCRIPTION = (
    "no cycles in the lock acquisition order graph (nested with "
    "blocks + calls made while a lock is held)"
)

# edge: (src lock, dst lock) -> list of (module path, line, how)
Edge = Tuple[concur.LockId, concur.LockId]


def _edges(model: concur.Model) -> Dict[Edge, List[Tuple[str, int, str]]]:
    edges: Dict[Edge, List[Tuple[str, int, str]]] = {}

    def add(src, dst, node, info, how):
        if src == dst:
            return
        edges.setdefault((src, dst), []).append(
            (info.module.path, getattr(node, "lineno", 0), how))

    for info in model.methods.values():
        for a in info.acquisitions:
            for held in a.held_before:
                add(held, a.lock, a.node, info,
                    f"nested with in {info.short}")
        for c in info.calls:
            closure = model.acq_closure.get(c.callee, {})
            for lock, chain in closure.items():
                for held in c.held:
                    names = " -> ".join(
                        q.split("::")[-1] for q in chain)
                    add(held, lock, c.node, info,
                        f"call {info.short} -> {names}")
    return edges


def _sccs(nodes, succ) -> List[List]:
    """Tarjan, iterative (the graph is tiny but recursion depth must
    not depend on scanned code)."""
    index: Dict = {}
    low: Dict = {}
    on_stack = set()
    stack: List = []
    out: List[List] = []
    counter = [0]
    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(succ.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(succ.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def check_project(modules, context) -> Iterator:
    model = concur.get_model(modules)
    by_mod = {m.path: m for m in modules}
    edges = _edges(model)
    succ: Dict[concur.LockId, List[concur.LockId]] = {}
    nodes = set()
    for (src, dst) in edges:
        succ.setdefault(src, []).append(dst)
        nodes.add(src)
        nodes.add(dst)
    for comp in _sccs(sorted(nodes), succ):
        if len(comp) < 2:
            continue
        comp_set = set(comp)
        in_cycle = sorted(
            (e, sites) for e, sites in edges.items()
            if e[0] in comp_set and e[1] in comp_set
        )
        legs = []
        anchor = None  # (path, line)
        for (src, dst), sites in in_cycle:
            path, line, how = min(sites)
            legs.append(f"{concur.fmt_lock(src)} -> "
                        f"{concur.fmt_lock(dst)} "
                        f"({path.rsplit('/', 1)[-1]}:{line}, {how})")
            if anchor is None or (path, line) < anchor:
                anchor = (path, line)
        if anchor is None:
            continue
        mod = by_mod.get(anchor[0])
        if mod is None:
            continue
        yield mod.finding(
            RULE_ID, anchor[1],
            "lock acquisition cycle (potential deadlock): "
            + "; ".join(legs)
            + " — impose one global order, or suppress with the "
              "invariant that rules the interleaving out",
        )
