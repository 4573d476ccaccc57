"""The shared static call/lock model behind the concurrency rules.

Three interprocedural passes (docs/CONCURRENCY.md) — guarded-by
analysis, lock-order-inversion, transitive blocking-under-lock — all
need the same facts about the scanned tree:

* which attributes of each class ARE locks (assigned
  ``threading.Lock/RLock/Condition``, or annotated as one),
* which lock is held at every shared-attribute access and call site
  (lexical ``with`` nesting, local aliases like ``wlock =
  self._wlock``, and entry-lock credit for private helpers only ever
  called with a lock held),
* a bounded-depth call graph (``self.meth()``, attribute-typed
  cross-class calls like ``self.fleet.round_plan()``, same-module
  functions, and constructor calls) with per-method summaries of lock
  acquisitions and blocking operations.

:func:`build_model` computes all of it in one walk over the engine's
already-parsed :class:`~.engine.Module` list; :func:`get_model` caches
the result so the three rules share one build per ``run_analysis``.

The ``# guarded-by: self._mu`` annotation protocol is parsed here too:
a trailing comment on an attribute's assignment (or class-body
annotation) declares the lock that must be held at EVERY access, and
turns violations into hard findings (rules/guarded_by.py).  Matching
is by the lock's terminal name — ``# guarded-by: registry._lock``
declares a cross-object guard that any held ``._lock`` satisfies; the
model is a linter, not a verifier, and docs/CONCURRENCY.md says so.

Deliberately lexical+summaries only, stdlib only, like the engine:
no imports of scanned code, no dataflow through containers beyond
``Dict[K, V]``-style annotations, explicit ``.acquire()`` calls
untracked (the tree uses ``with`` everywhere).

The port's copy of the reference's ``analysis/concur.py``
(``distpow_tpu/analysis/concur.py``): nothing in the model is
device-specific, so it is the reference's as it is.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

GUARD_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>[A-Za-z_][\w.]*)")


def terminal_name(node: ast.AST) -> Optional[str]:
    """Last segment of a Name/Attribute chain — duplicated from
    rules/_util.py because importing the rules package from here would
    be circular (the rule modules import this model)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None

LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition"})

# receiver methods that mutate the container they are called on — a
# bare `self._threads.append(t)` is a WRITE to the shared list
MUTATORS = frozenset({
    "append", "extend", "insert", "add", "discard", "remove", "pop",
    "popitem", "clear", "update", "setdefault", "appendleft", "popleft",
})
# receiver methods whose result has the container's ELEMENT type
ELEM_CALLS = frozenset({"values", "get", "pop", "setdefault", "popleft"})

CONTAINER_GENERICS = frozenset({
    "Dict", "dict", "Mapping", "MutableMapping", "DefaultDict",
    "OrderedDict", "List", "list", "Sequence", "Set", "set",
    "FrozenSet", "Iterable", "Iterator", "Deque", "deque", "Optional",
    "Tuple", "tuple",
})

INIT_METHODS = frozenset({"__init__", "__post_init__", "__new__"})

# LockId = (owner, name): owner is a class qual ("path::Class"), a
# module path (module-level locks), or "local:<method qual>" for
# unresolvable locals (unique per method, so they can never fabricate
# cross-function cycles)
LockId = Tuple[str, str]


def is_lockish(name: str) -> bool:
    lowered = name.lower()
    return "lock" in lowered or "mutex" in lowered


def fmt_lock(lid: LockId) -> str:
    owner, name = lid
    if owner.startswith("local:"):
        return name
    return f"{owner.split('::')[-1]}.{name}"


@dataclass
class Access:
    """One read/write of a (resolved) shared attribute."""

    owner: str  # class qual the attribute belongs to
    attr: str
    write: bool
    held: FrozenSet[LockId]  # lexical locks at the access
    node: ast.AST
    method: "MethodInfo"
    fresh: bool = False  # receiver constructed in this same function


@dataclass
class CallSite:
    callee: str  # method qual
    held: FrozenSet[LockId]
    node: ast.AST
    method: "MethodInfo"
    # True when an enclosing lexical `with` is lock-NAMED (the direct
    # no-blocking-under-lock rule already polices this extent)
    lock_named_hold: bool = False


@dataclass
class BlockingSite:
    reason: str
    held: FrozenSet[LockId]
    node: ast.AST
    method: "MethodInfo"
    lock_named_hold: bool = False
    # `self._cond.wait()` with self._cond itself held: wait() RELEASES
    # the lock — the canonical condition-variable shape, not a hold
    self_wait: bool = False


@dataclass
class Acquisition:
    lock: LockId
    held_before: FrozenSet[LockId]
    node: ast.AST
    method: "MethodInfo"


@dataclass
class MethodInfo:
    qual: str  # "path::Class.meth", "path::func", nested "...meth.inner"
    name: str
    cls: Optional[str]  # owning class qual ('self' binds to it)
    module: "object"  # engine.Module
    node: ast.AST
    acquisitions: List[Acquisition] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    accesses: List[Access] = field(default_factory=list)
    blocking: List[BlockingSite] = field(default_factory=list)

    @property
    def short(self) -> str:
        return self.qual.split("::")[-1]


@dataclass
class ClassInfo:
    name: str
    qual: str  # "path::Name"
    module_path: str
    bases: List[str] = field(default_factory=list)  # raw base names
    lock_attrs: Set[str] = field(default_factory=set)
    attr_types: Dict[str, str] = field(default_factory=dict)  # raw names
    attr_elem_types: Dict[str, str] = field(default_factory=dict)
    guards: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    declared_attrs: Set[str] = field(default_factory=set)
    method_names: Set[str] = field(default_factory=set)


@dataclass
class Model:
    classes: Dict[str, ClassInfo] = field(default_factory=dict)  # by qual
    classes_by_name: Dict[str, List[str]] = field(default_factory=dict)
    methods: Dict[str, MethodInfo] = field(default_factory=dict)
    module_locks: Set[LockId] = field(default_factory=set)
    # method quals referenced as bare attributes (thread targets,
    # callbacks): their call sites are NOT all visible, so they earn
    # no entry-lock credit
    escaped_methods: Set[str] = field(default_factory=set)
    entry_locks: Dict[str, FrozenSet[LockId]] = field(default_factory=dict)
    # qual -> (hops, chain of quals, leaf reason)
    block_depth: Dict[str, Tuple[int, Tuple[str, ...], str]] = field(
        default_factory=dict)
    # qual -> {LockId: chain of quals from the method to the acquirer}
    acq_closure: Dict[str, Dict[LockId, Tuple[str, ...]]] = field(
        default_factory=dict)

    # -- resolution helpers --------------------------------------------------

    def resolve_class(self, name: str, module_path: str) -> Optional[str]:
        quals = self.classes_by_name.get(name, ())
        same = [q for q in quals
                if self.classes[q].module_path == module_path]
        if same:
            return same[0]
        if len(quals) == 1:
            return quals[0]
        return None  # ambiguous across modules: refuse to guess

    def mro(self, qual: str, depth: int = 4) -> List[ClassInfo]:
        """The class and its resolvable bases, bounded."""
        out, seen, frontier = [], set(), [qual]
        while frontier and depth >= 0:
            nxt: List[str] = []
            for q in frontier:
                if q in seen or q not in self.classes:
                    continue
                seen.add(q)
                ci = self.classes[q]
                out.append(ci)
                for b in ci.bases:
                    bq = self.resolve_class(b, ci.module_path)
                    if bq:
                        nxt.append(bq)
            frontier, depth = nxt, depth - 1
        return out

    def owner_of(self, cls_qual: str, attr: str) -> str:
        """The class (self or base) that declares ``attr`` — subclass
        accesses aggregate with the declaring class's discipline."""
        for ci in self.mro(cls_qual):
            if attr in ci.declared_attrs or attr in ci.lock_attrs \
                    or attr in ci.guards:
                return ci.qual
        return cls_qual

    def find_method(self, cls_qual: str, name: str) -> Optional[str]:
        for ci in self.mro(cls_qual):
            if name in ci.method_names:
                return f"{ci.qual}.{name}"
        return None

    def is_lock_attr(self, cls_qual: str, attr: str) -> bool:
        return any(attr in ci.lock_attrs for ci in self.mro(cls_qual))

    def is_method_name(self, cls_qual: str, attr: str) -> bool:
        return any(attr in ci.method_names for ci in self.mro(cls_qual))

    def guard_for(self, cls_qual: str, attr: str
                  ) -> Optional[Tuple[str, int]]:
        for ci in self.mro(cls_qual):
            if attr in ci.guards:
                return ci.guards[attr]
        return None

    def held_effective(self, acc_or_site) -> FrozenSet[LockId]:
        return acc_or_site.held | self.entry_locks.get(
            acc_or_site.method.qual, frozenset())


# -- annotation helpers ------------------------------------------------------

def _guard_lines(source: str) -> Dict[int, str]:
    """line -> guard lock terminal name, from ``# guarded-by:``
    comments (trailing an assignment or annotation)."""
    out: Dict[int, str] = {}
    for i, line in enumerate(source.split("\n"), start=1):
        m = GUARD_RE.search(line)
        if m:
            out[i] = m.group("lock").split(".")[-1]
    return out


def _annotation_types(ann: ast.AST) -> Tuple[Optional[str], Optional[str]]:
    """(direct class name, container element class name) out of a type
    annotation — enough to chase ``self._leases: Dict[str, Lease]``
    lookups to ``Lease``.  String annotations are re-parsed."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None, None
    if isinstance(ann, (ast.Name, ast.Attribute)):
        name = terminal_name(ann)
        if name and name[:1].isupper() and name not in CONTAINER_GENERICS:
            return name, None
        return None, None
    if isinstance(ann, ast.Subscript):
        head = terminal_name(ann.value)
        if head not in CONTAINER_GENERICS:
            return None, None
        slc = ann.slice
        elts = list(slc.elts) if isinstance(slc, ast.Tuple) else [slc]
        # Optional[T] is T-with-None, not a container of T
        if head == "Optional":
            return _annotation_types(elts[0])
        # Dict[K, V] -> V; List[T]/... -> T
        pick = elts[-1] if head in ("Dict", "dict", "Mapping",
                                    "MutableMapping", "DefaultDict",
                                    "OrderedDict") else elts[0]
        direct, _ = _annotation_types(pick)
        return None, direct
    return None, None


def _queue_fsync_reason(call: ast.Call) -> str:
    """Blocking leaves the lexical rule's set leaves out but the
    transitive closure must see: ``q.get/put(..., timeout=...)`` (or
    an explicit ``block=``) and ``os.fsync`` — a journal fsync under a
    lock stalls every waiter for a disk flush."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return ""
    if fn.attr == "fsync":
        return "fsync(...) blocks on a disk flush"
    if fn.attr in ("get", "put") and any(
            k.arg in ("timeout", "block") for k in call.keywords):
        return f".{fn.attr}(timeout=...) parks the thread"
    return ""


def _is_lock_factory(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    name = terminal_name(call.func)
    return name in LOCK_FACTORIES


# -- class collection (pass 1) -----------------------------------------------

def _collect_class(node: ast.ClassDef, module, guards: Dict[int, str],
                   ) -> ClassInfo:
    ci = ClassInfo(
        name=node.name,
        qual=f"{module.path}::{node.name}",
        module_path=module.path,
        bases=[terminal_name(b) or "" for b in node.bases],
    )
    for stmt in node.body:
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name):
            attr = stmt.target.id
            ci.declared_attrs.add(attr)
            direct, elem = _annotation_types(stmt.annotation)
            t = terminal_name(stmt.annotation)
            if t in LOCK_FACTORIES or (
                    stmt.value is not None and _is_lock_factory(stmt.value)):
                ci.lock_attrs.add(attr)
            elif isinstance(stmt.value, ast.Call) and \
                    terminal_name(stmt.value.func) == "field" and \
                    any(k.arg == "default_factory"
                        and terminal_name(k.value) in LOCK_FACTORIES
                        for k in stmt.value.keywords):
                ci.lock_attrs.add(attr)  # dataclass lock field
            if direct:
                ci.attr_types[attr] = direct
            if elem:
                ci.attr_elem_types[attr] = elem
            g = guards.get(stmt.lineno) or guards.get(
                getattr(stmt, "end_lineno", stmt.lineno))
            if g:
                ci.guards[attr] = (g, stmt.lineno)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ci.method_names.add(stmt.name)
    # every `self.X = ...` in every method (nested too) declares X
    for fn in ast.walk(node):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(fn):
            targets: List[ast.AST] = []
            value = None
            if isinstance(sub, ast.Assign):
                targets, value = list(sub.targets), sub.value
            elif isinstance(sub, ast.AnnAssign):
                targets, value = [sub.target], sub.value
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                ci.declared_attrs.add(t.attr)
                if value is not None and _is_lock_factory(value):
                    ci.lock_attrs.add(t.attr)
                if isinstance(sub, ast.AnnAssign):
                    direct, elem = _annotation_types(sub.annotation)
                    if direct:
                        ci.attr_types.setdefault(t.attr, direct)
                    if elem:
                        ci.attr_elem_types.setdefault(t.attr, elem)
                elif isinstance(value, ast.Call):
                    vn = terminal_name(value.func)
                    if vn and vn[:1].isupper() and \
                            vn not in LOCK_FACTORIES:
                        ci.attr_types.setdefault(t.attr, vn)
                g = guards.get(sub.lineno) or guards.get(
                    getattr(sub, "end_lineno", sub.lineno))
                if g:
                    ci.guards.setdefault(t.attr, (g, sub.lineno))
    return ci


# -- per-function summaries (pass 2) -----------------------------------------

class _FuncVisitor:
    """One walk over one function body, tracking the lexical lock-held
    stack, a tiny local type/alias environment, and recording the
    method's accesses, calls, acquisitions and blocking sites."""

    def __init__(self, model: Model, info: MethodInfo):
        self.model = model
        self.info = info
        self.held: List[LockId] = []
        self.lock_named: List[bool] = []  # parallel: with-name lockish?
        self.locals_types: Dict[str, str] = {}   # name -> class qual
        self.locals_elem: Dict[str, str] = {}    # name -> elem class qual
        self.locals_locks: Dict[str, LockId] = {}  # lock aliases
        self.fresh: Set[str] = set()  # locals constructed here
        self.nested: List[ast.AST] = []
        node = info.node
        args = getattr(node, "args", None)
        if args is not None:
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if a.annotation is not None:
                    direct, elem = _annotation_types(a.annotation)
                    q = direct and self._class_qual(direct)
                    if q:
                        self.locals_types[a.arg] = q
                    eq = elem and self._class_qual(elem)
                    if eq:
                        self.locals_elem[a.arg] = eq

    # -- small resolution utilities ------------------------------------------

    def _class_qual(self, name: Optional[str]) -> Optional[str]:
        if not name:
            return None
        return self.model.resolve_class(name, self.info.module.path)

    def _snapshot(self) -> FrozenSet[LockId]:
        return frozenset(self.held)

    def _lock_named_now(self) -> bool:
        return any(self.lock_named)

    def expr_type(self, e: ast.AST) -> Optional[str]:
        """Class qual of an expression, chasing locals, self attrs,
        annotated-container element lookups, and constructors."""
        if isinstance(e, ast.Name):
            return self.locals_types.get(e.id)
        if isinstance(e, ast.Attribute):
            base_cls = None
            if isinstance(e.value, ast.Name) and e.value.id == "self":
                base_cls = self.info.cls
            else:
                base_cls = self.expr_type(e.value)
            if base_cls:
                for ci in self.model.mro(base_cls):
                    if e.attr in ci.attr_types:
                        return self._class_qual(ci.attr_types[e.attr])
            return None
        if isinstance(e, ast.Subscript):
            return self._elem_type(e.value)
        if isinstance(e, ast.Call):
            fn = e.func
            if isinstance(fn, ast.Name):
                if fn.id == "getattr" and len(e.args) >= 2 and \
                        isinstance(e.args[1], ast.Constant) and \
                        isinstance(e.args[1].value, str):
                    # getattr(ref, "lease", None) — the tree's
                    # duck-typing idiom; chase it like ref.lease
                    fake = ast.Attribute(value=e.args[0],
                                         attr=e.args[1].value,
                                         ctx=ast.Load())
                    return self.expr_type(fake)
                return self._class_qual(fn.id)
            if isinstance(fn, ast.Attribute) and fn.attr in ELEM_CALLS:
                return self._elem_type(fn.value)
        return None

    def _elem_type(self, container: ast.AST) -> Optional[str]:
        if isinstance(container, ast.Call):
            fn = container.func
            # list(self.refs) / sorted(...) snapshots keep the elem type
            if isinstance(fn, ast.Name) and container.args and fn.id in (
                    "list", "sorted", "tuple", "set", "iter", "reversed"):
                return self._elem_type(container.args[0])
            if isinstance(fn, ast.Attribute) and fn.attr in ELEM_CALLS:
                return self._elem_type(fn.value)
            return None
        if isinstance(container, ast.Name):
            return self.locals_elem.get(container.id)
        if isinstance(container, ast.Attribute):
            base_cls = None
            if isinstance(container.value, ast.Name) and \
                    container.value.id == "self":
                base_cls = self.info.cls
            else:
                base_cls = self.expr_type(container.value)
            if base_cls:
                for ci in self.model.mro(base_cls):
                    if container.attr in ci.attr_elem_types:
                        return self._class_qual(
                            ci.attr_elem_types[container.attr])
        return None

    def resolve_lock(self, expr: ast.AST) -> Optional[LockId]:
        """LockId of a `with` item, or None when it is not a lock.
        Recognition: a lock-ish terminal NAME, or an identity that maps
        to a discovered lock (class attr, module lock, local alias)."""
        node = expr.func if isinstance(expr, ast.Call) else expr
        name = terminal_name(node)
        if name is None:
            return None
        suffix = "()" if isinstance(expr, ast.Call) else ""
        if isinstance(node, ast.Attribute):
            base_cls = None
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                base_cls = self.info.cls
            else:
                base_cls = self.expr_type(node.value)
            if base_cls:
                if self.model.is_lock_attr(base_cls, name) or \
                        is_lockish(name):
                    owner = self.model.owner_of(base_cls, name)
                    return (owner, name + suffix)
                return None
            return (f"local:{self.info.qual}", name + suffix) \
                if is_lockish(name) else None
        if isinstance(node, ast.Name):
            if node.id in self.locals_locks:
                return self.locals_locks[node.id]
            mid = (self.info.module.path, name)
            if mid in self.model.module_locks:
                return mid
            return (f"local:{self.info.qual}", name + suffix) \
                if is_lockish(name) else None
        return None

    # -- recording -----------------------------------------------------------

    def record_access(self, attr_node: ast.Attribute, write: bool) -> None:
        base = attr_node.value
        if isinstance(base, ast.Name) and base.id == "self":
            cls = self.info.cls
            fresh = False
        else:
            cls = self.expr_type(base)
            fresh = isinstance(base, ast.Name) and base.id in self.fresh
        if cls is None:
            return
        attr = attr_node.attr
        if attr.startswith("__") or self.model.is_lock_attr(cls, attr):
            return
        if self.model.is_method_name(cls, attr):
            # a bare method reference escapes (thread target, callback):
            # its call sites are no longer all visible
            mq = self.model.find_method(cls, attr)
            if mq:
                self.model.escaped_methods.add(mq)
            return
        self.info.accesses.append(Access(
            owner=self.model.owner_of(cls, attr), attr=attr, write=write,
            held=self._snapshot(), node=attr_node, method=self.info,
            fresh=fresh,
        ))

    def record_call(self, call: ast.Call) -> None:
        from .rules.blocking_under_lock import _blocking_reason
        reason = _blocking_reason(call) or _queue_fsync_reason(call)
        if reason:
            self_wait = False
            fn = call.func
            if isinstance(fn, ast.Attribute) and fn.attr == "wait":
                recv_lock = self.resolve_lock(fn.value)
                self_wait = recv_lock is not None and recv_lock in self.held
            self.info.blocking.append(BlockingSite(
                reason=reason, held=self._snapshot(), node=call,
                method=self.info, lock_named_hold=self._lock_named_now(),
                self_wait=self_wait,
            ))
        callee: Optional[str] = None
        fn = call.func
        if isinstance(fn, ast.Attribute):
            base_cls = None
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                base_cls = self.info.cls
            else:
                base_cls = self.expr_type(fn.value)
            if base_cls:
                callee = self.model.find_method(base_cls, fn.attr)
        elif isinstance(fn, ast.Name):
            q = f"{self.info.module.path}::{fn.id}"
            if q in self.model.methods:
                callee = q
            else:
                cq = self._class_qual(fn.id)
                if cq and f"{cq}.__init__" in self.model.methods:
                    callee = f"{cq}.__init__"
        if callee:
            self.info.calls.append(CallSite(
                callee=callee, held=self._snapshot(), node=call,
                method=self.info, lock_named_hold=self._lock_named_now(),
            ))

    # -- the walk ------------------------------------------------------------

    def visit_body(self, stmts: Sequence[ast.stmt]) -> None:
        for s in stmts:
            self.visit_stmt(s)

    def visit_stmt(self, s: ast.stmt) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.nested.append(s)  # analyzed as its own method
            return
        if isinstance(s, ast.ClassDef):
            return  # nested classes: out of scope
        if isinstance(s, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in s.items:
                self.visit_expr(item.context_expr)
                lock = self.resolve_lock(item.context_expr)
                if lock is not None:
                    self.info.acquisitions.append(Acquisition(
                        lock=lock, held_before=self._snapshot(),
                        node=item.context_expr, method=self.info,
                    ))
                    self.held.append(lock)
                    self.lock_named.append(is_lockish(lock[1]))
                    pushed += 1
                if item.optional_vars is not None:
                    self.visit_target(item.optional_vars)
            self.visit_body(s.body)
            for _ in range(pushed):
                self.held.pop()
                self.lock_named.pop()
            return
        if isinstance(s, ast.Assign):
            self.visit_expr(s.value)
            for t in s.targets:
                self.visit_target(t)
            if len(s.targets) == 1 and isinstance(s.targets[0], ast.Name):
                self._bind_local(s.targets[0].id, s.value)
            return
        if isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self.visit_expr(s.value)
            self.visit_target(s.target)
            if isinstance(s.target, ast.Name):
                direct, elem = _annotation_types(s.annotation)
                q = direct and self._class_qual(direct)
                if q:
                    self.locals_types[s.target.id] = q
                eq = elem and self._class_qual(elem)
                if eq:
                    self.locals_elem[s.target.id] = eq
                if s.value is not None:
                    self._bind_local(s.target.id, s.value)
            return
        if isinstance(s, ast.AugAssign):
            self.visit_expr(s.value)
            if isinstance(s.target, ast.Attribute):
                self.visit_expr(s.target.value)
                self.record_access(s.target, write=True)
            else:
                self.visit_target(s.target)
            return
        if isinstance(s, ast.Delete):
            for t in s.targets:
                self.visit_target(t)
            return
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self.visit_expr(s.iter)
            if isinstance(s.target, ast.Name):
                eq = self._elem_type(s.iter) or (
                    self._elem_type(s.iter.func.value)
                    if isinstance(s.iter, ast.Call)
                    and isinstance(s.iter.func, ast.Attribute) else None)
                if eq:
                    self.locals_types[s.target.id] = eq
            self.visit_target(s.target)
            self.visit_body(s.body)
            self.visit_body(s.orelse)
            return
        # default: expressions in the statement, then nested bodies,
        # all under the current held set
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.expr):
                self.visit_expr(child)
            elif isinstance(child, ast.stmt):
                self.visit_stmt(child)
            elif isinstance(child, (ast.excepthandler,)):
                self.visit_body(child.body)
            elif isinstance(child, ast.withitem):
                self.visit_expr(child.context_expr)
        return

    def _bind_local(self, name: str, value: ast.expr) -> None:
        if isinstance(value, ast.Attribute):
            lock = self.resolve_lock(value)
            if lock is not None:
                self.locals_locks[name] = lock
                return
        t = self.expr_type(value)
        if t:
            self.locals_types[name] = t
            if isinstance(value, ast.Call) and \
                    isinstance(value.func, ast.Name) and \
                    self._class_qual(value.func.id) == t:
                self.fresh.add(name)  # constructed here, not yet shared
            else:
                self.fresh.discard(name)
        elem = self._elem_type(value) if not isinstance(value, ast.Call) \
            else None
        if elem:
            self.locals_elem[name] = elem

    def visit_target(self, t: ast.expr) -> None:
        """Assignment/delete targets: attribute and subscript stores
        are WRITES to the underlying shared attribute."""
        if isinstance(t, ast.Attribute):
            self.visit_expr(t.value)
            self.record_access(t, write=True)
        elif isinstance(t, ast.Subscript):
            # self._tasks[k] = v mutates self._tasks
            if isinstance(t.value, ast.Attribute):
                self.visit_expr(t.value.value)
                self.record_access(t.value, write=True)
            else:
                self.visit_expr(t.value)
            self.visit_expr(t.slice)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self.visit_target(e)
        elif isinstance(t, ast.Starred):
            self.visit_target(t.value)

    def visit_expr(self, e: ast.expr) -> None:
        if isinstance(e, ast.Call):
            self.record_call(e)
            fn = e.func
            if isinstance(fn, ast.Attribute):
                # receiver read (or container mutation) — but a method
                # call's receiver chain below the method name
                if isinstance(fn.value, ast.Attribute):
                    self.record_access(
                        fn.value, write=fn.attr in MUTATORS)
                    self.visit_expr(fn.value.value)
                else:
                    self.visit_expr(fn.value)
            elif not isinstance(fn, ast.Name):
                self.visit_expr(fn)
            for a in e.args:
                self.visit_expr(a.value if isinstance(a, ast.Starred)
                                else a)
            for k in e.keywords:
                self.visit_expr(k.value)
            return
        if isinstance(e, ast.Attribute):
            self.record_access(e, write=False)
            self.visit_expr(e.value)
            return
        if isinstance(e, ast.Lambda):
            return  # runs later, outside this dynamic extent
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.DictComp,
                          ast.GeneratorExp)):
            # comprehensions execute inline (genexps mostly do too in
            # this tree — consumed immediately); walk them under the
            # current held set
            for gen in e.generators:
                self.visit_expr(gen.iter)
                for cond in gen.ifs:
                    self.visit_expr(cond)
            if isinstance(e, ast.DictComp):
                self.visit_expr(e.key)
                self.visit_expr(e.value)
            else:
                self.visit_expr(e.elt)
            return
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self.visit_expr(child)


# -- model assembly ----------------------------------------------------------

CALL_DEPTH = 3  # bounded call-graph summaries: ≤3 hops


def _walk_functions(model: Model, module, cls: Optional[str],
                    prefix: str, fns: Sequence[ast.AST]) -> None:
    """Register + summarize each function, then its nested functions
    (which run later: their held stack starts empty, but ``self``
    still binds to the enclosing class through the closure)."""
    for fn in fns:
        qual = f"{prefix}{fn.name}"
        info = MethodInfo(qual=qual, name=fn.name, cls=cls,
                          module=module, node=fn)
        model.methods[qual] = info
        v = _FuncVisitor(model, info)
        v.visit_body(fn.body)
        _walk_functions(model, module, cls, qual + ".", v.nested)


def build_model(modules: Sequence) -> Model:
    model = Model()
    guard_maps = {}
    # pass 1: classes, module-level locks, guard annotations
    for m in modules:
        guards = _guard_lines(m.source)
        guard_maps[m.path] = guards
        for node in m.tree.body:
            if isinstance(node, ast.ClassDef):
                ci = _collect_class(node, m, guards)
                model.classes[ci.qual] = ci
                model.classes_by_name.setdefault(ci.name, []).append(
                    ci.qual)
            elif isinstance(node, ast.Assign) and _is_lock_factory(
                    node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        model.module_locks.add((m.path, t.id))
    # pass 2: register every function first (Name-call resolution needs
    # the full registry), then summarize
    pending: List[Tuple[object, Optional[str], str, List[ast.AST]]] = []
    for m in modules:
        top = [n for n in m.tree.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        pending.append((m, None, f"{m.path}::", top))
        for node in m.tree.body:
            if isinstance(node, ast.ClassDef):
                methods = [n for n in node.body if isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef))]
                pending.append((m, f"{m.path}::{node.name}",
                                f"{m.path}::{node.name}.", methods))
    for m, cls, prefix, fns in pending:
        for fn in fns:  # pre-register names for cross-function calls
            model.methods.setdefault(
                f"{prefix}{fn.name}",
                MethodInfo(qual=f"{prefix}{fn.name}", name=fn.name,
                           cls=cls, module=m, node=fn))
    for m, cls, prefix, fns in pending:
        _walk_functions(model, m, cls, prefix, fns)
    _compute_entry_locks(model)
    _compute_block_depth(model)
    _compute_acq_closure(model)
    return model


def _compute_entry_locks(model: Model) -> None:
    """A method called at every visible call site with lock L held
    runs under L — its accesses classify as under-lock ('through
    helper methods', docs/CONCURRENCY.md).  Dunder methods and escaped
    methods (thread targets, callbacks, bare references — dispatched
    by machinery the model cannot see) earn no credit; a method with
    NO visible call sites (RPC handlers entered by name) earns none
    either, because ``callers`` is empty."""
    sites: Dict[str, List[CallSite]] = {}
    for info in model.methods.values():
        for c in info.calls:
            sites.setdefault(c.callee, []).append(c)
    entry: Dict[str, FrozenSet[LockId]] = {
        q: frozenset() for q in model.methods}
    for _ in range(CALL_DEPTH):
        nxt = dict(entry)
        for q, info in model.methods.items():
            if info.name.startswith("__") or \
                    q in model.escaped_methods:
                continue
            callers = sites.get(q)
            if not callers:
                continue
            held = None
            for c in callers:
                at_site = c.held | entry[c.method.qual]
                held = at_site if held is None else (held & at_site)
            nxt[q] = held or frozenset()
        if nxt == entry:
            break
        entry = nxt
    model.entry_locks = entry


def _compute_block_depth(model: Model) -> None:
    """qual -> (hops, chain, reason): fewest call hops from entering
    the method to a known blocking operation, bounded at CALL_DEPTH."""
    depth: Dict[str, Tuple[int, Tuple[str, ...], str]] = {}
    for q, info in model.methods.items():
        if info.blocking:
            b = info.blocking[0]
            depth[q] = (1, (q,), b.reason)
    for _ in range(CALL_DEPTH - 1):
        changed = False
        for q, info in model.methods.items():
            best = depth.get(q)
            for c in info.calls:
                sub = depth.get(c.callee)
                if sub is None or c.callee == q:
                    continue
                cand = (sub[0] + 1, (q,) + sub[1], sub[2])
                if cand[0] <= CALL_DEPTH and (
                        best is None or cand[0] < best[0]):
                    best = cand
            if best is not None and depth.get(q) != best:
                depth[q] = best
                changed = True
        if not changed:
            break
    model.block_depth = depth


def _compute_acq_closure(model: Model) -> None:
    """qual -> {lock: call chain to its acquirer}: every lock a call
    into the method can end up acquiring, bounded at CALL_DEPTH."""
    closure: Dict[str, Dict[LockId, Tuple[str, ...]]] = {}
    for q, info in model.methods.items():
        own: Dict[LockId, Tuple[str, ...]] = {}
        for a in info.acquisitions:
            own.setdefault(a.lock, (q,))
        closure[q] = own
    for _ in range(CALL_DEPTH):
        changed = False
        for q, info in model.methods.items():
            mine = closure[q]
            for c in info.calls:
                if c.callee == q:
                    continue
                for lock, chain in closure.get(c.callee, {}).items():
                    if lock not in mine and len(chain) < CALL_DEPTH + 1:
                        mine[lock] = (q,) + chain
                        changed = True
        if not changed:
            break
    model.acq_closure = closure


# -- shared-build cache ------------------------------------------------------

_CACHE: Tuple[Optional[tuple], Optional[Model]] = (None, None)


def get_model(modules: Sequence) -> Model:
    """One model build per ``run_analysis`` pass: the three concurrency
    rules receive the same module list object in sequence."""
    global _CACHE
    key = (id(modules), tuple((m.path, len(m.source)) for m in modules))
    if _CACHE[0] == key and _CACHE[1] is not None:
        return _CACHE[1]
    model = build_model(modules)
    _CACHE = (key, model)
    return model
