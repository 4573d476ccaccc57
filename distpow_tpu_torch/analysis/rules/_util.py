"""Shared AST and path-scope helpers for the rule modules."""

from __future__ import annotations

import ast
from typing import Iterator, Optional


def norm_path(path: str) -> str:
    """Forward-slash form of a module path (one normalization for every
    rule's scope check)."""
    return path.replace("\\", "/")


def in_dirs(path: str, *dirs: str) -> bool:
    """True when the module lives under any of the named directories
    (``in_dirs(p, "ops")`` matches ``distpow_tpu_torch/ops/x.py`` and a
    scan rooted at ``ops/`` itself)."""
    p = norm_path(path)
    return any(f"/{d}/" in p or p.startswith(f"{d}/") for d in dirs)


def is_module(path: str, suffix: str) -> bool:
    """True when the module IS the named file (``runtime/actions.py``)."""
    return norm_path(path).endswith(suffix)

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """The last segment of a Name/Attribute chain (``self._conn_lock``
    -> ``_conn_lock``); None for anything else (calls, subscripts)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def receiver_name(call_func: ast.AST) -> Optional[str]:
    """For an Attribute callee ``recv.meth(...)``, the terminal name of
    ``recv``; None for plain Name calls."""
    if isinstance(call_func, ast.Attribute):
        return terminal_name(call_func.value)
    return None


def walk_same_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Yield descendants WITHOUT entering nested function/class/lambda
    bodies — code in those executes later, outside the enclosing
    block's dynamic extent (a callback defined under a lock does not
    run under the lock)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(child, _SCOPE_NODES):
            stack.extend(ast.iter_child_nodes(child))


def resolve_str_constant(tree: ast.Module, name: str) -> Optional[str]:
    """Value of a module-level ``NAME = "literal"`` assignment."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return node.value.value
    return None
