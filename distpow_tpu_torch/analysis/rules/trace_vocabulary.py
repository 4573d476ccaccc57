"""trace-vocabulary — the 16-action trace vocabulary stays closed.

Trace parity with the reference (worker.go / coordinator.go /
powlib.go / cache.go recorded actions) is this repo's correctness
oracle; it holds only while every action the code constructs is one of
the classes declared in ``runtime/actions.py``.  Two drift vectors are
checked mechanically:

* a constructed action must be declared: any call through an actions-
  module alias (``act.WorkerResult(...)``, or a name imported from
  ``runtime.actions``) whose target is CamelCase but not in the parsed
  vocabulary is flagged — a typo'd or invented action name would
  otherwise surface only when that protocol path executes;
* the vocabulary must stay centralized: an ``Action`` subclass defined
  in any module other than ``runtime/actions.py`` is flagged — a
  scattered vocabulary cannot be diffed against the reference's four
  action files.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ._util import is_module

RULE_ID = "trace-vocabulary"
DESCRIPTION = (
    "every constructed trace action must be declared in "
    "runtime/actions.py; no Action subclasses elsewhere"
)

ACTIONS_MODULE = "actions"


def _actions_aliases(tree: ast.Module) -> Set[str]:
    """Names this module binds to the actions module itself
    (``from ..runtime import actions as act``)."""
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == ACTIONS_MODULE:
                    aliases.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[-1] != ACTIONS_MODULE:
                    continue
                if a.asname:
                    aliases.add(a.asname)
                elif "." not in a.name:
                    # plain `import actions` binds the module name; a
                    # dotted `import pkg.runtime.actions` binds only the
                    # TOP package — construction goes through an
                    # Attribute chain this Name-based check cannot (and
                    # must not pretend to) track
                    aliases.add(a.name)
    return aliases


def _imported_action_names(tree: ast.Module) -> Set[str]:
    """Names imported FROM the actions module
    (``from .actions import CacheAdd``)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[-1] == ACTIONS_MODULE:
            for a in node.names:
                names.add(a.asname or a.name)
    return names


def check(module, context) -> Iterator:
    if not context.action_names:
        return  # no vocabulary parsed (fixture tree without actions.py)
    if is_module(module.path, "runtime/actions.py"):
        return

    aliases = _actions_aliases(module.tree)
    imported = _imported_action_names(module.tree)

    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef):
            for base in node.bases:
                base_name = base.attr if isinstance(base, ast.Attribute) \
                    else getattr(base, "id", None)
                if base_name == "Action" or (
                        base_name in context.action_names):
                    yield module.finding(
                        RULE_ID, node,
                        f"Action subclass {node.name!r} defined outside "
                        f"runtime/actions.py — the trace vocabulary must "
                        f"stay centralized for reference parity",
                    )
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = None
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and \
                func.value.id in aliases:
            name = func.attr
        elif isinstance(func, ast.Name) and func.id in imported:
            name = func.id
        if name is None or not name[:1].isupper():
            continue
        if name not in context.action_names:
            yield module.finding(
                RULE_ID, node,
                f"action {name!r} is not declared in runtime/actions.py "
                f"(declared vocabulary: {len(context.action_names)} "
                f"types) — a recorded unknown action breaks trace parity",
            )
