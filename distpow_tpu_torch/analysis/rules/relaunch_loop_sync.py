"""relaunch-loop-sync — no blocking result conversions in dispatch loops.

The persistent serving loop exists because a launch/fetch/relaunch loop
pays one BLOCKING host sync per launch: an ``int(res)`` or
``res.item()`` on an in-flight device value inside the dispatch loop
stalls the host until the card drains, serializing the pipeline and
putting the host round trip back on the critical path.  The sanctioned
patterns are (a) the solo drivers' dedicated drain helper
(``drain_one`` — a wait OUTSIDE any dispatch loop, on the launch's CUDA
event, or in the persistent driver a ``query()`` poll first) and (b)
the scheduler's single wait for each batched launch's results
(``sched/engine.py`` ``_fetch``: one pinned copy behind one event).

This rule flags ``int(<name>)`` / ``int(<name>[...])`` calls, and
``.item()`` calls, that sit lexically inside a ``for``/``while`` loop
(or a comprehension) in the driver and scheduler packages — the shape
every relaunch-loop sync in the reference's history has taken.  A
conversion that is genuinely host-side (an already-fetched array) is
suppressed with the justification inline; anything else should drain
through the FIFO or poll readiness first.

The reference rule (``distpow_tpu/analysis/rules/relaunch_loop_sync.py``)
is written in JAX's terms; this one keeps its ID, scope and shape.  Of
the torch names, ``int(<tensor>)`` is the same conversion as
``int(<jax array>)``; ``.item()`` is the torch form of the same scalar
read (on a JAX array the reference meets it in ``hot-path-host-sync``
only); ``torch.cuda.Event.query()`` stands in for ``is_ready()``, and
``_fetch``'s one event wait per launch for its ``jax.device_get``.

Scope: ``distpow_tpu_torch/parallel/`` and ``distpow_tpu_torch/sched/``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ._util import in_dirs

RULE_ID = "relaunch-loop-sync"
DESCRIPTION = (
    "no blocking int(<device value>) or .item() conversions inside "
    "dispatch loops in parallel/ or sched/ — drain through the FIFO or "
    "poll the launch's event"
)

_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _in_scope(path: str) -> bool:
    return in_dirs(path, "parallel", "sched")


def _flaggable_arg(node: ast.Call) -> bool:
    """``int(name)`` or ``int(name[...])`` — the conversion shapes a
    device value takes in this codebase.  Calls, attributes and
    constants as the argument are host-side arithmetic, not syncs."""
    if len(node.args) != 1 or node.keywords:
        return False
    arg = node.args[0]
    if isinstance(arg, ast.Name):
        return True
    return isinstance(arg, ast.Subscript) and \
        isinstance(arg.value, ast.Name)


def _flaggable(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Name) and func.id == "int":
        return _flaggable_arg(node)
    return isinstance(func, ast.Attribute) and func.attr == "item" and \
        not node.args and not node.keywords


def _conversions_in_loops(root: ast.AST) -> Iterator[ast.Call]:
    """Yield flaggable conversions lexically inside a loop, without
    crossing into nested function/lambda bodies (those run outside the
    loop's dynamic extent — e.g. a drain helper *defined* near a loop
    but called once per launch boundary)."""
    stack = [(child, False) for child in ast.iter_child_nodes(root)]
    while stack:
        node, in_loop = stack.pop()
        if in_loop and _flaggable(node):
            yield node
        entered = in_loop or isinstance(node, _LOOPS)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _SCOPES):
                # nested scope: restart the loop tracking inside it
                stack.extend(
                    (c, False) for c in ast.iter_child_nodes(child)
                )
            else:
                stack.append((child, entered))


def check(module, context) -> Iterator:
    if not _in_scope(module.path):
        return
    for node in _conversions_in_loops(module.tree):
        conv = "int()" if isinstance(node.func, ast.Name) else ".item()"
        yield module.finding(
            RULE_ID, node,
            f"{conv} on a (potential) device value inside a dispatch "
            f"loop blocks the host per launch and serializes the "
            f"pipeline — drain through the driver's FIFO / poll the "
            f"launch's event first, or suppress with why this "
            f"conversion cannot block",
        )
