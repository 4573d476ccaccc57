"""dead-package — no hollow directories in the tree.

The reference package's ``utils/`` once shipped as an empty package
(a 0-line ``__init__.py``, no modules) for a long while because nothing
mechanically objected.  A package directory whose only content is an
``__init__.py`` with no executable statements (docstrings and comments
don't count) and no sibling modules or subpackages is dead weight that
invites drive-by dumping-ground imports; delete it, or give it content.

This is a directory-level rule (``scan_tree``): it sees the scanned
root, not individual modules, so per-file suppression does not apply —
the fix is structural.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from ..engine import SKIP_DIRS, Finding

RULE_ID = "dead-package"
DESCRIPTION = (
    "package directories must contain more than an empty __init__.py"
)


def _init_is_empty(path: str) -> bool:
    try:
        with open(path, "rb") as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return False
    for node in tree.body:
        if isinstance(node, ast.Expr) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            continue  # docstring
        return False
    return True


def scan_tree(root: str, rel_to: str, context) -> Iterator[Finding]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIRS)
        if "__init__.py" not in filenames:
            continue
        substance = [f for f in filenames
                     if f != "__init__.py" and not f.endswith(".pyc")]
        if substance or dirnames:
            continue
        init = os.path.join(dirpath, "__init__.py")
        if _init_is_empty(init):
            yield Finding(
                rule=RULE_ID,
                path=os.path.relpath(init, rel_to),
                line=1,
                message=(
                    f"package {os.path.basename(dirpath)!r} contains "
                    f"nothing but an empty __init__.py — delete the "
                    f"directory or give it real modules"
                ),
            )
