"""config-key-sync — config keys read anywhere must be declared fields.

Node configs are CamelCase-keyed JSON deserialized into the
``runtime/config.py`` dataclasses; ``from_dict`` silently ignores
unknown keys (deliberate forward compatibility on the WIRE), so a
consumer reading a key the dataclasses don't declare —
``config.BatchSzie``, ``getattr(config, "CacheFiIe", "")`` — gets an
AttributeError at that code path's first execution, or worse, the
getattr default forever.  This rule closes the loop statically: any
CamelCase attribute read/write on a config-shaped receiver (a name
``config``/``cfg``, or an attribute chain ending in ``.config``), and
any ``getattr(config, "Key", ...)`` string key, must be a declared
field of one of the config dataclasses.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ._util import is_module, terminal_name

RULE_ID = "config-key-sync"
DESCRIPTION = (
    "CamelCase attributes on config objects must exist as fields on "
    "the runtime/config.py dataclasses"
)

CONFIG_RECEIVERS = frozenset({"config", "cfg"})


def _is_config_receiver(node: ast.AST) -> bool:
    name = terminal_name(node)
    return name in CONFIG_RECEIVERS


def check(module, context) -> Iterator:
    if not context.config_fields:
        return  # no dataclasses parsed (fixture tree without config.py)
    if is_module(module.path, "runtime/config.py"):
        return
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Attribute) and \
                _is_config_receiver(node.value):
            key = node.attr
            if key[:1].isupper() and key not in context.config_fields:
                yield module.finding(
                    RULE_ID, node,
                    f"config key {key!r} is not a field on any "
                    f"runtime/config.py dataclass — typo, or declare it "
                    f"there (from_dict ignores unknown JSON keys, so an "
                    f"undeclared read can never be satisfied)",
                )
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "getattr" and len(node.args) >= 2 and \
                _is_config_receiver(node.args[0]) and \
                isinstance(node.args[1], ast.Constant) and \
                isinstance(node.args[1].value, str):
            key = node.args[1].value
            if key[:1].isupper() and key not in context.config_fields:
                yield module.finding(
                    RULE_ID, node,
                    f"getattr config key {key!r} is not a field on any "
                    f"runtime/config.py dataclass — the default would be "
                    f"returned forever",
                )
