"""Rule registry — one module per rule, each exposing ``RULE_ID``,
``DESCRIPTION`` and ``check(module, context)`` (and optionally
``scan_tree(root, rel_to, context)`` for directory-level rules).
Catalog with rationale and examples: docs/LINT.md.  The port's copy of
the reference's registry: the same 17 rules in the same order, with the
two device rules (``hot_path_host_sync``, ``relaunch_loop_sync``) in
PyTorch's terms."""

from . import (
    blocking_under_lock,
    bounded_queue,
    config_key_sync,
    dead_package,
    guarded_by,
    hot_path_host_sync,
    lock_order,
    metrics_registry,
    modulo_routing,
    relaunch_loop_sync,
    serial_rpc_fanout,
    silent_except,
    trace_vocabulary,
    transitive_blocking,
    unbounded_thread_spawn,
    unclosed_span,
    wall_clock_duration,
)

ALL_RULES = (
    blocking_under_lock,
    transitive_blocking,
    guarded_by,
    lock_order,
    bounded_queue,
    serial_rpc_fanout,
    unbounded_thread_spawn,
    modulo_routing,
    trace_vocabulary,
    metrics_registry,
    config_key_sync,
    hot_path_host_sync,
    relaunch_loop_sync,
    unclosed_span,
    wall_clock_duration,
    silent_except,
    dead_package,
)
