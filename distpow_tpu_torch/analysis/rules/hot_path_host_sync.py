"""hot-path-host-sync — no host synchronization inside the device path.

The pipelined driver (``parallel/search.py``) exists to keep the card
busy: the host prepares launch N+1 while the card crunches launch N,
and the ONLY sanctioned sync point is the FIFO drain (``drain_one``),
which waits on the oldest launch's CUDA event (``search``'s ``block``)
or polls it (``persistent_search``'s ``poll``).  A stray ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``.synchronize()`` or
``torch.cuda.synchronize()`` inside ``ops/`` or the driver serializes
the pipeline — one launch in flight instead of ``pipeline_depth`` —
which is invisible to every correctness test and only shows up as a
silent serving-rate regression on the card.  Deliberate sync points (a
warmup that *wants* to block, the drain itself) are suppressed with the
justification inline.

The reference rule (``distpow_tpu/analysis/rules/hot_path_host_sync.py``)
is written in JAX's terms; this one keeps its ID, scope and shape in
PyTorch's.  Which torch name stands in for which JAX name:

* ``.item()`` is shared by both;
* ``.tolist()``, ``.cpu()`` and ``.numpy()`` stand in for
  ``jax.device_get`` (a device value copied to the host);
* ``.synchronize()`` (a ``torch.cuda.Event``, ``torch.cuda.Stream``)
  and ``torch.cuda.synchronize(...)`` stand in for
  ``.block_until_ready()``;
* ``np.asarray``/``np.array`` are flagged, as in the reference, unless
  their argument is plainly host data: a literal, a display (list,
  tuple, set, dict), a comprehension, or a call that names a numpy
  ``dtype=`` (a cast of host values into numpy: a CUDA tensor there
  raises instead of syncing).  This stands in for the reference's
  exemption of ``jnp.asarray``, which is device-side.

``jax.device_get`` and ``.block_until_ready()`` stay in the flagged
set, so a JAX-style sync carried into the port is caught too, and the
reference's fixture corpus gives the same findings under both rules.

Scope: ``distpow_tpu_torch/ops/`` and ``distpow_tpu_torch/parallel/search.py``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ._util import dotted_name, in_dirs, is_module, receiver_name

RULE_ID = "hot-path-host-sync"
DESCRIPTION = (
    "no .item()/.tolist()/.cpu()/.numpy()/.synchronize()/np.asarray "
    "inside ops/ or the pipelined driver"
)

SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize",
                        "block_until_ready"})
NUMPY_RECEIVERS = frozenset({"np", "numpy"})
NUMPY_SYNC_FNS = frozenset({"asarray", "array"})
_HOST_LITERALS = (ast.Constant, ast.List, ast.Tuple, ast.Set, ast.Dict,
                  ast.ListComp, ast.SetComp, ast.DictComp,
                  ast.GeneratorExp)


def _in_scope(path: str) -> bool:
    return in_dirs(path, "ops") or is_module(path, "parallel/search.py")


def _plainly_host(call: ast.Call) -> bool:
    """``np.asarray(x)``'s argument is host data by its form: a literal,
    a display or comprehension, or the call casts to a numpy dtype."""
    if call.args and isinstance(call.args[0], _HOST_LITERALS):
        return True
    for kw in call.keywords:
        if kw.arg == "dtype" and \
                receiver_name(kw.value) in NUMPY_RECEIVERS:
            return True
    return False


def check(module, context) -> Iterator:
    if not _in_scope(module.path):
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not isinstance(func, ast.Attribute):
            continue
        recv = receiver_name(func)
        full = dotted_name(func)
        if func.attr in SYNC_ATTRS:
            yield module.finding(
                RULE_ID, node,
                f".{func.attr}() forces a host sync inside the device "
                f"hot path — it serializes the launch pipeline; drain "
                f"through the driver's FIFO (its CUDA event) instead, or "
                f"suppress with why this sync is intended",
            )
        elif recv in NUMPY_RECEIVERS and func.attr in NUMPY_SYNC_FNS:
            if _plainly_host(node):
                continue
            yield module.finding(
                RULE_ID, node,
                f"{full}(...) copies device values to host inside the "
                f"hot path — keep the value a torch tensor on its "
                f"device, or move the copy out of the dispatch loop",
            )
        elif full == "jax.device_get":
            yield module.finding(
                RULE_ID, node,
                "jax.device_get(...) blocks on device results inside "
                "the hot path — drain through the driver's FIFO",
            )
