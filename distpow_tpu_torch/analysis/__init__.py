"""distpow-lint — the port's project-native static analysis.

The port's correctness rests on invariants that live in comments and
code review memory: lock discipline around device dispatch and RPC, the
16-action trace vocabulary that reference parity depends on, the
metrics-counter registry, config-key agreement between readers and the
``runtime/config.py`` dataclasses, host-sync discipline on the hot
path, and never-silent exception handling in the protocol planes.  This
package is the port's own copy of the reference's ``analysis/``
(``distpow_tpu/analysis/``, catalog in docs/LINT.md): a self-contained
AST rule engine (stdlib only, no ``torch`` import) with one module per
rule, the same 17 rule IDs in the same order, line-level suppression
via ``# distpow: ok <rule-id> -- <justification>``, JSON and human
output, and an exit-code contract CI can gate on
(``python -m distpow_tpu_torch.cli.lint``; the ``lint``-marked test
``tests/test_torch_lint.py`` holds the port's tree clean).  The two
device rules (``hot-path-host-sync``, ``relaunch-loop-sync``) are
written in PyTorch's terms; the other fifteen are the reference's.
"""

from .engine import (  # noqa: F401
    PACKAGE_ROOT,
    Finding,
    ProjectContext,
    build_context,
    run_analysis,
)
