"""``tools/row_copy.py``'s blocking form of the scheduler's row copy builds
the same group operands as ``group_operands``, so the tool times the copy
alone."""

import numpy as np
import torch

from distpow_tpu_torch.ops.operands import group_operands
from distpow_tpu_torch.tools.row_copy import blocking_group_operands


def test_blocking_form_builds_the_same_operands():
    rng = np.random.default_rng(6)
    n, rows = 3, []
    for shape in ((n, 4), (n, 2, 16), (n, 4), (n,), (n,), (n,)):
        rows.append(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64))
    want = group_operands(*rows, device="cpu")
    got = blocking_group_operands(*rows, device="cpu")
    for name in ("init", "base", "masks", "tb_lo", "log_tbc", "chunk0"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert getattr(got, name).dtype == torch.int32
