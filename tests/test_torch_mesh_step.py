"""The port's mesh step against the JAX package's, on the CPU: the port's
mesh step factory (``_cuda_mesh_step_factory``, whose kernel wrapper runs
the plain version on CPU tensors) on logical CPU shards
(``make_mesh(["cpu"] * n)``) against the reference's ``_mesh_step_factory``
on ``make_mesh(jax.devices()[:n])`` (the 8 CPU devices ``conftest.py``
forces), for all nine models, 1, 2, 3, 4 and 8 shards, both regimes, widths
1-4, one- and two-block tails: the same coverage and the same global
first-hit index, exactly.  The reference's non-power-of-two form runs one
sub-batch a launch, so those cases ask for one; the others for more.  This
file holds the models of 64-byte blocks;
``test_torch_mesh_wide_step.py`` runs the same cases for the 64-bit ones.
The rest of the mesh's tests are in ``test_torch_mesh.py``.
"""

import jax
import numpy as np
import pytest

from distpow_tpu.models.registry import get_hash_model as ref_model
from distpow_tpu.parallel import mesh_search as ref_mesh
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops.operands import u32_value
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.parallel import mesh_search

# the models of 64-byte blocks; the others are in test_torch_mesh_wide_step.py
MODELS = ("md5", "sha256", "sha256d", "sha1", "ripemd160")

# (shards, tb_lo, tbc, width, launch steps, two-block tail): 1 shard; the
# thread-byte split over 2 and 8 shards; the chunk split of a run of 2 over
# 4; the non-power-of-two form (3 shards, a chunk split of the full run) at
# one step
STEP_CASES = [
    (1, 0, 256, 1, 2, False),
    (2, 64, 64, 2, 2, True),
    (4, 16, 2, 3, 3, False),
    (8, 0, 256, 4, 2, False),
    (3, 0, 256, 3, 1, True),
]
BATCH = 1 << 13


def _cpu_mesh(n):
    return mesh_search.make_mesh(["cpu"] * n)


def _jax_mesh(n):
    return ref_mesh.make_mesh(jax.devices()[:n])


def _nonce(model_name, case, two_blocks):
    rng = np.random.default_rng(len(model_name) * 100 + case)
    n_len = get_hash_model(model_name).block_bytes - 1 if two_blocks else 4 + case
    return rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes()


def check_step_case(model_name, case):
    """The port's mesh factory (plain on CPU tensors) against the
    reference's XLA mesh factory: same coverage, same global first-hit
    index, at two cursors and two difficulties (the higher one mostly
    misses)."""
    n_dev, tb_lo, tbc, width, steps, two_blocks = STEP_CASES[case]
    nonce = _nonce(model_name, case, two_blocks)
    model, rmodel = get_hash_model(model_name), ref_model(model_name)
    target = max(1, BATCH // tbc)
    results = []
    # (difficulty, cursors): the segment's start and a launch past its end
    for d, cursors in ((2, (256 ** (width - 1), 256 ** width - 3)), (4, (256 ** (width - 1),))):
        ref = ref_mesh._mesh_step_factory(nonce, d, tb_lo, tbc, rmodel, _jax_mesh(n_dev),
                                          ref_mesh.AXIS)
        ref_step, ref_chunks = ref(width, b"", target, steps)
        step, chunks = mesh_search._cuda_mesh_step_factory(
            nonce, d, tb_lo, tbc, model, _cpu_mesh(n_dev))(width, b"", target, steps)
        assert chunks == ref_chunks
        for chunk0 in cursors:
            want = int(ref_step(np.uint32(chunk0)))
            assert u32_value(step(chunk0)) == want, (d, chunk0)
            results.append(want)
    assert any(r != 0xFFFFFFFF for r in results)
    # the tail shape the case names
    assert build_tail_spec(nonce, width, model).n_blocks == (2 if two_blocks else 1)


@pytest.mark.parametrize("model_name", MODELS)
@pytest.mark.parametrize("case", range(len(STEP_CASES)))
def test_mesh_step_matches_the_reference_mesh_step(model_name, case):
    check_step_case(model_name, case)
