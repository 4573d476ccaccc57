"""The port's plain search step (on the CPU) against the JAX package's XLA
step and, once, its Pallas kernel in interpret mode.  Both packages are
fed from one source: the JAX ``step_operands`` output, as numpy arrays,
goes through ``operands_from_numpy``.  The comparison is the first-hit
flat index, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distpow_tpu.models.registry import MD5 as JAX_MD5
from distpow_tpu.ops import packing as jax_packing
from distpow_tpu.ops import search_step as jax_step
from distpow_tpu_torch.models.registry import MD5
from distpow_tpu_torch.ops import search_step
from distpow_tpu_torch.ops.hash_cuda import LAUNCHES, hash_search
from distpow_tpu_torch.ops.operands import operands_from_numpy, u32_value
from distpow_tpu_torch.ops.search_step import SENTINEL, _check_launch

# (nonce_len, width, difficulty, tb_lo, tbc, chunks, launch_steps, chunk0, extra)
CASES = [
    (4, 1, 2, 0, 256, 4, 1, 1, b""),            # one-block tail, pow2
    (4, 2, 3, 64, 64, 16, 3, 256, b""),         # sub-partition, launch_steps 3
    (13, 2, 2, 0, 96, 8, 1, 256, b""),          # non-pow2 tbc
    (13, 2, 2, 0, 96, 8, 3, 300, b""),          # non-pow2, launch_steps 3
    (56, 1, 2, 0, 256, 2, 1, 1, b""),           # two-block tail
    (60, 3, 3, 128, 128, 8, 3, 65536, b""),     # two blocks, tb in block 0
    (62, 4, 2, 0, 256, 4, 1, 1 << 24, b""),     # chunk straddles the blocks
    (100, 2, 2, 32, 32, 16, 1, 256, b""),       # absorbed prefix
    (5, 4, 2, 0, 256, 4, 1, 0, b"\x01"),        # extra_const_chunk
    (4, 1, 12, 0, 256, 4, 1, 1, b""),           # no hit: SENTINEL
    (4, 0, 1, 0, 256, 1, 1, 0, b""),            # width 0
    (4, 0, 2, 3, 5, 1, 1, 0, b""),              # width 0, small non-pow2 run
]


def _nonce(n):
    return np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_plain_step_first_hit_matches_jax_xla_step(case):
    n_len, width, d, tb_lo, tbc, chunks, k, chunk0, extra = case
    nonce = _nonce(n_len)
    want = int(jax_step.cached_search_step(
        nonce, width, d, tb_lo, tbc, chunks, "md5", extra, k)(jnp.uint32(chunk0)))

    spec = jax_packing.build_tail_spec(nonce, width, JAX_MD5, extra)
    init, base, masks = (np.asarray(a) for a in jax_step.step_operands(spec, d, JAX_MD5))
    ops = operands_from_numpy(init, base, masks, tb_lo, tbc)
    if width == 0:
        got = search_step.plain_search_w0(ops, spec.tb_loc, spec.chunk_locs, model=MD5)
        batch, steps = tbc, 1
    else:
        batch, steps = chunks * tbc, k
        got = search_step.plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, steps,
                                       model=MD5)
    assert u32_value(got) == want

    # the port's own serving step and the kernel wrapper's CPU path agree
    bound = search_step.cached_search_step(
        nonce, width, d, tb_lo, tbc, chunks, "md5", extra, k, "cpu")
    assert u32_value(bound(chunk0)) == want
    before = LAUNCHES["md5_search"].value
    wrapped = hash_search(MD5, ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, steps,
                          device="cpu")
    assert u32_value(wrapped) == want
    assert LAUNCHES["md5_search"].value == before  # the plain path launches no kernel


def test_sentinel_cases_are_hit_free():
    nonce = _nonce(4)
    bound = search_step.cached_search_step(nonce, 1, 32, 0, 256, 4, "md5", b"", 1, "cpu")
    assert u32_value(bound(1)) == SENTINEL
    assert bound(1).dim() == 0


def test_plain_step_matches_pallas_kernel_in_interpret_mode():
    """One Pallas interpret case, at the shape tests/test_pallas.py uses."""
    from distpow_tpu.ops.md5_pallas import build_pallas_search_step

    nonce = b"\x05\x06"
    step_p = build_pallas_search_step(nonce, 2, 2, 64, 64, 512, sublanes=8, interpret=True)
    spec = jax_packing.build_tail_spec(nonce, 2, JAX_MD5)
    ops = operands_from_numpy(
        *(np.asarray(a) for a in jax_step.step_operands(spec, 2, JAX_MD5)), 64, 64)
    for c0 in (256, 256 + 512):
        got = search_step.plain_search(ops, spec.tb_loc, spec.chunk_locs, c0, 512 * 64,
                                       model=MD5)
        assert u32_value(got) == int(step_p(jnp.uint32(c0)))


def test_check_launch_bound():
    _check_launch((1 << 31) - 1, 1)
    with pytest.raises(ValueError, match="2\\^31"):
        _check_launch(1 << 30, 2)
    with pytest.raises(ValueError, match="launch_steps"):
        _check_launch(256, 0)
    with pytest.raises(ValueError, match="2\\^31"):
        search_step.cached_search_step(b"\x01", 2, 2, 0, 256, 1 << 23, "md5", b"", 1, "cpu")


def test_step_returns_a_tensor_on_the_operand_device():
    bound = search_step.cached_search_step(b"\x01", 1, 1, 0, 256, 1, "md5", b"", 1, "cpu")
    out = bound(1)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
