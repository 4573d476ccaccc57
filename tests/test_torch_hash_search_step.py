"""The port's plain search step for sha256, sha256d, sha1 and ripemd160 (on
the CPU) against the JAX package's XLA step, its eager tiles and, for sha1
and ripemd160, its Pallas kernel in interpret mode.  Both packages are fed
from one source: the JAX ``step_operands`` output, as numpy arrays, goes
through ``operands_from_numpy``.  The comparison is the first-hit flat
index (or the live digest words), exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distpow_tpu.models import registry as jax_registry
from distpow_tpu.ops import packing as jax_packing
from distpow_tpu.ops import search_step as jax_step
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops import search_step
from distpow_tpu_torch.ops.hash_cuda import KERNELS, LAUNCHES, hash_search
from distpow_tpu_torch.ops.operands import operands_from_numpy, u32_value
from distpow_tpu_torch.ops.packing import build_tail_spec

MODELS = ("sha256", "sha256d", "sha1", "ripemd160")

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
@pytest.mark.parametrize("name", MODELS)
def test_plain_step_and_wrapper_match_jax_xla_step(name, case):
    """The port's plain step, its serving step and the kernel wrapper's CPU
    path all give the JAX XLA step's first hit, from the JAX operands."""
    n_len, width, d, tb_lo, tbc, chunks, k, chunk0, extra = case
    model, jmodel = get_hash_model(name), jax_registry.get_hash_model(name)
    nonce = _nonce(n_len)
    want = int(jax_step.cached_search_step(
        nonce, width, d, tb_lo, tbc, chunks, name, extra, k)(jnp.uint32(chunk0)))

    spec = jax_packing.build_tail_spec(nonce, width, jmodel, extra)
    init, base, masks = (np.asarray(a) for a in jax_step.step_operands(spec, d, jmodel))
    ops = operands_from_numpy(init, base, masks, tb_lo, tbc)
    assert ops.init.shape == (len(model.init_state),)
    if width == 0:
        got = search_step.plain_search_w0(ops, spec.tb_loc, spec.chunk_locs, model=model)
        batch, steps = tbc, 1
    else:
        batch, steps = chunks * tbc, k
        got = search_step.plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, steps,
                                       model=model)
    assert u32_value(got) == want

    bound = search_step.cached_search_step(
        nonce, width, d, tb_lo, tbc, chunks, name, extra, k, "cpu")
    assert u32_value(bound(chunk0)) == want
    if width:
        launches = LAUNCHES[KERNELS[name]]
        before = launches.value
        wrapped = hash_search(model, ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, steps,
                              device="cpu")
        assert u32_value(wrapped) == want
        assert launches.value == before  # the plain path launches no kernel


def test_plain_steps_take_no_default_model():
    """A call that forgets the model raises instead of hashing MD5."""
    model = get_hash_model("sha256")
    spec = build_tail_spec(b"\x01\x02", 1, model)
    ops = search_step.step_operands(spec, 1, model, 0, 256, "cpu")
    with pytest.raises(TypeError, match="model"):
        search_step.plain_search(ops, spec.tb_loc, spec.chunk_locs, 1, 256)
    with pytest.raises(TypeError, match="model"):
        search_step.plain_search_w0(ops, spec.tb_loc, spec.chunk_locs)


def _tile_inputs(name, seed, n=64):
    """The model, ``n`` random message blocks as 16 uint32 word columns,
    and a random prefix state."""
    model = get_hash_model(name)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(16, n), dtype=np.uint64).astype(np.uint32)
    init = rng.integers(0, 1 << 32, size=len(model.init_state), dtype=np.uint64)
    return model, words, [int(x) for x in init]


@pytest.mark.parametrize("name", MODELS)
def test_torch_compress_matches_jax_tile_every_mask_bucket(name):
    """The JAX tile of each model, run eagerly, and the port's torch
    compress (+ finalize) agree on every live digest word of every
    mask-word bucket; the tile elides exactly the dead words."""
    from distpow_tpu.ops import md5_pallas

    tile = {"sha256": md5_pallas._sha256_tile, "sha256d": md5_pallas._sha256d_tile,
            "sha1": md5_pallas._sha1_tile, "ripemd160": md5_pallas._ripemd160_tile}[name]
    model, words, init = _tile_inputs(name, len(name))
    state = model.compress(tuple(init), [torch.from_numpy(w.astype(np.int64)) for w in words])
    if model.finalize is not None:
        state = model.finalize(state)
    want = np.stack([np.asarray(s) for s in state])
    j_words = [jnp.asarray(w) for w in words]
    j_init = [jnp.uint32(x) for x in init]
    d = model.digest_words
    for mw in range(1, d + 1):
        out = tile(j_words, j_init, mw)
        for j in range(d):
            if j < d - mw:
                assert out[j] is None, (mw, j)
            else:
                np.testing.assert_array_equal(np.asarray(out[j]).astype(np.int64), want[j])


@pytest.mark.parametrize("name", ["sha1", "ripemd160"])
def test_plain_step_matches_pallas_kernel_in_interpret_mode(name):
    """The sha1 and ripemd160 Pallas kernels compile in seconds in interpret
    mode (the sha256 ones take minutes, tests/test_pallas.py), at the
    shape tests/test_pallas.py uses."""
    from distpow_tpu.ops.md5_pallas import build_pallas_search_step

    model, jmodel = get_hash_model(name), jax_registry.get_hash_model(name)
    nonce = b"\x01\x02\x03\x04"
    step_p = build_pallas_search_step(nonce, 1, 2, 0, 256, 8, model_name=name, sublanes=8,
                                      interpret=True)
    spec = jax_packing.build_tail_spec(nonce, 1, jmodel)
    ops = operands_from_numpy(
        *(np.asarray(a) for a in jax_step.step_operands(spec, 2, jmodel)), 0, 256)
    hits = 0
    for c0 in (1, 17):
        got = search_step.plain_search(ops, spec.tb_loc, spec.chunk_locs, c0, 8 * 256,
                                       model=model)
        want = int(step_p(jnp.uint32(c0)))
        assert u32_value(got) == want
        hits += want != search_step.SENTINEL
    assert hits
