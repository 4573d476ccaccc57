"""The port's plain search step for sha512, sha384, sha3_256 and blake2b_256
(on the CPU) against the JAX package's XLA step and its eager tiles.

Both packages are fed from one source: the JAX ``step_operands`` output,
as numpy arrays, goes through ``operands_from_numpy``.  The comparison is
the first-hit flat index (or the live digest words), exactly.  The Pallas
kernel itself cannot run here for these four models: interpret mode
refuses their tiles by design (``md5_pallas.py`` ``INTERPRET_XLA_FALLBACK``),
so the tiles run eagerly, as ``tests/test_pallas.py`` runs them."""

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

MODELS = ("sha512", "sha384", "sha3_256", "blake2b_256")


def _cases(block_bytes):
    """(label, (nonce_len, width, difficulty, tb_lo, tbc, chunks, launch_steps,
    chunk0, extra)) on a grid of the model's own block size B."""
    b = block_bytes
    return [
        ("one_block", (4, 1, 2, 0, 256, 4, 1, 1, b"")),
        ("steps3", (4, 2, 2, 64, 64, 16, 3, 256, b"")),
        ("non_pow2", (13, 2, 2, 0, 96, 24, 1, 256, b"")),
        # run at bytes B-3..B: two blocks, crossing the boundary
        ("straddle", (b - 3, 3, 2, 0, 96, 8, 3, 65536, b"")),
        # run at B-4..B-1: sha512/384 and sha3 take a second block (sha3's
        # holds the padding alone), blake2b fills exactly one final block
        ("block_end", (b - 4, 3, 2, 128, 128, 16, 1, 65536, b"")),
        ("absorbed", (b + 100, 2, 2, 32, 32, 64, 1, 256, b"")),
        ("extra", (5, 4, 2, 0, 256, 4, 1, 0, b"\x01")),
        ("miss", (4, 1, 12, 0, 256, 4, 1, 1, b"")),
        ("width0", (4, 0, 1, 0, 256, 1, 1, 0, b"")),
        ("width0_non_pow2", (b - 2, 0, 1, 3, 96, 1, 1, 0, b"")),
    ]


LABELS = [label for label, _ in _cases(128)]


def _nonce(n):
    return np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("name", MODELS)
def test_plain_step_and_wrapper_match_jax_xla_step(name, label):
    """The port's plain step, its serving step and the kernel wrapper's CPU
    path all give the JAX XLA step's first hit, from the JAX operands."""
    model, jmodel = get_hash_model(name), jax_registry.get_hash_model(name)
    n_len, width, d, tb_lo, tbc, chunks, k, chunk0, extra = dict(_cases(model.block_bytes))[label]
    nonce = _nonce(n_len)
    want = int(jax_step.cached_search_step(
        nonce, width, d, tb_lo, tbc, chunks, name, extra, k)(jnp.uint32(chunk0)))

    spec = jax_packing.build_tail_spec(nonce, width, jmodel, extra)
    if label in ("straddle", "block_end"):
        assert spec.n_blocks == (1 if (name, label) == ("blake2b_256", "block_end") else 2)
    init, base, masks = (np.asarray(a) for a in jax_step.step_operands(spec, d, jmodel))
    ops = operands_from_numpy(init, base, masks, tb_lo, tbc)
    assert tuple(ops.base.shape) == (spec.n_blocks, model.row_words)
    if width == 0:
        got = search_step.plain_search_w0(ops, spec.tb_loc, spec.chunk_locs, model=model)
        batch, steps = tbc, 1
    else:
        batch, steps = chunks * tbc, k
        got = search_step.plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, steps,
                                       model=model)
    assert u32_value(got) == want
    assert (want == search_step.SENTINEL) == (label == "miss")

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


def _tile(name):
    from distpow_tpu.ops import md5_pallas

    return {"sha512": md5_pallas._sha512_tile, "sha384": md5_pallas._sha384_tile,
            "sha3_256": md5_pallas._sha3_tile, "blake2b_256": md5_pallas._blake2b_tile}[name]


@pytest.mark.parametrize("name", MODELS)
def test_torch_compress_matches_jax_tile_every_mask_bucket(name):
    """The JAX tile of each model, run eagerly on random rows (blake2b_256's
    parameter words random too) and a random prefix state, and the port's
    torch compress agree on every live digest word of every mask-word
    bucket; the tile elides exactly the dead words: the sha512/384 tile
    whole 64-bit words before the first live one, the others each word
    before the ``mw`` trailing ones."""
    model = get_hash_model(name)
    rng = np.random.default_rng(len(name))
    words = rng.integers(0, 1 << 32, size=(model.row_words, 16), dtype=np.uint64)
    words = words.astype(np.uint32)
    init = [int(x) for x in rng.integers(0, 1 << 32, size=len(model.init_state))]
    state = model.compress(tuple(init), [torch.from_numpy(w.astype(np.int64)) for w in words])
    want = np.stack([np.asarray(s) for s in state])
    j_words = [jnp.asarray(w) for w in words]
    j_init = [jnp.uint32(x) for x in init]
    d = model.digest_words
    pairs = name in ("sha512", "sha384")
    for mw in range(1, d + 1):
        out = _tile(name)(j_words, j_init, mw)
        assert len(out) == d
        first_live = 2 * ((d - mw) // 2) if pairs else d - mw
        for j in range(d):
            if j < first_live:
                assert out[j] is None, (mw, j)
            else:
                np.testing.assert_array_equal(np.asarray(out[j]).astype(np.int64), want[j])
