"""The port's sha512, sha384, sha3_256 and blake2b_256 models against
hashlib and the JAX package: the torch compressions (64-bit words as pairs
of 32-bit words) against the JAX compressions, the pure-Python twins
against JAX's, packing (the sha3 and blake2 paddings, blake2b's parameter
words, sha512's 16-byte length field) field for field, and the registry.
Integer hashing: every comparison is exact equality."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from distpow_tpu.models import blake2b_py as jax_blake2b
from distpow_tpu.models import registry as jax_registry
from distpow_tpu.models import sha3_py as jax_sha3
from distpow_tpu.models import sha384_jax, sha512_py as jax_sha512
from distpow_tpu.ops import difficulty as jax_difficulty
from distpow_tpu.ops import packing as jax_packing
from distpow_tpu.ops import search_step as jax_search_step
from distpow_tpu_torch.models import blake2b, puzzle, sha3, sha384, sha512
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops import difficulty, packing
from distpow_tpu_torch.ops.search_step import mask_words_for

MODELS = ("sha512", "sha384", "sha3_256", "blake2b_256")
# model -> (the port's module, the JAX pure-Python twin)
TWINS = {"sha512": (sha512, jax_sha512), "sha384": (sha384, sha384_jax),
         "sha3_256": (sha3, jax_sha3), "blake2b_256": (blake2b, jax_blake2b)}


def _digest(name, msg):
    h = puzzle.new_hash(name)
    h.update(msg)
    return h.digest()


def _jax_compress(name):
    from distpow_tpu.models import blake2b_jax, sha3_jax, sha512_jax

    return {"sha512": sha512_jax.sha512_compress, "sha384": sha384_jax.sha384_compress,
            "sha3_256": sha3_jax.sha3_256_compress,
            "blake2b_256": blake2b_jax.blake2b_256_compress}[name]


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_compress_matches_jax_compress(name, seed):
    """Random prefix states and random rows (for blake2b_256 the parameter
    words too), as int64 tensors in the port and uint32 arrays in JAX."""
    import jax.numpy as jnp

    model = get_hash_model(name)
    rng = np.random.default_rng(seed)
    n = 32
    states = rng.integers(0, 1 << 32, size=(len(model.init_state), n), dtype=np.uint64)
    words = rng.integers(0, 1 << 32, size=(model.row_words, n), dtype=np.uint64)
    got = model.compress([torch.from_numpy(s.astype(np.int64)) for s in states],
                         [torch.from_numpy(w.astype(np.int64)) for w in words])
    want = _jax_compress(name)([jnp.asarray(s.astype(np.uint32)) for s in states],
                               [jnp.asarray(w.astype(np.uint32)) for w in words])
    assert len(got) == len(want) == len(model.init_state)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("name", MODELS)
def test_constant_words_fold_like_tensor_words(name):
    """Constant (int) words and an int state give what tensors give."""
    model = get_hash_model(name)
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, size=(model.row_words, 8), dtype=np.uint64).astype(np.int64)
    mixed = [int(words[g, 0]) if g % 3 else torch.from_numpy(words[g]) for g in range(len(words))]
    const = words.copy()
    for g in range(len(words)):
        if g % 3:
            const[g] = words[g, 0]
    tensors = [torch.from_numpy(const[g]) for g in range(len(words))]
    for a, b in zip(model.compress(model.init_state, mixed),
                    model.compress(model.init_state, tensors)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("length", [0, 1, 110, 111, 112, 127, 128, 129, 135, 136, 137,
                                    200, 255, 256, 300])
def test_digest_through_packing_matches_hashlib(name, length):
    """Absorb on the host, hash the packed tail (every width) with the
    torch compression, compare with hashlib; the lengths cross one and two
    block boundaries of each block size (128, 136)."""
    model = get_hash_model(name)
    rng = np.random.default_rng(length)
    nonce = rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
    for width in range(5):
        spec = packing.build_tail_spec(nonce, width, model)
        tb = torch.from_numpy(rng.integers(0, 256, size=8))
        chunk = torch.from_numpy(rng.integers(0, 256 ** width, size=8))
        state = spec.init_state
        for row in packing.make_words(spec, tb, chunk):
            state = model.compress(state, row)
        for i in range(8):
            msg = packing.pack_reference_bytes(nonce, int(tb[i]), int(chunk[i]), width)
            got = model.state_to_digest([int(torch.as_tensor(s).reshape(-1)[i]
                                             if torch.as_tensor(s).dim() else s)
                                         for s in state])
            assert got == _digest(name, msg), (width, i)


@pytest.mark.parametrize("length", [0, 3, 111, 112, 128, 129, 135, 136, 137, 272, 300])
def test_py_twins_match_hashlib_and_jax(length):
    msg = np.random.default_rng(200 + length).integers(0, 256, size=length,
                                                       dtype=np.uint8).tobytes()
    assert sha512.py_digest(msg) == hashlib.sha512(msg).digest() == jax_sha512.py_digest(msg)
    assert sha384.py_digest(msg) == hashlib.sha384(msg).digest() == sha384_jax.py_digest(msg)
    assert sha3.py_digest(msg) == hashlib.sha3_256(msg).digest() == jax_sha3.py_digest(msg)
    assert blake2b.py_digest(msg) == hashlib.blake2b(msg, digest_size=32).digest() \
        == jax_blake2b.py_digest(msg)
    for name, (port, twin) in TWINS.items():
        assert port.py_absorb(msg) == twin.py_absorb(msg), name


@pytest.mark.parametrize("name", MODELS)
def test_py_compress_matches_jax(name):
    port, twin = TWINS[name]
    model = get_hash_model(name)
    rng = np.random.default_rng(len(name))
    for _ in range(8):
        state = tuple(int(x) for x in rng.integers(0, 1 << 32, size=len(model.init_state)))
        block = rng.integers(0, 256, size=model.block_bytes, dtype=np.uint8).tobytes()
        if name == "blake2b_256":
            t = int(rng.integers(1, 1 << 40))
            assert port.py_compress(state, block, t=t) == twin.py_compress(state, block, t=t)
            assert port.py_compress(state, block, t=t, last=True) == \
                twin.py_compress(state, block, t=t, last=True)
            row = block + t.to_bytes(8, "little") + b"\xff" * 8
            assert port.py_compress(state, row) == twin.py_compress(state, row)
        else:
            assert port.py_compress(state, block) == twin.py_compress(state, block)


def test_blake2b_plain_block_needs_an_explicit_counter():
    state, block = blake2b.BLAKE2B_INIT, bytes(128)
    with pytest.raises(TypeError, match="t="):
        blake2b.py_compress(state, block)
    row = block + bytes(16)
    with pytest.raises(TypeError, match="do not also pass"):
        blake2b.py_compress(state, row, t=128)
    with pytest.raises(ValueError, match="128 or 144"):
        blake2b.py_compress(state, bytes(100), t=100)


def test_constants_match_jax():
    assert sha512.SHA512_K64 == jax_sha512.SHA512_K64
    assert sha512.SHA512_INIT64 == jax_sha512.SHA512_INIT64
    assert sha512.SHA512_INIT == jax_sha512.SHA512_INIT
    assert sha384.SHA384_INIT == sha384_jax.SHA384_INIT
    assert sha3.KECCAK_RC == jax_sha3.KECCAK_RC and sha3.KECCAK_ROT == jax_sha3.KECCAK_ROT
    assert sha3.SHA3_INIT == jax_sha3.SHA3_INIT
    assert blake2b.BLAKE2B_IV == jax_blake2b.BLAKE2B_IV
    assert blake2b.BLAKE2B_SIGMA == jax_blake2b.BLAKE2B_SIGMA
    assert blake2b.BLAKE2B_INIT == jax_blake2b.BLAKE2B_INIT
    for args in ((0, 5, 0, 1), (128, 130, 0, 2), (128, 130, 1, 2), (1 << 33, 7, 0, 1)):
        assert blake2b.block_param_words(*args) == jax_blake2b.block_param_words(*args)


@pytest.mark.parametrize("name", MODELS)
def test_registry_fields_match_jax(name):
    got, want = get_hash_model(name), jax_registry.get_hash_model(name)
    for field in ("name", "block_bytes", "digest_words", "word_byteorder", "length_byteorder",
                  "init_state", "cost_ops", "length_bytes", "padding", "param_words"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.row_words == got.words_per_block + got.param_words
    assert (got.block_param_words is None) == (want.block_param_words is None)
    assert got.finalize is None and want.finalize is None


def test_every_model_fills_the_new_fields():
    for name in jax_registry._REGISTRY:
        got, want = get_hash_model(name), jax_registry.get_hash_model(name)
        assert (got.padding, got.param_words, got.length_bytes) == \
            (want.padding, want.param_words, want.length_bytes), name


def test_new_hash_serves_blake2b_256():
    msg = b"\x01\x02\x03\x04\x05"
    assert _digest("blake2b_256", msg) == hashlib.blake2b(msg, digest_size=32).digest()
    assert puzzle.check_secret(msg[:4], msg[4:], 0, "blake2b_256")
    assert puzzle.hash_hex(msg[:4], msg[4:], "sha3_256") == hashlib.sha3_256(msg).hexdigest()
    secret = puzzle.python_search(msg[:4], 2, range(256), algo="blake2b_256")
    assert puzzle.check_secret(msg[:4], secret, 2, "blake2b_256")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("width", [0, 1, 2, 3, 4])
def test_tail_spec_matches_jax(name, width):
    """Field for field, nonce lengths 0-300: one- and two-block tails, the
    sha3 0x86 merge (a run ending at byte 134 of the rate), blake2b's t and
    f0 per row, sha512's 16-byte length field, absorbed prefixes."""
    rng = np.random.default_rng(width)
    model, jmodel = get_hash_model(name), jax_registry.get_hash_model(name)
    merged = 0
    for extra in (b"", b"\x07\x08"):
        for nonce_len in range(0, 301):
            nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
            got = packing.build_tail_spec(nonce, width, model, extra)
            want = jax_packing.build_tail_spec(nonce, width, jmodel, extra)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), (nonce_len, extra)
            assert all(len(row) == model.row_words for row in got.base_words)
            if name == "sha3_256":
                last = got.base_words[-1][-1]
                merged += last >> 24 == 0x86
    if name == "sha3_256":
        assert merged


@pytest.mark.parametrize("name", MODELS)
def test_nibble_masks_and_mask_words_match_jax(name):
    model, jmodel = get_hash_model(name), jax_registry.get_hash_model(name)
    for d in range(0, model.max_difficulty + 1):
        assert difficulty.nibble_masks(d, model) == jax_difficulty.nibble_masks(d, jmodel)
        assert mask_words_for(d, model) == jax_search_step.mask_words_for(d, jmodel)
    with pytest.raises(ValueError):
        difficulty.nibble_masks(model.max_difficulty + 1, model)
