"""The port's sha256, sha256d, sha1 and ripemd160 models against hashlib and
the JAX package's twins, and the packing and difficulty masks of the
big-endian models against the JAX package's.  Integer hashing: every
comparison is exact equality."""

import dataclasses
import hashlib
import struct

import numpy as np
import pytest
import torch

from distpow_tpu.models import registry as jax_registry
from distpow_tpu.models import ripemd160_py as jax_ripemd160
from distpow_tpu.models import sha1_jax, sha256_jax, sha256d_jax
from distpow_tpu.ops import difficulty as jax_difficulty
from distpow_tpu.ops import packing as jax_packing
from distpow_tpu.ops import search_step as jax_search_step
from distpow_tpu_torch.models import puzzle, ripemd160, sha1, sha256, sha256d
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops import difficulty, packing
from distpow_tpu_torch.ops.search_step import mask_words_for

MODELS = ("sha256", "sha256d", "sha1", "ripemd160")
# model -> (pure-Python module of the port, JAX twin module)
TWINS = {"sha256": (sha256, sha256_jax), "sha1": (sha1, sha1_jax),
         "ripemd160": (ripemd160, jax_ripemd160)}


def _digest(name, msg):
    h = puzzle.new_hash(name)
    h.update(msg)
    return h.digest()


def _random(seed, n, state_words):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 1 << 32, size=(n, state_words), dtype=np.uint64)
    words = rng.integers(0, 1 << 32, size=(n, 16), dtype=np.uint64)
    return states.astype(np.int64), words.astype(np.int64)


@pytest.mark.parametrize("name", ["sha256", "sha1", "ripemd160"])
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_compress_matches_jax_py_compress(name, seed):
    model = get_hash_model(name)
    port, twin = TWINS[name]
    s = len(model.init_state)
    states, words = _random(seed, 32, s)
    t_state = [torch.from_numpy(states[:, i]) for i in range(s)]
    t_words = [torch.from_numpy(words[:, g]) for g in range(16)]
    got = np.stack([t.numpy() for t in model.compress(t_state, t_words)], axis=1)
    fmt = "<16I" if model.word_byteorder == "little" else ">16I"
    for row in range(32):
        block = struct.pack(fmt, *(int(w) for w in words[row]))
        st = tuple(int(x) for x in states[row])
        want = twin.py_compress(st, block)
        assert tuple(int(x) for x in got[row]) == want
        assert port.py_compress(st, block) == want


@pytest.mark.parametrize("name", MODELS)
def test_constant_words_fold_like_tensor_words(name):
    """Constant (int) message words give what the all-tensor form gives."""
    model = get_hash_model(name)
    s = len(model.init_state)
    states, words = _random(7, 8, s)
    t_state = [torch.from_numpy(states[:, i]) for i in range(s)]
    mixed = [int(words[0, g]) if g % 3 else torch.from_numpy(words[:, g]) for g in range(16)]
    const = words.copy()
    for g in range(16):
        if g % 3:
            const[:, g] = words[0, g]
    tensors = [torch.from_numpy(const[:, g]) for g in range(16)]
    finalize = model.finalize or (lambda st: st)
    for a, b in zip(finalize(model.compress(t_state, mixed)),
                    finalize(model.compress(t_state, tensors))):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 65, 119, 120, 200])
def test_torch_tail_digest_matches_hashlib(name, length):
    """Absorb on the host, hash the padded tail with the torch compression
    (and finalize), compare with hashlib."""
    model = get_hash_model(name)
    msg = np.random.default_rng(length).integers(0, 256, size=length, dtype=np.uint8).tobytes()
    state, rem, absorbed = model.py_absorb(msg)
    assert absorbed == len(msg) - len(rem)
    tail = rem + b"\x80"
    tail += b"\x00" * ((-len(tail) - 8) % 64) + (8 * length).to_bytes(8, model.length_byteorder)
    fmt = "<16I" if model.word_byteorder == "little" else ">16I"
    st = tuple(torch.tensor(x, dtype=torch.int64) for x in state)
    for i in range(0, len(tail), 64):
        st = model.compress(st, [torch.tensor(w, dtype=torch.int64)
                                 for w in struct.unpack(fmt, tail[i:i + 64])])
    if model.finalize is not None:
        st = model.finalize(st)
    assert model.state_to_digest([int(x) for x in st]) == _digest(name, msg)


@pytest.mark.parametrize("length", [0, 3, 55, 56, 64, 100, 130])
def test_py_digests_match_hashlib_and_jax(length):
    msg = np.random.default_rng(200 + length).integers(0, 256, size=length,
                                                       dtype=np.uint8).tobytes()
    assert sha256.py_digest(msg) == hashlib.sha256(msg).digest() == sha256_jax.py_digest(msg)
    assert sha1.py_digest(msg) == hashlib.sha1(msg).digest() == sha1_jax.py_digest(msg)
    assert ripemd160.py_digest(msg) == jax_ripemd160.py_digest(msg) == _digest("ripemd160", msg)
    assert ripemd160.Ripemd160(msg).digest() == jax_ripemd160.Ripemd160(msg).digest()
    for name, (port, twin) in TWINS.items():
        assert port.py_absorb(msg) == twin.py_absorb(msg), name
    first = struct.unpack(">8I", hashlib.sha256(msg).digest())
    assert sha256d.py_finalize(first) == sha256d_jax.py_finalize(first)
    assert get_hash_model("sha256d").state_to_digest(sha256d.py_finalize(first)) == \
        hashlib.sha256(hashlib.sha256(msg).digest()).digest()


def test_constants_match_jax():
    assert sha256.SHA256_K == sha256_jax.SHA256_K and sha256.SHA256_INIT == sha256_jax.SHA256_INIT
    assert sha1.SHA1_K == sha1_jax.SHA1_K and sha1.SHA1_INIT == sha1_jax.SHA1_INIT
    assert sha256d.SECOND_BLOCK_TAIL_WORDS == sha256d_jax.SECOND_BLOCK_TAIL_WORDS
    assert (ripemd160.KL, ripemd160.KR, ripemd160.RL, ripemd160.RR, ripemd160.SL, ripemd160.SR) \
        == (jax_ripemd160._KL, jax_ripemd160._KR, jax_ripemd160._RL, jax_ripemd160._RR,
            jax_ripemd160._SL, jax_ripemd160._SR)
    assert ripemd160.RIPEMD160_INIT == jax_ripemd160.RIPEMD160_INIT
    rng = np.random.default_rng(3)
    for j in range(80):
        x, y, z = (int(v) for v in rng.integers(0, 1 << 32, size=3))
        assert ripemd160.round_f(j, x, y, z) == jax_ripemd160._f(j, x, y, z) & 0xFFFFFFFF


@pytest.mark.parametrize("name", MODELS)
def test_registry_fields_match_jax(name):
    got, want = get_hash_model(name), jax_registry.get_hash_model(name)
    for field in ("name", "block_bytes", "digest_words", "word_byteorder",
                  "length_byteorder", "init_state", "cost_ops", "length_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.finalize is None) == (want.finalize is None)
    assert (got.py_finalize is None) == (want.py_finalize is None)


def test_new_hash_serves_every_model():
    msg = b"\x01\x02\x03\x04\x05"
    assert _digest("sha256d", msg) == hashlib.sha256(hashlib.sha256(msg).digest()).digest()
    h = puzzle.new_hash("sha256d")
    h.update(msg[:2])
    c = h.copy()
    c.update(msg[2:])
    assert c.hexdigest() == _digest("sha256d", msg).hex()
    assert puzzle.check_secret(msg[:4], msg[4:], 0, "ripemd160")
    assert puzzle.hash_hex(msg[:4], msg[4:], "sha1") == hashlib.sha1(msg).hexdigest()


def test_new_hash_falls_back_to_the_python_ripemd160(monkeypatch):
    """An OpenSSL 3 host without the legacy provider raises for ripemd160;
    new_hash then hands out the pure-Python object."""
    real = hashlib.new

    def no_ripemd(name, *args, **kw):
        if name == "ripemd160":
            raise ValueError("unsupported hash type ripemd160")
        return real(name, *args, **kw)

    monkeypatch.setattr(hashlib, "new", no_ripemd)
    h = puzzle.new_hash("ripemd160")
    assert isinstance(h, ripemd160.Ripemd160)
    h.update(b"abc")
    # the RIPEMD-160 paper's Appendix B vector
    assert h.hexdigest() == "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"
    with pytest.raises(ValueError):
        puzzle.new_hash("whirlpool-not-a-hash")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("width", [0, 1, 4])
def test_tail_spec_matches_jax(name, width):
    rng = np.random.default_rng(width)
    model, jmodel = get_hash_model(name), jax_registry.get_hash_model(name)
    for extra in (b"", b"\x07\x08"):
        for nonce_len in range(0, 131, 3):
            nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
            got = packing.build_tail_spec(nonce, width, model, extra)
            want = jax_packing.build_tail_spec(nonce, width, jmodel, extra)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), (nonce_len, extra)


@pytest.mark.parametrize("name", MODELS)
def test_nibble_masks_and_mask_words_match_jax(name):
    model, jmodel = get_hash_model(name), jax_registry.get_hash_model(name)
    for d in range(0, model.max_difficulty + 1):
        assert difficulty.nibble_masks(d, model) == jax_difficulty.nibble_masks(d, jmodel)
        assert mask_words_for(d, model) == jax_search_step.mask_words_for(d, jmodel)
    with pytest.raises(ValueError):
        difficulty.nibble_masks(model.max_difficulty + 1, model)
