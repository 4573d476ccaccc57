"""The port's MD5 (int64-carried torch words and the pure-Python twin)
against the JAX package's ``md5_compress`` and hashlib.  Integer hashing:
every comparison is exact equality."""

import hashlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distpow_tpu.models import md5_jax
from distpow_tpu_torch.models import md5


def _random_blocks(seed, n):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 1 << 32, size=(n, 4), dtype=np.uint64).astype(np.uint32)
    words = rng.integers(0, 1 << 32, size=(n, 16), dtype=np.uint64).astype(np.uint32)
    return states, words


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_compress_matches_jax_and_python(seed):
    states, words = _random_blocks(seed, 64)
    t_state = [torch.from_numpy(states[:, i].astype(np.int64)) for i in range(4)]
    t_words = [torch.from_numpy(words[:, g].astype(np.int64)) for g in range(16)]
    got = np.stack([t.numpy() for t in md5.md5_compress(t_state, t_words)], axis=1)

    j_state = tuple(jnp.asarray(states[:, i]) for i in range(4))
    j_words = [jnp.asarray(words[:, g]) for g in range(16)]
    want = np.stack([np.asarray(w) for w in md5_jax.md5_compress(j_state, j_words)], axis=1)
    np.testing.assert_array_equal(got, want.astype(np.int64))

    for row in range(0, 64, 9):
        block = struct.pack("<16I", *(int(w) for w in words[row]))
        st = tuple(int(s) for s in states[row])
        assert md5.py_compress(st, block) == tuple(int(x) for x in got[row])
        assert md5.py_compress(st, block) == md5_jax.py_compress(st, block)


def test_constant_words_fold_like_tensor_words():
    """Constant (int) message words fold K[i] + m; the result equals the
    all-tensor form."""
    states, words = _random_blocks(3, 8)
    t_state = [torch.from_numpy(states[:, i].astype(np.int64)) for i in range(4)]
    mixed = [int(words[0, g]) if g % 3 else torch.from_numpy(words[:, g].astype(np.int64))
             for g in range(16)]
    const_rows = words.copy()
    for g in range(16):
        if g % 3:
            const_rows[:, g] = words[0, g]
    tensors = [torch.from_numpy(const_rows[:, g].astype(np.int64)) for g in range(16)]
    for a, b in zip(md5.md5_compress(t_state, mixed), md5.md5_compress(t_state, tensors)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 65, 119, 120, 128, 200])
def test_absorb_and_digest_match_hashlib_and_jax(length):
    msg = np.random.default_rng(length).integers(0, 256, size=length, dtype=np.uint8).tobytes()
    assert md5.py_digest(msg) == hashlib.md5(msg).digest()
    assert md5.py_absorb(msg) == md5_jax.py_absorb(msg)
    assert md5.MD5_K == md5_jax.MD5_K and md5.MD5_S == md5_jax.MD5_S


def test_torch_digest_of_absorbed_prefix_matches_hashlib():
    """Absorb a long prefix on the host, hash the padded tail with the
    torch compression, compare with hashlib."""
    rng = np.random.default_rng(7)
    for length in (70, 130, 191):
        msg = rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
        state, rem, _ = md5.py_absorb(msg)
        tail = rem + b"\x80"
        tail += b"\x00" * ((-len(tail) - 8) % 64) + struct.pack("<Q", 8 * length)
        st = tuple(torch.tensor(s, dtype=torch.int64) for s in state)
        for i in range(0, len(tail), 64):
            words = [torch.tensor(w, dtype=torch.int64)
                     for w in struct.unpack("<16I", tail[i:i + 64])]
            st = md5.md5_compress(st, words)
        digest = b"".join(int(w).to_bytes(4, "little") for w in st)
        assert digest == hashlib.md5(msg).digest()
