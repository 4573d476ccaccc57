"""The port's tail packing and difficulty masks against the JAX package's.
Exact equality throughout."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from distpow_tpu.models.registry import MD5 as JAX_MD5
from distpow_tpu.ops import difficulty as jax_difficulty
from distpow_tpu.ops import packing as jax_packing
from distpow_tpu.ops import search_step as jax_search_step
from distpow_tpu_torch.models.registry import MD5, get_hash_model
from distpow_tpu_torch.ops import difficulty, packing
from distpow_tpu_torch.ops.search_step import mask_words_for


@pytest.mark.parametrize("width", [0, 1, 2, 3, 4])
def test_tail_spec_matches_jax(width):
    rng = np.random.default_rng(width)
    for extra in (b"", b"\x07", b"\x01\x02\x03"):
        for nonce_len in range(0, 131):
            nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
            got = packing.build_tail_spec(nonce, width, MD5, extra)
            want = jax_packing.build_tail_spec(nonce, width, JAX_MD5, extra)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), (nonce_len, extra)


@pytest.mark.parametrize("nonce_len", [0, 4, 54, 55, 59, 62, 63, 64, 100])
def test_make_words_hash_matches_hashlib(nonce_len):
    rng = np.random.default_rng(100 + nonce_len)
    nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
    for width in range(5):
        spec = packing.build_tail_spec(nonce, width, MD5)
        tb = torch.from_numpy(rng.integers(0, 256, size=16))
        chunk = torch.from_numpy(rng.integers(0, 256 ** width, size=16)) if width \
            else torch.zeros(16, dtype=torch.int64)
        state = spec.init_state
        for words in packing.make_words(spec, tb, chunk):
            state = MD5.compress(state, words)
        for i in range(16):
            msg = packing.pack_reference_bytes(nonce, int(tb[i]), int(chunk[i]), width)
            digest = MD5.state_to_digest([int(s[i]) for s in state])
            assert digest == hashlib.md5(msg).digest()


def test_nibble_masks_and_mask_words_match_jax():
    for d in range(0, 33):
        assert difficulty.nibble_masks(d, MD5) == jax_difficulty.nibble_masks(d, JAX_MD5)
        assert mask_words_for(d, MD5) == jax_search_step.mask_words_for(d, JAX_MD5)
    with pytest.raises(ValueError):
        difficulty.nibble_masks(33, MD5)
    with pytest.raises(ValueError):
        difficulty.nibble_masks(-1, MD5)


def test_meets_difficulty_matches_trailing_nibbles():
    from distpow_tpu_torch.models.puzzle import count_trailing_zero_nibbles

    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, size=(4, 512), dtype=np.uint64).astype(np.int64)
    words[3, :256] &= ~0xFFFF  # plenty of trailing zeros in half the rows
    state = [torch.from_numpy(w) for w in words]
    for d in (0, 1, 2, 3, 4, 9):
        hit = difficulty.meets_difficulty(state, difficulty.nibble_masks(d, MD5))
        for i in range(0, 512, 7):
            digest = MD5.state_to_digest([int(w[i]) for w in words])
            assert bool(hit[i]) == (count_trailing_zero_nibbles(digest) >= d)


def test_registry_serves_md5_and_names_the_queue_for_the_rest():
    """Named for the first slice; the registry now serves all nine models of
    the reference registry and raises for an unknown one."""
    from distpow_tpu.models import registry as jax_registry

    assert get_hash_model("MD5") is MD5
    names = ("md5", "sha256", "sha256d", "sha1", "ripemd160", "sha512", "sha384", "sha3_256",
             "blake2b_256")
    for name in names:
        assert get_hash_model(name.upper()).name == name
    assert set(names) == set(jax_registry._REGISTRY)
    with pytest.raises(ValueError, match="unknown"):
        get_hash_model("crc32")
