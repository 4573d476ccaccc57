"""The backends and the kernel wrapper for every model but md5 (sha256,
sha256d, sha1, ripemd160, sha512, sha384, sha3_256, blake2b_256), on the
CPU: the CUDA backend (whose wrapper takes the plain path for CPU tensors)
and the torch backend against ``PythonBackend`` and the JAX package's
driver, the layout helper in both byte orders and every block size, and
the wrapper's checks against the model.  Without a GPU the CUDA entry
points raise; the tests that say so skip on a machine that has one."""

import dataclasses

import numpy as np
import pytest
import torch

from distpow_tpu.models import registry as jax_registry
from distpow_tpu.parallel.search import search as jax_search
from distpow_tpu_torch.backends import CudaBackend, PythonBackend, get_backend
from distpow_tpu_torch.models import puzzle
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops.hash_cuda import (KERNELS, LAUNCHES, hash_search, kernel_layout,
                                             kernel_mask_words, kernel_name)
from distpow_tpu_torch.ops.operands import make_operands
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.ops.search_step import step_operands
from distpow_tpu_torch.parallel.partition import contiguous_bounds, thread_bytes, worker_bits
from distpow_tpu_torch.parallel.search import search

MODELS = ("sha256", "sha256d", "sha1", "ripemd160", "sha512", "sha384", "sha3_256",
          "blake2b_256")
BATCH = 1 << 12
LAUNCH = 1 << 14

# (nonce, difficulty, workers, worker index)
CASES = [
    (b"\x01\x02\x03\x04", 3, 1, 0),
    (b"\x01\x02\x03\x04", 2, 4, 1),
    (b"\x09" * 13, 2, 4, 3),
    (bytes(range(60)), 2, 1, 0),  # two-block tail
]


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: these tests describe a machine without one")


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
@pytest.mark.parametrize("name", MODELS)
def test_cuda_and_torch_backends_match_python_backend_and_jax(name, case):
    nonce, d, workers, idx = case
    tbs = thread_bytes(idx, worker_bits(workers))
    want = PythonBackend(hash_model=name).search(nonce, d, tbs)
    h = puzzle.new_hash(name)
    h.update(nonce + want)
    assert h.hexdigest().endswith("0" * d)
    for backend_name in ("cuda", "torch"):
        be = get_backend(backend_name, hash_model=name, device="cpu", batch_size=BATCH,
                         max_launch=LAUNCH)
        assert be.search(nonce, d, tbs) == want, backend_name
    # the driver with the CUDA backend's step factory: same secret and the
    # same count of hashes as the JAX package's driver
    be = get_backend("cuda", hash_model=name, device="cpu")
    lo, tbc = contiguous_bounds(tbs)
    got = search(nonce, d, tbs, model=be.model, batch_size=BATCH, launch_candidates=LAUNCH,
                 device="cpu", step_factory=be._factory(nonce, d, lo, tbc))
    ref = jax_search(nonce, d, tbs, model=jax_registry.get_hash_model(name),
                     batch_size=BATCH, launch_candidates=LAUNCH)
    assert got.secret == ref.secret == want
    assert got.hashes_tried == ref.hashes_tried


@pytest.mark.parametrize("name", MODELS)
def test_cuda_backend_launch_budget_scales_with_cost(name):
    be = get_backend("cuda", hash_model=name, device="cpu")
    assert isinstance(be, CudaBackend) and be.batch_size == 1 << 20
    assert be.max_launch == (1 << 30) * 584 // get_hash_model(name).cost_ops


@pytest.mark.parametrize("name", MODELS)
def test_auto_raises_without_a_gpu(no_gpu, name):
    with pytest.raises(RuntimeError, match="GPU"):
        get_backend("auto", hash_model=name)


@pytest.mark.parametrize("name", MODELS)
def test_wrapper_on_a_cuda_path_raises_and_launches_nothing(no_gpu, name):
    model = get_hash_model(name)
    spec = build_tail_spec(b"\x01\x02\x03\x04", 1, model)
    ops = step_operands(spec, 2, model, 0, 256, "cpu")
    launches = LAUNCHES[KERNELS[name]]
    before = launches.value
    with pytest.raises(ValueError, match="cuda"):
        hash_search(model, ops, spec.tb_loc, spec.chunk_locs, 1, 1024, device="cuda")
    assert launches.value == before


@pytest.mark.parametrize("name", MODELS)
def test_wrapper_checks_operands_against_the_model(name):
    model = get_hash_model(name)
    spec = build_tail_spec(b"\x01", 1, model)
    s = len(model.init_state)
    short = make_operands(spec.init_state[:4], spec.base_words, [1], 0, 256)
    with pytest.raises(ValueError, match=f"init must be \\[{s}\\]"):
        hash_search(model, short, spec.tb_loc, spec.chunk_locs, 1, 1024, device="cpu")
    wide = make_operands(spec.init_state, spec.base_words, [1] * (model.digest_words + 1), 0, 256)
    with pytest.raises(ValueError, match="masks must be"):
        hash_search(model, wide, spec.tb_loc, spec.chunk_locs, 1, 1024, device="cpu")
    md5_ops = step_operands(build_tail_spec(b"\x01", 1, get_hash_model("md5")), 2,
                            get_hash_model("md5"), 0, 256, "cpu")
    with pytest.raises(ValueError, match="init must be"):
        hash_search(model, md5_ops, spec.tb_loc, spec.chunk_locs, 1, 1024, device="cpu")


def test_kernels_cover_the_registry_and_nothing_else():
    for name in MODELS + ("md5",):
        assert kernel_name(get_hash_model(name)) == f"{name}_search"
    assert len(KERNELS) == 9
    # one launch counter per kernel, its group form (the scheduler's), its
    # mesh form (one shard's launch) and the persistent forms of the solo
    # and mesh launches
    assert set(LAUNCHES) == {n for k in KERNELS.values()
                             for n in (k, f"{k}_group", f"{k}_mesh", f"{k}_persistent",
                                       f"{k}_mesh_persistent")}
    with pytest.raises(ValueError, match="no CUDA kernel"):
        kernel_name(dataclasses.replace(get_hash_model("sha512"), name="whirlpool"))
    # mask words: 1-4 run as they are, wider counts on the full digest
    assert [kernel_mask_words(m, get_hash_model("sha256")) for m in range(1, 9)] == \
        [1, 2, 3, 4, 8, 8, 8, 8]
    assert [kernel_mask_words(m, get_hash_model("sha1")) for m in range(1, 6)] == [1, 2, 3, 4, 5]
    assert [kernel_mask_words(m, get_hash_model("sha384")) for m in range(1, 13)] == \
        [1, 2, 3, 4] + [12] * 8


@pytest.mark.parametrize("name", MODELS + ("md5",))
@pytest.mark.parametrize("width", range(5))
def test_kernel_layout_covers_every_tail_in_its_byte_order(name, width):
    """The run's first byte is the thread byte, at ``var_shift`` in message
    word ``var_word``; each chunk byte follows in the model's byte order."""
    model = get_hash_model(name)
    big = model.word_byteorder == "big"
    wpb = model.words_per_block
    other = dataclasses.replace(model, word_byteorder="little" if big else "big")
    for nonce_len in range(0, 300, 7):
        spec = build_tail_spec(bytes(nonce_len), width, model, b"\x01" if width == 4 else b"")
        var_word, var_shift, chunk_mask = kernel_layout(spec.tb_loc, spec.chunk_locs, model)
        b, w, s = spec.tb_loc
        assert (var_word, var_shift) == (wpb * b + w, s)
        assert var_word < wpb * spec.n_blocks
        assert chunk_mask == (1 << (8 * width)) - 1
        # the run starts at byte nonce_len % block_bytes of the tail
        assert 4 * var_word + (3 - s // 8 if big else s // 8) == nonce_len % model.block_bytes
        if width:
            # read in the other byte order, the run is not contiguous
            with pytest.raises(ValueError, match="contiguous"):
                kernel_layout(spec.tb_loc, spec.chunk_locs, other)


def test_kernel_layout_rejects_bad_input():
    sha256, sha512 = get_hash_model("sha256"), get_hash_model("sha512")
    with pytest.raises(ValueError, match="contiguous"):
        kernel_layout((0, 1, 24), ((0, 1, 8),), sha256)
    with pytest.raises(ValueError, match="byte order"):
        kernel_layout((0, 1, 24), (), dataclasses.replace(sha256, word_byteorder="middle"))
    with pytest.raises(ValueError, match="thread-byte location"):
        kernel_layout((0, 16, 0), (), sha256)
    with pytest.raises(ValueError, match="thread-byte location"):
        kernel_layout((0, 32, 0), (), sha512)
    assert kernel_layout((0, 16, 0), (), sha512)[0] == 16


@pytest.mark.parametrize("name", MODELS)
def test_run_bytes_land_where_packing_puts_them(name):
    """The variable bits the kernel ORs into its two message words (the
    64-bit window of hash_search.cuh var_words, here in Python) equal what
    packing's per-byte locations give, for every width and offset; the
    words count message words only, so a run that crosses the block
    boundary continues in the next block's first word."""
    model = get_hash_model(name)
    big = model.word_byteorder == "big"
    wpb = model.words_per_block
    rng = np.random.default_rng(9)
    for nonce_len in range(0, model.block_bytes):
        for width in range(5):
            spec = build_tail_spec(bytes(nonce_len), width, model)
            var_word, s, mask = kernel_layout(spec.tb_loc, spec.chunk_locs, model)
            tb, chunk = int(rng.integers(0, 256)), int(rng.integers(0, 1 << 32))
            c = chunk & mask
            if big:
                v = (((tb << 32) | int.from_bytes(c.to_bytes(4, "little"), "big")) << s)
                first, second = v >> 32, v & 0xFFFFFFFF
            else:
                v = (tb | (c << 8)) << s
                first, second = v & 0xFFFFFFFF, v >> 32
            words = [0] * 2 * wpb
            bb, w, sh = spec.tb_loc
            words[wpb * bb + w] |= tb << sh
            for j, (cb, cw, cs) in enumerate(spec.chunk_locs):
                words[wpb * cb + cw] |= ((chunk >> (8 * j)) & 0xFF) << cs
            want = [0] * 2 * wpb
            want[var_word] |= first
            if var_word + 1 < 2 * wpb:
                want[var_word + 1] |= second
            assert words == want, (nonce_len, width)
