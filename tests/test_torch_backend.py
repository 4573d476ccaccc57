"""Backend selection and the kernel wrapper's device rules.

Without a GPU the CUDA entry points raise; they never run on the CPU unless
the caller passes ``device="cpu"``.  These tests describe a machine with no
CUDA device and skip on one that has it."""

import pytest
import torch

from distpow_tpu_torch.backends import PythonBackend, TorchBackend, get_backend
from distpow_tpu_torch.backends.cuda_backend import CudaBackend, plan_launch_geometry
from distpow_tpu_torch.models.registry import MD5
from distpow_tpu_torch.ops.hash_cuda import (BLOCK_THREADS, LAUNCHES, default_grid,
                                             hash_search, kernel_layout)
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.ops.search_step import step_operands


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: these tests describe a machine without one")


@pytest.mark.parametrize("name", ["auto", "cuda", "torch", None])
def test_gpu_backends_raise_without_a_gpu(no_gpu, name):
    with pytest.raises(RuntimeError, match="GPU"):
        get_backend(name)


def test_explicit_cpu_device_is_served(no_gpu):
    assert isinstance(get_backend("cuda", device="cpu"), CudaBackend)
    assert isinstance(get_backend("torch", device="cpu"), TorchBackend)
    assert isinstance(get_backend("python"), PythonBackend)
    # "pallas" is the reference's name of the kernel backend, now served
    # as cuda (tests/test_torch_driver_instruments.py): an unknown name raises
    with pytest.raises(ValueError, match="unknown worker backend"):
        get_backend("warp")
    with pytest.raises(ValueError, match="unsupported device"):
        get_backend("cuda", device="meta")


def test_cuda_backend_serves_md5_only():
    """Named for the first slice; the backend now serves all nine models,
    the last four of them added by the third slice, and raises for an
    unknown one."""
    for name in ("sha512", "sha384", "sha3_256", "blake2b_256"):
        be = get_backend("cuda", hash_model=name, device="cpu")
        assert isinstance(be, CudaBackend) and be.model.name == name
    with pytest.raises(ValueError, match="unknown hash model"):
        get_backend("cuda", hash_model="whirlpool", device="cpu")


def test_wrapper_on_a_cuda_path_raises_and_launches_nothing(no_gpu):
    spec = build_tail_spec(b"\x01\x02\x03\x04", 1, MD5)
    ops = step_operands(spec, 2, MD5, 0, 256, "cpu")
    before = LAUNCHES["md5_search"].value
    with pytest.raises(ValueError, match="cuda"):
        hash_search(MD5, ops, spec.tb_loc, spec.chunk_locs, 1, 1024, device="cuda")
    assert LAUNCHES["md5_search"].value == before


def test_wrapper_checks_operands():
    spec = build_tail_spec(b"\x01", 1, MD5)
    ops = step_operands(spec, 2, MD5, 0, 256, "cpu")
    bad = ops.__class__(ops.init.to(torch.int64), ops.base, ops.masks, 0, 256)
    with pytest.raises(ValueError, match="int32"):
        hash_search(MD5, bad, spec.tb_loc, spec.chunk_locs, 1, 1024, device="cpu")
    bad = ops.__class__(ops.init, ops.base, ops.masks, 200, 100)
    with pytest.raises(ValueError, match="thread-byte run"):
        hash_search(MD5, bad, spec.tb_loc, spec.chunk_locs, 1, 1024, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        hash_search(MD5, ops, spec.tb_loc, spec.chunk_locs, 1, 1 << 30, 2, device="cpu")


@pytest.mark.parametrize("nonce_len", range(0, 130, 7))
@pytest.mark.parametrize("width", range(5))
def test_kernel_layout_covers_every_tail(nonce_len, width):
    spec = build_tail_spec(bytes(nonce_len), width, MD5, b"\x01" if width == 4 else b"")
    var_word, var_shift, chunk_mask = kernel_layout(spec.tb_loc, spec.chunk_locs, MD5)
    b, w, s = spec.tb_loc
    assert (var_word, var_shift) == (16 * b + w, s)
    assert var_word < 16 * spec.n_blocks
    assert chunk_mask == (1 << (8 * width)) - 1


def test_kernel_layout_rejects_a_split_run():
    with pytest.raises(ValueError, match="contiguous"):
        kernel_layout((0, 1, 0), ((0, 1, 16),), MD5)


def test_launch_geometry():
    # main path: 4096 chunks x 256 thread bytes, 1024 sub-batches
    assert plan_launch_geometry(4096, 256, 1024, 1 << 30) == (4096, 1024)
    # the budget clamps k
    assert plan_launch_geometry(4096, 256, 4096, 1 << 30)[1] == 1024
    assert plan_launch_geometry(1, 96, 1, 1 << 30) == (1, 1)
    # the wrapper's grid: a few waves per SM, no more blocks than indices
    assert default_grid(1 << 30, 132) == 132 * 16
    assert default_grid(256, 132) == 1
    assert default_grid(BLOCK_THREADS + 1, 132) == 2
