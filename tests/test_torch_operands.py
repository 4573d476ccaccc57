"""A search step's operands in one buffer (``ops/operands.py``).

``make_operands`` packs ``init``, ``base`` and ``masks`` into one host
array and moves it with one copy (on a card: pinned, ``non_blocking``).
On the CPU that must give the tensors that one ``u32_tensor`` a part gave:
the same shapes, dtypes and words, for every model, tail layout and
difficulty; and ``search.operand_uploads``, which counts the copies to a
card, stays at 0.  The card's side (no stream synchronisation, one upload
a plan) is the ``card`` test of ``test_torch_device_timeline.py``.
"""

import numpy as np
import pytest
import torch

from distpow_tpu_torch.backends import get_backend
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops.difficulty import nibble_masks
from distpow_tpu_torch.ops.operands import make_operands, operands_from_numpy, u32_tensor
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.ops.search_step import mask_words_for, step_operands
from distpow_tpu_torch.runtime.metrics import REGISTRY, Metrics

MODELS = ("md5", "sha256", "sha256d", "sha1", "ripemd160", "sha512", "sha384", "sha3_256",
          "blake2b_256")
# (nonce length, variable chunk width, constant high chunk bytes, difficulty,
# thread-byte run): one block and two, widths 0 to 6, one mask word and several
CASES = [
    (4, 0, b"", 1, (0, 256)),
    (4, 3, b"", 8, (64, 64)),
    (55, 1, b"", 9, (0, 256)),
    (60, 4, b"\x01\x02", 17, (128, 32)),
]


def _per_part(spec, difficulty, model):
    """The operands as one ``u32_tensor`` a part builds them."""
    mw = mask_words_for(difficulty, model)
    masks = nibble_masks(difficulty, model)[model.digest_words - mw:]
    return (u32_tensor(spec.init_state), u32_tensor(spec.base_words),
            u32_tensor(masks).reshape(-1))


def _same(got, want):
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-w{c[1]}+{len(c[2])}-d{c[3]}")
@pytest.mark.parametrize("name", MODELS)
def test_packed_operands_equal_the_per_part_upload(name, case):
    model = get_hash_model(name)
    n, vw, extra, difficulty, (tb_lo, tbc) = case
    spec = build_tail_spec(bytes(range(7, 7 + n)), vw, model, extra)
    m = Metrics()
    ops = step_operands(spec, difficulty, model, tb_lo, tbc, "cpu", m)
    init, base, masks = _per_part(spec, difficulty, model)
    _same(ops.init, init)
    _same(ops.base, base)
    _same(ops.masks, masks)
    assert (ops.tb_lo, ops.tb_count) == (tb_lo, tbc)
    assert ops.n_blocks == len(spec.base_words) and ops.mask_words == masks.numel()
    # one buffer: the three parts are views of one storage, in order
    storage = ops.init.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == storage for t in (ops.base, ops.masks))
    assert ops.base.data_ptr() == ops.init.data_ptr() + 4 * ops.init.numel()
    assert ops.masks.data_ptr() == ops.base.data_ptr() + 4 * ops.base.numel()
    assert m.get("search.operand_uploads") == 0


def test_numpy_words_and_the_top_bit_survive_the_packing():
    init = np.array([0x80000000, 0xFFFFFFFF, 0, 1], dtype=np.uint32)
    base = np.arange(32, dtype=np.uint32).reshape(2, 16) | np.uint32(0xF0000000)
    masks = np.array([0xFFFFFFFF], dtype=np.uint32)
    ops = operands_from_numpy(init, base, masks, 3, 5)
    for got, want in ((ops.init, init), (ops.base, base), (ops.masks, masks)):
        _same(got, u32_tensor(want))
        assert np.array_equal(got.numpy().view(np.uint32), want)
    # the host words are copied, not aliased
    init[0] = 7
    assert ops.init[0].item() == -(1 << 31)


def test_a_base_that_is_not_rows_is_refused():
    with pytest.raises(ValueError, match="base must be"):
        make_operands([1, 2, 3, 4], [1, 2, 3], [0xF], 0, 256)


def test_a_cpu_search_uploads_nothing_to_a_card():
    m = Metrics()
    before = REGISTRY.get("search.operand_uploads")
    backend = get_backend("cuda", hash_model="md5", device="cpu", batch_size=1 << 10,
                          max_launch=1 << 12, loop="persistent", metrics=m)
    assert backend.search(b"\x01\x02\x03\x04", 4, range(256)) is not None
    assert m.get("search.launches") >= 2  # the width-0 probe and width 1 at least
    assert m.get("search.operand_uploads") == 0
    assert REGISTRY.get("search.operand_uploads") == before
