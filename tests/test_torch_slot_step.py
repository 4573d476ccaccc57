"""The scheduler's plain steps against the JAX package's, exactly.

``slot_search_step`` and ``mixed_slot_search_step`` of the port
(``distpow_tpu_torch/ops/search_step.py``) are fed the same numpy slot rows
as the reference's (``distpow_tpu/ops/search_step.py``, XLA on the CPU):
batch 2^10, 1, 2 and 4 slots at mixed difficulties and power-of-two
partitions, one- and two-block tails, widths 0, 2 and 4.  Every slot's first
hit must be the same integer.  sha512 and sha384 are never admitted to the
reference's packed step (``XLA_SERVING_COMPILE_IMPRACTICAL``): each of their
slots is held to the port's solo ``plain_search`` and the hit to hashlib.
md5 is also held to the reference's Pallas group step in interpret mode
(``build_pallas_group_step``), and the group kernel's wrapper on CPU tensors
(``hash_group_search``) to the slot step.
"""

import numpy as np
import pytest

from distpow_tpu.models.registry import get_hash_model as jax_model
from distpow_tpu.ops import search_step as jax_step
from distpow_tpu.ops.packing import build_tail_spec as jax_tail_spec
from distpow_tpu_torch.models import puzzle
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops.difficulty import nibble_masks
from distpow_tpu_torch.ops.hash_cuda import hash_group_search
from distpow_tpu_torch.ops.operands import group_operands, make_operands, u32_value
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.ops.search_step import (SENTINEL, XLA_SERVING_COMPILE_IMPRACTICAL,
                                               mixed_slot_search_step, plain_first_hits,
                                               plain_search, plain_search_w0,
                                               slot_search_step, step_operands)
from distpow_tpu_torch.parallel.search import assemble_secret

BATCH = 1 << 10
ADMITTED = ("md5", "sha256", "sha256d", "sha1", "ripemd160", "sha3_256", "blake2b_256")
# (slots, tail, width): 1, 2 and 4 slots, one- and two-block tails, widths 0, 2, 4
CASES = ((1, "two_blocks", 0), (2, "one_block", 4), (4, "two_blocks", 2))


def _nonce_len(model, tail: str) -> int:
    """A nonce whose tail is one block, or two with the run at the boundary."""
    return 5 if tail == "one_block" else model.block_bytes - 2


def _rows(name: str, n_slots: int, tail: str, width: int, seed: int):
    """Per-slot nonces and rows as numpy uint32 arrays (one nonce per slot,
    all of one length, so the group shares its tail layout), and the port's
    tail specs.  Difficulties 1-3 and one slot that cannot hit (the full
    digest's masks), power-of-two runs of 1, 2, 16 and 256 at aligned
    tb_lo, cursors at a segment's start and, for width 4, one that wraps
    past 2^32."""
    model = get_hash_model(name)
    rng = np.random.default_rng(seed)
    n_len = _nonce_len(model, tail)
    nonces, specs, masks, tb_lo, log_tbc, chunk0 = [], [], [], [], [], []
    for s in range(n_slots):
        nonce = rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes()
        nonces.append(nonce)
        specs.append(build_tail_spec(nonce, width, model))
        d = model.max_difficulty if s == 2 else int(rng.integers(1, 4))
        masks.append(nibble_masks(d, model))
        lg = (0, 1, 4, 8)[(s + seed) % 4]
        log_tbc.append(lg)
        tb_lo.append(int(rng.integers(0, 256 >> lg)) << lg)
        if width == 0:
            chunk0.append(0)
        elif width == 4 and s == 1:
            chunk0.append((1 << 32) - 3)
        else:
            chunk0.append(256 ** (width - 1) + int(rng.integers(0, 64)))
    assert len({(sp.n_blocks, sp.tb_loc, sp.chunk_locs) for sp in specs}) == 1
    rows = (np.array([sp.init_state for sp in specs], np.uint32),
            np.array([sp.base_words for sp in specs], np.uint32),
            np.array(masks, np.uint32), np.array(tb_lo, np.uint32),
            np.array(log_tbc, np.uint32), np.array(chunk0, np.uint32))
    return nonces, specs, rows


def _jax_layout(name, nonce, spec):
    """The reference's layout of the same tail (held equal to the port's)."""
    jspec = jax_tail_spec(nonce, spec.width, jax_model(name))
    assert (jspec.n_blocks, jspec.tb_loc, jspec.chunk_locs) == \
        (spec.n_blocks, spec.tb_loc, spec.chunk_locs)
    return jspec.n_blocks, jspec.tb_loc, jspec.chunk_locs


@pytest.mark.parametrize("name", ADMITTED)
def test_slot_step_matches_reference(name):
    results = []
    for i, (n_slots, tail, width) in enumerate(CASES):
        nonces, specs, rows = _rows(name, n_slots, tail, width, seed=17 * i + len(name))
        layout = _jax_layout(name, nonces[0], specs[0])
        want = np.asarray(jax_step.slot_search_step(name, *layout, BATCH, n_slots)(*rows))
        got = slot_search_step(name, *layout, BATCH, n_slots)(*rows)
        assert got.tolist() == [int(v) for v in want], (n_slots, tail, width)
        results += got.tolist()
        # the group kernel's wrapper on CPU tensors runs the same plain version
        ops = group_operands(*rows)
        assert hash_group_search(get_hash_model(name), ops, specs[0].tb_loc,
                                 specs[0].chunk_locs, BATCH, device="cpu").tolist() == \
            got.tolist()
    # hits and misses both occur
    assert SENTINEL in results and any(v != SENTINEL for v in results)


@pytest.mark.parametrize("name", sorted(XLA_SERVING_COMPILE_IMPRACTICAL))
def test_wide_slot_step_matches_solo_step_and_hashlib(name):
    """The models the reference never admits: each slot equals the port's
    solo plain step at the slot's operands, and a hit solves (hashlib)."""
    model = get_hash_model(name)
    assert XLA_SERVING_COMPILE_IMPRACTICAL == jax_step.XLA_SERVING_COMPILE_IMPRACTICAL
    for i, (n_slots, tail, width) in enumerate(CASES):
        nonces, specs, rows = _rows(name, n_slots, tail, width, seed=31 * i + 1)
        sp = specs[0]
        got = slot_search_step(name, sp.n_blocks, sp.tb_loc, sp.chunk_locs, BATCH,
                               n_slots)(*rows).tolist()
        init, base, masks, tb_lo, log_tbc, chunk0 = rows
        for s in range(n_slots):
            tbc = 1 << int(log_tbc[s])
            ops = make_operands(init[s], base[s], masks[s], int(tb_lo[s]), tbc, "cpu")
            want = u32_value(plain_search(ops, sp.tb_loc, sp.chunk_locs, int(chunk0[s]), BATCH,
                                          model=model))
            assert got[s] == want, (n_slots, tail, width, s)
            if want != SENTINEL:
                secret, _ = assemble_secret(int(chunk0[s]), want, width, b"", int(tb_lo[s]),
                                            tbc)
                d = next(k for k in range(model.max_difficulty + 1)
                         if nibble_masks(k, model) == tuple(int(m) for m in masks[s]))
                assert puzzle.check_secret(nonces[s], secret, d, name)


def test_mixed_slot_step_matches_reference():
    """Three models in one mixed step, as the engine launches them."""
    groups, rows = [], []
    for i, (name, (n_slots, tail, width)) in enumerate(
            zip(("md5", "sha1", "sha256"), CASES[:3])):
        nonces, specs, r = _rows(name, n_slots, tail, width, seed=100 + i)
        groups.append((name, *_jax_layout(name, nonces[0], specs[0]), n_slots))
        rows.append(r)
    want = jax_step.mixed_slot_search_step(tuple(groups), BATCH)(tuple(rows))
    got = mixed_slot_search_step(groups, BATCH)(rows)
    assert [g.tolist() for g in got] == [[int(v) for v in w] for w in want]


def test_md5_slot_step_matches_pallas_group_step_in_interpret_mode():
    """The reference's Pallas group step (``build_pallas_group_step``), run in
    interpret mode on the CPU as ``tests/test_lanes.py`` runs it, against
    the port's slot step on the same rows."""
    from distpow_tpu.sched.lanes import LaneCaps, build_pallas_group_step

    batch = 2048
    nonces, specs, rows = _rows("md5", 2, "one_block", 2, seed=5)
    layout = _jax_layout("md5", nonces[0], specs[0])
    step = build_pallas_group_step(("md5", *layout, 2), batch,
                                   LaneCaps("cpu", 1, interpret=True))
    want = np.asarray(step(rows, None))
    got = slot_search_step("md5", *layout, batch, 2)(*rows)
    assert got.tolist() == [int(v) for v in want]


@pytest.mark.parametrize("name", ["md5", "sha256d", "sha512", "sha3_256", "blake2b_256"])
def test_plain_first_hits_is_plain_search_case_by_case(name):
    """Many cases of one layout at once (any partition, launch sub-batches,
    masks padded to every digest word, width 0) equal ``plain_search`` and
    ``plain_search_w0`` one case at a time."""
    import torch

    model = get_hash_model(name)
    rng = np.random.default_rng(len(name))
    for width, n_len in ((2, 5), (0, 9), (3, model.block_bytes - 2)):
        cases = []
        for d, (tb_lo, tbc), steps in zip((1, 2, 3, 0, model.max_difficulty),
                                          ((0, 256), (16, 96), (7, 1), (64, 64), (3, 5)),
                                          (1, 3, 2, 1, 1)):
            nonce = rng.integers(0, 256, size=n_len, dtype=np.uint8).tobytes()
            spec = build_tail_spec(nonce, width, model)
            ops = step_operands(spec, d, model, tb_lo, tbc, "cpu")
            chunk0 = 0 if width == 0 else 256 ** width - 7
            batch = tbc if width == 0 else 16 * tbc
            steps = 1 if width == 0 else steps
            if width == 0:
                want = plain_search_w0(ops, spec.tb_loc, spec.chunk_locs, model=model)
            else:
                want = plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, steps,
                                    model=model)
            cases.append((spec, ops, chunk0, batch * steps, u32_value(want)))
        sp = cases[0][0]
        d = model.digest_words
        got = plain_first_hits(
            model, sp.n_blocks, sp.tb_loc, sp.chunk_locs,
            torch.stack([c[1].init for c in cases]), torch.stack([c[1].base for c in cases]),
            torch.stack([torch.nn.functional.pad(c[1].masks, (d - c[1].mask_words, 0))
                         for c in cases]),
            [c[1].tb_lo for c in cases], [c[1].tb_count for c in cases],
            [c[2] for c in cases], [c[3] for c in cases])
        assert got.tolist() == [c[4] for c in cases], width
        assert SENTINEL in got.tolist() and min(got.tolist()) != SENTINEL
