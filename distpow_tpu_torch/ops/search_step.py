"""The plain PyTorch search step: the reference the CUDA kernel is held to.

One step evaluates ``launch_steps`` sub-batches of ``batch`` candidates:
flat index -> (chunk, thread byte) -> message words -> hash state ->
difficulty masks -> the smallest hitting flat index, or ``SENTINEL``.
The hash model is an argument of every step: there is no default.
The flat index is chunk-major, thread-byte-minor (worker.go:318-319), so
the minimum is the first hit in reference enumeration order.

As in the reference's serving regime, the nonce words, the absorbed
prefix state, the masks and the partition are runtime operands
(``StepOperands``) while the tail layout (``n_blocks``, ``tb_loc``,
``chunk_locs``) is the step's static shape.  Words are int64 tensors
masked to 32 bits (see ``ops/__init__.py``).  Every step returns a 0-d
tensor on the operands' device, not an int: reading it is the caller's
synchronisation point.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..models.registry import HashModel, get_hash_model
from .difficulty import nibble_masks
from .operands import MASK32, Device, StepOperands, make_operands, widen
from .packing import TailSpec, build_tail_spec

SENTINEL = 0xFFFFFFFF


def _check_launch(batch: int, launch_steps: int) -> None:
    if launch_steps < 1:
        raise ValueError(f"launch_steps must be >= 1, got {launch_steps}")
    # flat indices are 32-bit and the kernel's grid-stride loop needs
    # headroom above the last index: keep a dispatch below 2^31
    if batch * launch_steps >= 1 << 31:
        raise ValueError(
            f"launch covers {batch * launch_steps} candidates; flat "
            f"indices require < 2^31 per dispatch"
        )


def mask_words_for(difficulty: int, model: HashModel) -> int:
    """Trailing digest words the difficulty masks touch (8 nibbles per
    word); at least 1.  The kernel's ``MASK_WORDS`` template key."""
    return max(1, min(model.digest_words, -(-difficulty // 8)))


def eval_dyn_candidates(model, n_blocks, tb_loc, chunk_locs, init, base, tb, chunk):
    """Hash a batch of candidates against runtime-operand nonce words.

    ``init[S]`` and ``base[n_blocks, W]`` (W the model's row words) are
    int64 word tensors; ``tb``
    and ``chunk`` int64 tensors (or ints).  Returns the state tuple, after
    the model's ``finalize`` stage where it has one (sha256d)."""
    state = tuple(init[i] for i in range(len(model.init_state)))
    for b in range(n_blocks):
        words = [base[b, w] for w in range(base.shape[1])]
        bb, w, s = tb_loc
        if bb == b:
            words[w] = words[w] | (tb << s)
        for j, (cb, cw, cs) in enumerate(chunk_locs):
            if cb == b:
                words[cw] = words[cw] | (((chunk >> (8 * j)) & 0xFF) << cs)
        state = model.compress(state, words)
    if model.finalize is not None:
        state = model.finalize(state)
    return state


def fold_dyn_masks(model, state, masks, mask_words: Optional[int] = None):
    """Hit mask against the ``mask_words`` trailing-word masks."""
    d = model.digest_words
    k = d if mask_words is None else mask_words
    acc = state[d - k] & masks[0]
    for i in range(1, k):
        acc = acc | (state[d - k + i] & masks[i])
    return acc == 0


def step_operands(spec: TailSpec, difficulty: int, model: HashModel,
                  tb_lo: int, tb_count: int, device: Device = "cuda") -> StepOperands:
    """Operands binding one (nonce, difficulty, partition) onto a step.
    Only the ``mask_words_for(difficulty)`` trailing masks are carried."""
    masks = nibble_masks(difficulty, model)
    mw = mask_words_for(difficulty, model)
    return make_operands(spec.init_state, spec.base_words,
                         masks[model.digest_words - mw:], tb_lo, tb_count, device)


def plain_search(ops: StepOperands, tb_loc, chunk_locs, chunk0: int, batch: int,
                 launch_steps: int = 1, *, model: HashModel) -> torch.Tensor:
    """First hitting flat index in ``[0, batch * launch_steps)``, or
    SENTINEL, as a 0-d int64 tensor: the plain version of the kernel."""
    _check_launch(batch, launch_steps)
    dev = ops.device
    init, base, masks = widen(ops.init), widen(ops.base), widen(ops.masks)
    tb_lo, tbc = ops.tb_lo, ops.tb_count
    f0 = torch.arange(batch, dtype=torch.int64, device=dev)
    best = torch.tensor(SENTINEL, dtype=torch.int64, device=dev)
    pow2 = tbc & (tbc - 1) == 0
    log_tbc = tbc.bit_length() - 1
    for i in range(launch_steps):
        f = f0 + i * batch
        if pow2:
            chunk = (chunk0 + (f >> log_tbc)) & MASK32
            tb = tb_lo + (f & (tbc - 1))
        else:
            chunk = (chunk0 + f // tbc) & MASK32
            tb = tb_lo + f % tbc
        state = eval_dyn_candidates(model, ops.n_blocks, tb_loc, chunk_locs,
                                    init, base, tb, chunk)
        hit = fold_dyn_masks(model, state, masks, ops.mask_words)
        best = torch.minimum(best, torch.where(hit, f, SENTINEL).min())
    return best


def plain_search_w0(ops: StepOperands, tb_loc, chunk_locs=(), *,
                    model: HashModel) -> torch.Tensor:
    """Width-0 probe: scan all 256 thread bytes and mask those outside the
    partition, so one fixed shape serves every partition.  Returns the
    partition-local index ``tb - tb_lo`` of the first hit, or SENTINEL."""
    dev = ops.device
    init, base, masks = widen(ops.init), widen(ops.base), widen(ops.masks)
    tb = torch.arange(256, dtype=torch.int64, device=dev)
    state = eval_dyn_candidates(model, ops.n_blocks, tb_loc, chunk_locs,
                                init, base, tb, 0)
    hit = fold_dyn_masks(model, state, masks, ops.mask_words)
    hit = hit & (tb >= ops.tb_lo) & (tb < ops.tb_lo + ops.tb_count)
    return torch.where(hit, tb - ops.tb_lo, SENTINEL).min()


@functools.lru_cache(maxsize=512)
def cached_search_step(
    nonce: bytes,
    width: int,
    difficulty: int,
    tb_lo: int,
    tb_count: int,
    chunks_per_step: int,
    model_name: str,
    extra_const_chunk: bytes = b"",
    launch_steps: int = 1,
    device: str = "cuda",
) -> Callable[[int], torch.Tensor]:
    """Serving-path plain step: ``bound(chunk0)`` covers ``launch_steps *
    chunks_per_step * tb_count`` candidates (width 0: the 256-lane probe
    of the ``tb_count`` thread bytes) and returns a 0-d int64 tensor."""
    model = get_hash_model(model_name)
    spec = build_tail_spec(bytes(nonce), width, model, extra_const_chunk)
    ops = step_operands(spec, difficulty, model, tb_lo, tb_count, device)
    if width == 0:
        def bound0(chunk0: int) -> torch.Tensor:
            return plain_search_w0(ops, spec.tb_loc, spec.chunk_locs, model=model)

        return bound0
    batch = chunks_per_step * tb_count
    _check_launch(batch, launch_steps)

    def bound(chunk0: int) -> torch.Tensor:
        return plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch,
                            launch_steps, model=model)

    return bound
