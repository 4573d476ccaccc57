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

The persistent loop's steps (``persistent_search_step``,
``cached_persistent_step``, the counterparts of the reference's) run up to
``segments`` segments of ``plain_search`` in order and stop after the first
that holds a hit or before one that finds the search's stop word set,
returning two words: the first hit and the segments executed; the plain
versions of the kernels' persistent form (``hash_cuda
hash_persistent_search``), as ``plain_shard_persistent_search`` is of one
mesh shard's.

A mesh launch spreads one search over shards (``plain_mesh_search``, the
plain version of the mesh kernels, ``hash_cuda.hash_mesh_search``): each
shard searches a slice of the partition and reports its first hit as the
partition's flat index, so the least across shards is the first hit.

The scheduler's steps (``slot_search_step``, ``mixed_slot_search_step``,
``plain_group_search``) run one such search per slot of a group, each slot
with its own operands and a power-of-two run, at masks of every digest
word: the plain versions beside the group kernels
(``hash_cuda.hash_group_search``), the counterparts of the reference's
``ops/search_step.py`` ``slot_search_step`` and ``mixed_slot_search_step``.
Where the reference vmaps one slot's lane (``_slot_lane``), the slots'
candidates here go through the compression together
(``plain_first_hits``, which also takes any partition and several
launch sub-batches: many ``plain_search`` cases of one layout at once).
"""

from __future__ import annotations

import functools
from dataclasses import replace
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.registry import HashModel, get_hash_model
from .difficulty import nibble_masks
from .operands import (MASK32, Device, GroupOperands, StepOperands, group_operands,
                       make_operands, u32_value, widen)
from .packing import TailSpec, build_tail_spec

SENTINEL = 0xFFFFFFFF
# Candidates the plain mesh step evaluates at once at most
# (plain_shard_search): the worker's batch
PLAIN_SUB_BATCH = 1 << 20

# The models the reference never admits to its scheduler's packed XLA step
# (the reference's ops/search_step.py XLA_SERVING_COMPILE_IMPRACTICAL: their
# fused XLA serving step takes too long to compile on the TPU).  The port
# keeps the same set so that its scheduler admits and refuses the same
# requests as the reference's.
XLA_SERVING_COMPILE_IMPRACTICAL = frozenset({"sha512", "sha384"})


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


class MeshOrigin(NamedTuple):
    """The partition a mesh launch searches: the launch's cursor and the
    run ``tb_lo .. tb_lo + tbc - 1`` (the kernels' ``MeshOrigin``).  Its flat
    index is chunk-major over the whole run."""

    chunk0: int
    tb_lo: int
    tbc: int


class MeshShard(NamedTuple):
    """One shard's slice of a mesh launch: the run ``tb_lo .. tb_lo +
    tb_count - 1`` from cursor ``chunk0``, over ``batch * launch_steps``
    flat indices of its own."""

    tb_lo: int
    tb_count: int
    chunk0: int
    batch: int
    launch_steps: int


def partition_index(f, tb_lo: int, tb_count: int, chunk0: int, origin: MeshOrigin):
    """A shard's local flat index ``f`` (an int or an int64 tensor, not
    SENTINEL) in the run ``tb_lo .. tb_lo + tb_count - 1`` from cursor
    ``chunk0``, as the flat index of the partition ``origin``: the kernels'
    ``mesh_global_index``."""
    chunk = (chunk0 + f // tb_count) & MASK32
    return ((chunk - origin.chunk0) & MASK32) * origin.tbc + tb_lo + f % tb_count - origin.tb_lo


def plain_shard_search(ops: StepOperands, tb_loc, chunk_locs, chunk0: int, batch: int,
                       launch_steps: int, origin: MeshOrigin, *,
                       model: HashModel) -> torch.Tensor:
    """One shard of a mesh launch, the plain version of a mesh kernel's
    launch: ``plain_search`` over the shard's run ``(ops.tb_lo,
    ops.tb_count)`` from ``chunk0``, its first hit mapped to the flat index
    of the partition ``origin``, ``(chunk - origin.chunk0) * origin.tbc +
    (tb - origin.tb_lo)`` (chunks mod 2^32), or SENTINEL; a 0-d int64."""
    # the shard's range in pieces of whole chunks, each up to the worker's
    # batch: a shard's batch is a fraction of the launch's, and the plain
    # step's cost is per evaluation, not per candidate
    n, tbc = batch * launch_steps, ops.tb_count
    _check_launch(n, 1)
    piece = max(1, PLAIN_SUB_BATCH // tbc) * tbc
    f = torch.tensor(SENTINEL, dtype=torch.int64, device=ops.device)
    for start in range(0, n, piece):
        hit = plain_search(ops, tb_loc, chunk_locs, (chunk0 + start // tbc) & MASK32,
                           min(piece, n - start), model=model)
        f = torch.minimum(f, torch.where(hit == SENTINEL, SENTINEL, hit + start))
    g = partition_index(f, ops.tb_lo, tbc, chunk0, origin)
    return torch.where(f == SENTINEL, SENTINEL, g)


def plain_mesh_search(ops: StepOperands, tb_loc, chunk_locs, shards: Sequence[MeshShard],
                      origin: MeshOrigin, *, model: HashModel) -> torch.Tensor:
    """The first hit of a mesh launch as the partition's flat index, or
    SENTINEL, a 0-d int64 on the operands' device: the plain version of the
    mesh step, the counterpart of the reference's ``_dyn_mesh_step`` and its
    non-power-of-two ``build_static``.  ``ops`` are the partition's
    operands; each shard runs ``plain_shard_search`` at its own slice, and
    the least index across the shards (int64 values of uint32s, so the
    least uint32) wins."""
    hits = [plain_shard_search(replace(ops, tb_lo=s.tb_lo, tb_count=s.tb_count), tb_loc,
                               chunk_locs, s.chunk0, s.batch, s.launch_steps, origin,
                               model=model) for s in shards]
    return torch.stack(hits).amin()


def _stopped(stop) -> bool:
    """Is the search's stop flag (a 0-d tensor on any device, or None) set?"""
    return stop is not None and int(stop) != 0


def _check_persistent(tb_loc, chunk_locs, batch: int, segments: int) -> None:
    if not chunk_locs:
        raise ValueError("width 0 has no persistent form; serve it with the serial step")
    _check_launch(batch, segments)


def persistent_search_step(ops: StepOperands, tb_loc, chunk_locs, chunk0: int, batch: int,
                           segments: int, stop=None, *, model: HashModel) -> torch.Tensor:
    """The plain version of the persistent kernel (``hash_cuda.hash_persistent_search``;
    the counterpart of the reference's ``persistent_search_step``): up to
    ``segments`` segments of ``batch`` candidates from cursor ``chunk0``, each
    ``plain_search``, in order, stopping after the first segment that holds a
    hit or before one that finds the 0-d tensor ``stop`` nonzero.  Returns
    ``int64[2]`` on the operands' device: the first hit's flat index over the
    whole span (or SENTINEL) and the segments executed.  Width 0 raises, as
    in the reference: the driver serves it with the serial step."""
    _check_persistent(tb_loc, chunk_locs, batch, segments)
    chunks = batch // ops.tb_count
    if chunks * ops.tb_count != batch:
        raise ValueError(f"a segment of {batch} candidates is not whole chunks of "
                         f"{ops.tb_count} thread bytes")
    for seg in range(segments):
        if _stopped(stop):
            return _pair(SENTINEL, seg, ops.device)
        hit = u32_value(plain_search(ops, tb_loc, chunk_locs, (chunk0 + seg * chunks) & MASK32,
                                     batch, model=model))
        if hit != SENTINEL:
            return _pair(seg * batch + hit, seg + 1, ops.device)
    return _pair(SENTINEL, segments, ops.device)


def plain_shard_persistent_search(ops: StepOperands, tb_loc, chunk_locs, chunk0: int,
                                  batch: int, segments: int, origin: MeshOrigin, seg: int,
                                  total: int, stop=None, *, model: HashModel) -> torch.Tensor:
    """The plain version of one shard's persistent mesh launch
    (``hash_cuda.hash_mesh_persistent_search``): up to ``segments`` local
    segments of ``batch`` candidates of the shard's run from ``chunk0``, each
    ``plain_shard_search``, stopping at the first that holds a hit or before
    one that finds ``stop`` set.  Returns ``int64[2]``: the first hit as the
    partition's flat index (or SENTINEL), and the segments executed in the
    partition's segments of ``seg`` indices: the hit's + 1, where the flag
    stopped it the partition segment the shard was about to start, else
    ``total``.  The least of each word across the shards is the mesh
    launch's result."""
    _check_persistent(tb_loc, chunk_locs, batch, segments)
    tbc = ops.tb_count
    chunks = batch // tbc
    for s in range(segments):
        start = (chunk0 + s * chunks) & MASK32
        if _stopped(stop):
            return _pair(SENTINEL, partition_index(0, ops.tb_lo, tbc, start, origin) // seg,
                         ops.device)
        g = u32_value(plain_shard_search(ops, tb_loc, chunk_locs, start, batch, 1, origin,
                                         model=model))
        if g != SENTINEL:
            return _pair(g, g // seg + 1, ops.device)
    return _pair(SENTINEL, total, ops.device)


def _pair(first: int, segments: int, device) -> torch.Tensor:
    return torch.tensor([first, segments], dtype=torch.int64, device=device)


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


@functools.lru_cache(maxsize=512)
def cached_persistent_step(
    nonce: bytes,
    width: int,
    difficulty: int,
    tb_lo: int,
    tb_count: int,
    chunks_per_step: int,
    model_name: str,
    extra_const_chunk: bytes = b"",
    segments: int = 1,
    device: str = "cuda",
) -> Callable[[int, Optional[torch.Tensor]], torch.Tensor]:
    """Serving-path plain persistent step, the counterpart of the
    reference's ``cached_persistent_step``: ``bound(chunk0, stop)`` covers up
    to ``segments`` segments of ``chunks_per_step * tb_count`` candidates
    (``persistent_search_step``) and returns ``int64[2]``.  Width 0 raises:
    the driver serves it with ``cached_search_step``."""
    if width == 0:
        raise ValueError("width 0 has no persistent form; use cached_search_step")
    model = get_hash_model(model_name)
    spec = build_tail_spec(bytes(nonce), width, model, extra_const_chunk)
    ops = step_operands(spec, difficulty, model, tb_lo, tb_count, device)
    batch = chunks_per_step * tb_count
    _check_launch(batch, segments)

    def bound(chunk0: int, stop: Optional[torch.Tensor] = None) -> torch.Tensor:
        return persistent_search_step(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch,
                                      segments, stop, model=model)

    return bound


def plain_first_hits(model: HashModel, n_blocks: int, tb_loc, chunk_locs, init: torch.Tensor,
                     base: torch.Tensor, masks: torch.Tensor, tb_lo: Sequence[int],
                     tbc: Sequence[int], chunk0: Sequence[int],
                     n: Sequence[int]) -> torch.Tensor:
    """Many searches of one tail layout in one evaluation: for each case c,
    the first hitting flat index in ``[0, n[c])`` of the run ``tb_lo[c] ..
    tb_lo[c] + tbc[c] - 1`` from cursor ``chunk0[c]``, or SENTINEL, as
    ``int64[C]`` on the operands' device.  ``init[C, S]``, ``base[C,
    n_blocks, W]`` and ``masks[C, D]`` (the masks of every digest word; a
    narrower difficulty's are padded with leading zero words) are int32 bit
    patterns.  Case by case it computes what ``plain_search`` computes (a
    launch of ``launch_steps`` sub-batches is one range of ``batch *
    launch_steps``), and a width-0 case (``n = tbc``, cursor 0) what
    ``plain_search_w0`` does; the candidates of all cases go through the
    model's compression together."""
    dev = init.device
    counts = torch.tensor([int(x) for x in n], dtype=torch.int64, device=dev)
    case = torch.repeat_interleave(torch.arange(len(counts), device=dev), counts)
    starts = torch.cumsum(counts, 0) - counts
    f = torch.arange(case.numel(), dtype=torch.int64, device=dev) - starts[case]

    def per_case(values):
        return torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)[case]

    run = per_case(tbc)
    chunk = (per_case(chunk0) + f // run) & MASK32
    tb = per_case(tb_lo) + f % run
    state = eval_dyn_candidates(model, n_blocks, tb_loc, chunk_locs, widen(init)[case].T,
                                widen(base)[case].permute(1, 2, 0), tb, chunk)
    hit = fold_dyn_masks(model, state, widen(masks)[case].T)
    first = torch.full((len(counts),), SENTINEL, dtype=torch.int64, device=dev)
    return first.scatter_reduce(0, case, torch.where(hit, f, SENTINEL), "amin")


def plain_group_search(model: HashModel, ops: GroupOperands, tb_loc, chunk_locs, batch: int,
                       launch_steps: int = 1) -> torch.Tensor:
    """Per slot of ``ops``, the first hitting flat index in ``[0, batch *
    launch_steps)`` or SENTINEL, as ``int64[n_slots]`` on the operands'
    device: the plain version of the group kernel."""
    _check_launch(batch, launch_steps)
    # distpow: ok hot-path-host-sync -- the plain version, not a kernel:
    # it reads its three per-slot scalar rows once per call, before any
    # work of its own is queued, so there is no pipeline to stall
    tb_lo, log_tbc, chunk0 = ((widen(t) & MASK32).tolist()
                              for t in (ops.tb_lo, ops.log_tbc, ops.chunk0))
    return plain_first_hits(model, ops.n_blocks, tb_loc, chunk_locs, ops.init, ops.base,
                            ops.masks, tb_lo, [1 << v for v in log_tbc], chunk0,
                            [batch * launch_steps] * ops.n_slots)


def _group(rows) -> GroupOperands:
    """Group operands from the six slot rows: int32 tensors as they are
    (one device), anything else (numpy, lists) onto the CPU."""
    if all(isinstance(r, torch.Tensor) for r in rows):
        return GroupOperands(*(r.to(torch.int32).contiguous() for r in rows))
    return group_operands(*rows)


def slot_search_step(model_name: str, n_blocks: int, tb_loc, chunk_locs, batch: int,
                     n_slots: int, launch_steps: int = 1) -> Callable[..., torch.Tensor]:
    """Multi-slot step: ``step(init[n, S], base[n, n_blocks, W], masks[n, D],
    tb_lo[n], log_tbc[n], chunk0[n])`` runs ``n_slots`` independent searches
    and returns each slot's first-hit flat index (or SENTINEL) as an
    ``int64[n_slots]`` tensor on the CPU.  The rows are uint32 values (numpy
    arrays, or int32 tensors of their bit patterns on one device, where the
    step runs).  Masks carry every digest word, so slots at any difficulty
    share the step; each slot's partition is a power of two."""
    model = get_hash_model(model_name)
    _check_launch(batch, launch_steps)

    def step(*rows) -> torch.Tensor:
        ops = _group(rows)
        if ops.n_slots != n_slots:
            raise ValueError(f"{ops.n_slots} slot rows, the step has {n_slots}")
        # distpow: ok hot-path-host-sync -- the plain multi-slot step's
        # contract is a result on the CPU (the reference's step returns
        # a host array): this copy is its caller's one wait per launch
        return plain_group_search(model, ops, tb_loc, chunk_locs, batch, launch_steps).cpu()

    return step


def mixed_slot_search_step(groups: Sequence[tuple], batch: int,
                           launch_steps: int = 1) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """Mixed-hash step: ``groups`` is a sequence of ``(model_name, n_blocks,
    tb_loc, chunk_locs, n_slots)``; ``step(group_rows)`` takes one tuple of
    six slot rows per group (as ``slot_search_step``) and returns one
    ``int64[n_slots]`` CPU tensor per group."""
    steps = [slot_search_step(m, nb, tl, cl, batch, n, launch_steps)
             for m, nb, tl, cl, n in groups]

    def step(group_rows) -> Tuple[torch.Tensor, ...]:
        return tuple(st(*rows) for st, rows in zip(steps, group_rows))

    return step
