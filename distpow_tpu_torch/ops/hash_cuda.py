"""Wrapper of the hand-written CUDA search kernels (``csrc/*_search.cu``).

Counterpart of the reference's Pallas launch site
(``distpow_tpu/ops/md5_pallas.py`` ``build_pallas_search_step`` /
``cached_pallas_search_step``).  One kernel per hash model, all with the
same C interface: ``md5_search`` (``md5.cuh``), ``sha256_search`` and
``sha256d_search`` (``sha256.cuh``), ``sha1_search`` (``sha1.cuh``),
``ripemd160_search`` (``ripemd160.cuh``), ``sha512_search`` and
``sha384_search`` (``sha512.cuh``), ``sha3_256_search`` (``sha3.cuh``) and
``blake2b_256_search`` (``blake2b.cuh``).  ``hash_search`` checks the
operands against the model, allocates the result cell, launches the
model's kernel on the current stream and counts the launch (md5's
kernels are built per tail layout, each layout's library at its first
launch, or by ``load_kernels``).  For CUDA
tensors it launches or raises; only for tensors on the CPU does it run the
plain version (``plain_search``, the same function in PyTorch).  No
``try`` falls back from one to the other.

Each kernel's library also holds its group form, the counterpart of the
reference scheduler's ``distpow_tpu/sched/lanes.py``
``build_pallas_group_step``: ``hash_group_search`` searches a group of
scheduler slots that share a tail layout in one launch, each slot with its
own operands (``GroupOperands``), and counts under
``LAUNCHES["<kernel>_group"]``; its plain version is
``search_step.plain_group_search``.

And its mesh form, the counterpart of the reference's
``distpow_tpu/parallel/mesh_search.py`` ``_dyn_pallas_mesh_step``:
``hash_mesh_search`` launches one shard of a search spread over a mesh of
devices, the solo kernel's body over the shard's slice of the partition,
each hit reported as the partition's flat index; it counts under
``LAUNCHES["<kernel>_mesh"]``, and its plain version is
``search_step.plain_shard_search``.  ``parallel/mesh_search.py`` launches
the shards and takes the least index across them.

And the persistent forms of the solo and mesh launches, the device side of
the persistent search loop (``parallel/search.py persistent_search``; the
reference's XLA ``persistent_search_step`` and ``mesh_persistent_step``):
``hash_persistent_search`` and ``hash_mesh_persistent_search`` launch the
kernels' persistent form (the same body, which also reads the search's
stop flag, a device word) and return a two-word cell, (first hit, segments
executed), without synchronising.  A launch stops about one segment after
its own first hit, or after the driver sets the flag; one expected to hold
a hit runs on one resident wave of blocks (``one_wave_for``), so that it
stops near its hit.  They count under ``LAUNCHES["<kernel>_persistent"]``
and ``LAUNCHES["<kernel>_mesh_persistent"]``; their plain versions are
``search_step.persistent_search_step`` and
``plain_shard_persistent_search``.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.registry import HashModel
from .operands import MASK32, Device, GroupOperands, StepOperands
from .search_step import (MeshOrigin, _check_launch, _check_persistent, plain_group_search,
                          plain_search, plain_shard_persistent_search, plain_shard_search,
                          persistent_search_step)

# Blocks per SM of a launch's grid: a few waves of 256-thread blocks, so
# blocks that finish early (a thread stops at its first hit) leave no SM idle.
BLOCKS_PER_SM = 16
BLOCK_THREADS = 256  # BLOCK_THREADS / HASH_BLOCK_THREADS of the kernels

# hash model -> kernel: csrc/<kernel>.cu exports distpow_<kernel>
KERNELS = {
    "md5": "md5_search",
    "sha256": "sha256_search",
    "sha256d": "sha256d_search",
    "sha1": "sha1_search",
    "ripemd160": "ripemd160_search",
    "sha512": "sha512_search",
    "sha384": "sha384_search",
    "sha3_256": "sha3_256_search",
    "blake2b_256": "blake2b_256_search",
}

# Mask-word counts each kernel is built for, besides the full digest: a
# difficulty that reads more trailing words than this runs the full-digest
# kernel on masks padded with leading zero words, which every candidate meets.
MASK_WORD_KEYS = (1, 2, 3, 4)

# The kernels built for each tail layout (md5.cuh's Md5<VW>): model ->
# {n_blocks: the var_words a kernel exists for}.  md5's run starts in the
# tail's first block, whose remainder of the nonce is at most 63 bytes: at
# word 0-15 of a two-block tail, and at word 13 at the latest in a
# one-block tail, which also holds the 0x80 byte and the 8-byte length.
# ops/packing.py produces no other md5 layout, whatever the chunk width.
KEYED_LAYOUTS = {"md5": {1: range(0, 14), 2: range(0, 16)}}


class LaunchCounter:
    """Kernel launches, counted where the wrapper launches and nowhere else."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


# one counter per kernel, group kernel ("<kernel>_group"), mesh kernel
# ("<kernel>_mesh") and persistent form of the solo and mesh kernels
LAUNCH_FORMS = ("", "_group", "_mesh", "_persistent", "_mesh_persistent")
LAUNCHES = {f"{kernel}{form}": LaunchCounter() for kernel in KERNELS.values()
            for form in LAUNCH_FORMS}


def kernel_name(model: HashModel) -> str:
    """The kernel of ``model``; raises for a model that has none."""
    try:
        return KERNELS[model.name]
    except KeyError:
        raise ValueError(f"no CUDA kernel for hash model {model.name!r}; "
                         f"kernels exist for {sorted(KERNELS)}") from None


def kernel_mask_words(mask_words: int, model: HashModel) -> int:
    """The ``MASK_WORDS`` key a launch at ``mask_words`` runs under."""
    return mask_words if mask_words in MASK_WORD_KEYS else model.digest_words


def kernel_layout(tb_loc, chunk_locs, model: HashModel) -> Tuple[int, int, int]:
    """The kernel's layout arguments ``(var_word, var_shift, chunk_mask)``.

    The kernels take the candidate's variable bytes as one contiguous run
    (thread byte, then chunk bytes 0..width-1), which is what packing
    builds for every model; any other layout raises.  A byte's position in
    the tail is ``block_bytes * block + 4 * word + offset``, where
    ``offset`` is ``shift / 8`` in little-endian words and ``3 - shift / 8``
    in big-endian ones.  ``var_word`` counts message words only,
    ``words_per_block`` per block: a row's parameter words (blake2b's)
    never hold a variable byte, so the run's second word is ``var_word +
    1`` in this count even where the run crosses into the next block.
    ``var_shift`` is the thread byte's own shift."""
    byteorder, wpb = model.word_byteorder, model.words_per_block
    if byteorder not in ("little", "big"):
        raise ValueError(f"bad byte order {byteorder!r}")

    def pos(b, w, s):
        return b * model.block_bytes + w * 4 + (s // 8 if byteorder == "little" else 3 - s // 8)

    b, w, s = tb_loc
    if s % 8 or not 0 <= s < 32 or not 0 <= w < wpb or b not in (0, 1):
        raise ValueError(f"bad thread-byte location {tb_loc}")
    start = pos(b, w, s)
    for j, (cb, cw, cs) in enumerate(chunk_locs):
        if cs % 8 or not 0 <= cs < 32 or pos(cb, cw, cs) != start + 1 + j:
            raise ValueError(
                f"chunk byte {j} at {(cb, cw, cs)} does not follow the thread "
                f"byte at {tb_loc}: the kernel takes one contiguous run"
            )
    width = len(chunk_locs)
    if width > 4:
        raise ValueError("at most 4 variable chunk bytes")
    var_word = b * wpb + w
    keyed = KEYED_LAYOUTS.get(model.name)
    if keyed is not None and all(var_word not in words for words in keyed.values()):
        raise ValueError(f"no {model.name} kernel is built for a run at message word "
                         f"{var_word}")
    return var_word, s, (1 << (8 * width)) - 1


def check_tail(model: HashModel, n_blocks: int, var_word: int, tb_loc) -> None:
    """Raises unless a kernel of ``model`` exists for a run at message word
    ``var_word`` of an ``n_blocks``-block tail."""
    if var_word >= model.words_per_block * n_blocks:
        raise ValueError(f"thread byte at {tb_loc} is outside the {n_blocks}-block tail")
    keyed = KEYED_LAYOUTS.get(model.name)
    if keyed is not None and var_word not in keyed.get(n_blocks, ()):
        raise ValueError(f"no {model.name} kernel is built for a run at message word "
                         f"{var_word} of a {n_blocks}-block tail")


def _library(name: str, model: HashModel, var_word: int):
    """The loaded library of kernel ``name`` that serves a run at message
    word ``var_word``: the one library of the kernel, or for a model whose
    kernels are built per tail layout, the one built for ``var_word``
    (built now if it is not yet)."""
    from ._build import load_library

    return load_library(name, var_word if model.name in KEYED_LAYOUTS else None)


def load_kernels(model: HashModel, tails) -> None:
    """Build, all at once, and load the libraries of ``model``'s kernel
    that launches at the tail layouts ``tails`` (``(tb_loc, chunk_locs)``
    pairs) need: its one library, or for a model whose kernels are built per
    tail layout, the one of each layout's var_word."""
    from ._build import build, library_key, load_library

    name = kernel_name(model)
    if model.name not in KEYED_LAYOUTS:
        load_library(name)
        return
    var_words = sorted({kernel_layout(tb_loc, chunk_locs, model)[0]
                        for tb_loc, chunk_locs in tails})
    build([library_key(name, w) for w in var_words])
    for w in var_words:
        load_library(name, w)


# A persistent launch expected to hold at least this many hits runs on one
# resident wave, where its threads reach the first hit in index order and
# the launch ends near it; one expected to hold fewer runs on the serial
# kernel's grid of several waves, which sweeps a launch without a hit up to
# 8 % faster (md5; PERF.md section 6).
ONE_WAVE_EXPECTED_HITS = 0.5


def one_wave_for(n: int, difficulty: int) -> bool:
    """Whether a persistent launch over ``n`` candidates at ``difficulty``
    (each candidate hits with probability 16^-difficulty) runs on one
    resident wave (``ONE_WAVE_EXPECTED_HITS``)."""
    return n >= ONE_WAVE_EXPECTED_HITS * 16 ** difficulty


def default_grid(n: int, sm_count: int) -> int:
    """Blocks for a launch over ``n`` indices: a few waves per SM, and no
    more blocks than there are indices for."""
    return max(1, min(-(-n // BLOCK_THREADS), sm_count * BLOCKS_PER_SM))


def _check_operands(ops: StepOperands, device: torch.device, model: HashModel) -> None:
    tensors = {"init": ops.init, "base": ops.base, "masks": ops.masks}
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}, the call asks for {device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must hold uint32 bit patterns as int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError("operands lie on different devices")
    n_state = len(model.init_state)
    if tuple(ops.init.shape) != (n_state,):
        raise ValueError(f"{model.name} init must be [{n_state}], got {tuple(ops.init.shape)}")
    row = model.row_words
    if ops.base.dim() != 2 or ops.base.shape[1] != row or ops.n_blocks not in (1, 2):
        raise ValueError(f"{model.name} base must be [1 or 2, {row}], "
                         f"got {tuple(ops.base.shape)}")
    if ops.masks.dim() != 1 or not 1 <= ops.mask_words <= model.digest_words:
        raise ValueError(f"{model.name} masks must be [1..{model.digest_words}], "
                         f"got {tuple(ops.masks.shape)}")
    if ops.tb_count < 1 or ops.tb_lo < 0 or ops.tb_lo + ops.tb_count > 256:
        raise ValueError(f"bad thread-byte run ({ops.tb_lo}, {ops.tb_count})")


def _check_search(name: str, model: HashModel, ops: StepOperands, chunk0: int, batch: int,
                  launch_steps: int, device: torch.device) -> None:
    _check_operands(ops, device, model)
    _check_launch(batch, launch_steps)
    if not 0 <= chunk0 <= MASK32:
        raise ValueError(f"chunk0 {chunk0} is not a uint32")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name} on a CUDA device, but CUDA is not available")


def _launch_search(name: str, function: str, model: HashModel, ops: StepOperands, tb_loc,
                   chunk_locs, chunk0: int, n: int, grid: Optional[int],
                   origin: Tuple[int, ...] = (), persist=None) -> torch.Tensor:
    """Launch ``csrc/<name>.cu``'s ``function`` (the solo search, or with
    the three ``origin`` words the mesh shard's) over ``n`` flat indices on
    the current stream of the operands' device; return its result cell.
    ``persist`` is the persistent form's ``(stop, seg, segments, batch,
    one_wave)``: the flag word, the segment in reported indices, the
    segments word's initial value, the launch's own segment in flat indices
    and whether a ``grid`` of None is one resident wave (the launcher asks
    the device how many blocks that is) or ``default_grid``; the cell is
    then two words."""
    var_word, var_shift, chunk_mask = kernel_layout(tb_loc, chunk_locs, model)
    check_tail(model, ops.n_blocks, var_word, tb_loc)
    lib = _library(name, model, var_word)
    mw = kernel_mask_words(ops.mask_words, model)
    masks = F.pad(ops.masks, (mw - ops.mask_words, 0)) if mw != ops.mask_words else ops.masks
    tbc = ops.tb_count
    log_tbc = tbc.bit_length() - 1 if tbc & (tbc - 1) == 0 else -1
    dev = ops.device
    with torch.cuda.device(dev):
        extra, one_wave = (), persist is not None and persist[4]
        if grid is None:
            # 0: one resident wave, sized by the launcher
            grid = 0 if one_wave else default_grid(
                n, torch.cuda.get_device_properties(dev).multi_processor_count)
        if persist is None:
            out = torch.full((), -1, dtype=torch.int32, device=dev)  # SENTINEL's bits
        else:
            stop, seg, segments, batch, _ = persist
            out = torch.full((2,), -1, dtype=torch.int32, device=dev)
            out[1].fill_(segments)
            extra = (stop.data_ptr(), seg, batch)
        rc = getattr(lib, function)(
            ops.init.data_ptr(), ops.base.data_ptr(), masks.data_ptr(),
            ops.n_blocks, mw,
            chunk0, ops.tb_lo, tbc, log_tbc,
            var_word, var_shift, chunk_mask,
            n, *origin, *extra, out.data_ptr(), grid,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{function} kernel launch failed: CUDA error {rc}")
    return out


def hash_search(model: HashModel, ops: StepOperands, tb_loc, chunk_locs, chunk0: int,
                batch: int, launch_steps: int = 1, *, device: Device,
                grid: Optional[int] = None) -> torch.Tensor:
    """First hitting flat index in ``[0, batch * launch_steps)``, or SENTINEL.

    On a CUDA device: launches ``model``'s kernel and returns its result
    cell, a 0-d ``int32`` tensor holding the uint32 bit pattern (SENTINEL
    is -1 there), without synchronising.  On the CPU: the plain version, a
    0-d ``int64``.  ``grid`` overrides the number of blocks.
    """
    name = kernel_name(model)
    device = torch.device(device)
    _check_search("hash_search", model, ops, chunk0, batch, launch_steps, device)
    if device.type == "cpu":
        return plain_search(ops, tb_loc, chunk_locs, chunk0, batch, launch_steps, model=model)
    out = _launch_search(name, f"distpow_{name}", model, ops, tb_loc, chunk_locs, chunk0,
                         batch * launch_steps, grid)
    LAUNCHES[name].add()
    return out


def _check_origin(ops: StepOperands, chunk0: int, n: int, origin) -> MeshOrigin:
    """The partition ``origin`` of a shard of ``n`` flat indices from
    ``chunk0``, checked: it holds the shard's run, and every partition
    index of the shard lies below 2^31."""
    origin = MeshOrigin(*(int(v) for v in origin))
    if not (0 <= origin.chunk0 <= MASK32 and origin.tb_lo <= ops.tb_lo
            and ops.tb_lo + ops.tb_count <= origin.tb_lo + origin.tbc):
        raise ValueError(f"shard run ({ops.tb_lo}, {ops.tb_count}) at {chunk0} is not inside "
                         f"the partition {origin}")
    chunks = ((chunk0 - origin.chunk0) & MASK32) + -(-n // ops.tb_count)
    if chunks * origin.tbc > 1 << 31:
        raise ValueError(f"shard at chunk {chunk0} reaches partition index {chunks * origin.tbc}; "
                         f"partition indices require < 2^31")
    return origin


def hash_mesh_search(model: HashModel, ops: StepOperands, tb_loc, chunk_locs, chunk0: int,
                     batch: int, launch_steps: int, origin: MeshOrigin, *, device: Device,
                     grid: Optional[int] = None) -> torch.Tensor:
    """One shard of a mesh launch: the first hit among the shard's
    ``batch * launch_steps`` candidates, the run ``(ops.tb_lo,
    ops.tb_count)`` from cursor ``chunk0``, as the flat index of the
    partition ``origin`` (``search_step.MeshOrigin``: the launch's cursor
    and the partition's run, which holds the shard's), or SENTINEL.

    On a CUDA device: launches ``model``'s mesh kernel on the current
    stream of the operands' device and returns its result cell (an
    ``int32`` bit pattern, SENTINEL is -1) without synchronising.  On the
    CPU: the plain version (``plain_shard_search``), a 0-d ``int64``.
    Every partition index of the shard must lie below 2^31.
    """
    name = kernel_name(model)
    device = torch.device(device)
    _check_search("hash_mesh_search", model, ops, chunk0, batch, launch_steps, device)
    n = batch * launch_steps
    origin = _check_origin(ops, chunk0, n, origin)
    if device.type == "cpu":
        return plain_shard_search(ops, tb_loc, chunk_locs, chunk0, batch, launch_steps, origin,
                                  model=model)
    from ._build import mesh_function

    out = _launch_search(name, mesh_function(name), model, ops, tb_loc, chunk_locs, chunk0, n,
                         grid, origin)
    LAUNCHES[f"{name}_mesh"].add()
    return out


def _check_stop(stop: torch.Tensor, ops: StepOperands) -> None:
    if not isinstance(stop, torch.Tensor) or stop.numel() != 1:
        raise ValueError("the stop flag must be a one-word tensor")
    if stop.device != ops.device:
        raise ValueError(f"the stop flag is on {stop.device}, the operands on {ops.device}")
    if stop.dtype != torch.int32:
        raise ValueError(f"the stop flag must be an int32 word, got {stop.dtype}")


def hash_persistent_search(model: HashModel, ops: StepOperands, tb_loc, chunk_locs,
                           chunk0: int, batch: int, segments: int, stop: torch.Tensor, *,
                           device: Device, one_wave: bool = True,
                           grid: Optional[int] = None) -> torch.Tensor:
    """The persistent form of ``hash_search``: up to ``segments`` segments of
    ``batch`` candidates from cursor ``chunk0``, stopping about one segment
    after the first hit or after the 0-d ``stop`` flag (on the launch's
    device) turns nonzero.  Returns the two words (first hit's flat index or
    SENTINEL, segments executed); a width-0 layout raises.

    On a CUDA device: launches ``model``'s kernel in its persistent form and
    returns its ``int32[2]`` cell (uint32 bit patterns) without
    synchronising.  With ``one_wave`` (``one_wave_for``) the grid is one
    resident wave, so the threads walk the launch in index order; else the
    serial kernel's (``default_grid``); ``grid`` names the blocks instead.
    On the CPU: the plain version, ``int64[2]``
    (``persistent_search_step``)."""
    name = kernel_name(model)
    device = torch.device(device)
    _check_search("hash_persistent_search", model, ops, chunk0, batch, segments, device)
    _check_persistent(tb_loc, chunk_locs, batch, segments)
    _check_stop(stop, ops)
    if device.type == "cpu":
        return persistent_search_step(ops, tb_loc, chunk_locs, chunk0, batch, segments, stop,
                                      model=model)
    from ._build import persistent_function

    out = _launch_search(name, persistent_function(name), model, ops, tb_loc, chunk_locs,
                         chunk0, batch * segments, grid,
                         persist=(stop, batch, segments, batch, one_wave))
    LAUNCHES[f"{name}_persistent"].add()
    return out


def hash_mesh_persistent_search(model: HashModel, ops: StepOperands, tb_loc, chunk_locs,
                                chunk0: int, batch: int, segments: int, origin: MeshOrigin,
                                seg: int, total: int, stop: torch.Tensor, *, device: Device,
                                one_wave: bool = True,
                                grid: Optional[int] = None) -> torch.Tensor:
    """The persistent form of ``hash_mesh_search``, one shard of a
    persistent mesh launch: up to ``segments`` segments of ``batch``
    candidates of the shard's run from ``chunk0``, stopping about one
    segment after the shard's own first hit or after ``stop`` turns
    nonzero.  Returns the first hit as the partition's flat index (or
    SENTINEL) and the segments executed, counted in the partition's
    segments of ``seg`` indices (``total`` where the shard found nothing and
    saw no flag): the least of each word across the shards is the mesh
    launch's result.

    On a CUDA device: the mesh kernel's persistent form, on the grid that
    ``one_wave`` and ``grid`` choose as in ``hash_persistent_search``, its
    ``int32[2]`` cell without synchronising.  On the CPU: the plain version,
    ``int64[2]`` (``plain_shard_persistent_search``)."""
    name = kernel_name(model)
    device = torch.device(device)
    _check_search("hash_mesh_persistent_search", model, ops, chunk0, batch, segments, device)
    _check_persistent(tb_loc, chunk_locs, batch, segments)
    _check_stop(stop, ops)
    origin = _check_origin(ops, chunk0, batch * segments, origin)
    if seg < 1 or total < 1:
        raise ValueError(f"bad partition segments: {total} of {seg} indices")
    if device.type == "cpu":
        return plain_shard_persistent_search(ops, tb_loc, chunk_locs, chunk0, batch, segments,
                                             origin, seg, total, stop, model=model)
    from ._build import mesh_persistent_function

    out = _launch_search(name, mesh_persistent_function(name), model, ops, tb_loc, chunk_locs,
                         chunk0, batch * segments, grid, origin,
                         persist=(stop, seg, total, batch, one_wave))
    LAUNCHES[f"{name}_mesh_persistent"].add()
    return out


def _check_group(ops: GroupOperands, device: torch.device, model: HashModel,
                 batch: int) -> None:
    n = ops.n_slots
    want = {"init": (n, len(model.init_state)), "base": (n, ops.n_blocks, model.row_words),
            "masks": (n, model.digest_words), "tb_lo": (n,), "log_tbc": (n,), "chunk0": (n,)}
    for name, shape in want.items():
        t = getattr(ops, name)
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}, the call asks for {device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 (uint32 bit patterns)")
        if tuple(t.shape) != shape:
            raise ValueError(f"{model.name} group {name} must be {list(shape)}, "
                             f"got {list(t.shape)}")
    if n < 1 or n > 65535 or ops.n_blocks not in (1, 2):
        raise ValueError(f"bad group: {n} slots of {ops.n_blocks} tail blocks")
    _check_launch(batch, 1)


def group_grid(batch: int, n_slots: int, sm_count: int) -> int:
    """Blocks per slot (the grid's x) for a group launch: the solo launch's
    few waves per SM shared among the slots, and no more blocks than a
    slot has indices for."""
    return max(1, min(-(-batch // BLOCK_THREADS), sm_count * BLOCKS_PER_SM // n_slots))


def hash_group_search(model: HashModel, ops: GroupOperands, tb_loc, chunk_locs, batch: int,
                      *, device: Device) -> torch.Tensor:
    """Per slot, the first hitting flat index in ``[0, batch)`` or SENTINEL.

    Every slot shares the tail layout ``(n_blocks, tb_loc, chunk_locs)`` and
    has its own prefix state, rows, masks of every digest word, power-of-two
    run ``tb_lo[s] .. tb_lo[s] + 2^log_tbc[s] - 1`` and cursor ``chunk0[s]``.
    On a CUDA device: one launch of ``model``'s group kernel on the current
    stream, returning the ``int32[n_slots]`` result cells (uint32 bit
    patterns, SENTINEL is -1) without synchronising.  On the CPU: the plain
    version, ``int64[n_slots]``.  The grid is ``group_grid`` blocks per slot.
    """
    name = kernel_name(model)
    device = torch.device(device)
    _check_group(ops, device, model, batch)
    if device.type == "cpu":
        return plain_group_search(model, ops, tb_loc, chunk_locs, batch)
    if device.type != "cuda":
        raise ValueError(f"hash_group_search runs on cuda or cpu, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("hash_group_search on a CUDA device, but CUDA is not available")
    var_word, var_shift, chunk_mask = kernel_layout(tb_loc, chunk_locs, model)
    check_tail(model, ops.n_blocks, var_word, tb_loc)
    from ._build import group_function

    lib = _library(name, model, var_word)
    dev = ops.device
    with torch.cuda.device(dev):
        grid_x = group_grid(batch, ops.n_slots,
                            torch.cuda.get_device_properties(dev).multi_processor_count)
        out = torch.full((ops.n_slots,), -1, dtype=torch.int32, device=dev)  # SENTINEL's bits
        rc = getattr(lib, group_function(name))(
            ops.init.data_ptr(), ops.base.data_ptr(), ops.masks.data_ptr(), ops.n_blocks,
            var_word, var_shift, chunk_mask,
            ops.tb_lo.data_ptr(), ops.log_tbc.data_ptr(), ops.chunk0.data_ptr(),
            ops.n_slots, batch, out.data_ptr(), grid_x,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} group kernel launch failed: CUDA error {rc}")
    LAUNCHES[f"{name}_group"].add()
    return out
