"""Arithmetic candidate -> message-word packing.

A candidate is the pair ``(thread_byte, chunk_int)``; the message words of
the hash's final block(s) are computed from those two integers and a
constant template (``TailSpec``), built once per (nonce, chunk width) on
the host:

* every complete block of the nonce is absorbed into the hash state on the
  host, so long nonces cost nothing per candidate;
* the tail ``nonce_remainder ‖ tb ‖ chunk ‖ extra ‖ padding`` spans one or
  two blocks whose constant words are ``base_words`` and whose variable
  bytes are (block, word, shift) locations.  Each block's row is the
  model's ``words_per_block`` message words, then its ``param_words``
  (blake2b's byte count and finalization word).

The padding follows the model's family: "md" (``0x80``, zeros, the bit
length), "sha3" (``0x06`` after the message, ``0x80`` into the last rate
byte, merged to ``0x86`` when they meet, no length) or "blake2" (zero
fill only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from ..models.registry import HashModel

ByteLoc = Tuple[int, int, int]  # (block index, word index, bit shift)


@dataclass(frozen=True)
class TailSpec:
    """Description of the final block(s) for one chunk width."""

    model_name: str
    nonce_len: int
    width: int                       # variable chunk bytes (0..4)
    init_state: Tuple[int, ...]      # state after the absorbed nonce blocks
    n_blocks: int                    # tail blocks hashed per candidate (1-2)
    base_words: Tuple[Tuple[int, ...], ...]  # [n_blocks][model.row_words] constant words
    tb_loc: ByteLoc                  # where the thread byte lands
    chunk_locs: Tuple[ByteLoc, ...]  # where chunk byte j (LE) lands


def _byte_loc(pos: int, model: HashModel) -> ByteLoc:
    block, off = divmod(pos, model.block_bytes)
    word, j = divmod(off, 4)
    shift = 8 * j if model.word_byteorder == "little" else 8 * (3 - j)
    return block, word, shift


def build_tail_spec(
    nonce: bytes, width: int, model: HashModel, extra_const_chunk: bytes = b""
) -> TailSpec:
    """Packing template for candidates ``nonce ‖ tb ‖ chunk ‖ extra``.

    ``width`` counts the chunk bytes that vary per candidate (<= 4, so a
    chunk fits 32 bits); ``extra_const_chunk`` holds constant high chunk
    bytes, which is how the driver reaches chunk widths above 4.
    """
    if not 0 <= width <= 4:
        raise ValueError("variable chunk width must be in [0, 4]")
    nonce = bytes(nonce)
    state, rem, _ = model.py_absorb(nonce)
    msg_len = len(nonce) + 1 + width + len(extra_const_chunk)
    content = len(rem) + 1 + width + len(extra_const_chunk)
    min_pad = {"md": 1 + model.length_bytes, "sha3": 1, "blake2": 0}[model.padding]
    n_blocks = (content + min_pad + model.block_bytes - 1) // model.block_bytes
    tail = bytearray(n_blocks * model.block_bytes)
    tail[: len(rem)] = rem
    tb_pos = len(rem)
    chunk_pos0 = tb_pos + 1
    extra_pos = chunk_pos0 + width
    tail[extra_pos : extra_pos + len(extra_const_chunk)] = extra_const_chunk
    end = extra_pos + len(extra_const_chunk)
    if model.padding == "md":
        tail[end] = 0x80
        tail[-model.length_bytes:] = (msg_len * 8).to_bytes(
            model.length_bytes, model.length_byteorder)
    elif model.padding == "sha3":
        tail[end] ^= 0x06
        tail[-1] ^= 0x80

    absorbed = len(nonce) - len(rem)
    base_words: List[Tuple[int, ...]] = []
    for b in range(n_blocks):
        blk = tail[b * model.block_bytes : (b + 1) * model.block_bytes]
        row = tuple(int.from_bytes(blk[4 * w : 4 * w + 4], model.word_byteorder)
                    for w in range(model.words_per_block))
        if model.param_words:
            row += tuple(model.block_param_words(absorbed, content, b, n_blocks))
        base_words.append(row)

    return TailSpec(
        model_name=model.name,
        nonce_len=len(nonce),
        width=width,
        init_state=tuple(state),
        n_blocks=n_blocks,
        base_words=tuple(base_words),
        tb_loc=_byte_loc(tb_pos, model),
        chunk_locs=tuple(_byte_loc(chunk_pos0 + j, model) for j in range(width)),
    )


def make_words(spec: TailSpec, tb, chunk) -> List[List]:
    """Tail block word lists for a batch of candidates.

    ``tb`` and ``chunk`` are broadcast-compatible int64 tensors (or
    ints).  Returns ``spec.n_blocks`` rows of ``model.row_words`` entries,
    each an int (a constant word) or an int64 tensor (a word holding
    variable bytes).
    """
    blocks: List[List] = [list(bw) for bw in spec.base_words]
    b, w, s = spec.tb_loc
    blocks[b][w] = blocks[b][w] | (torch.as_tensor(tb, dtype=torch.int64) << s)
    chunk = torch.as_tensor(chunk, dtype=torch.int64)
    for j, (b, w, s) in enumerate(spec.chunk_locs):
        blocks[b][w] = blocks[b][w] | (((chunk >> (8 * j)) & 0xFF) << s)
    return blocks


def pack_reference_bytes(
    nonce: bytes, tb: int, chunk_int: int, width: int, extra_const_chunk: bytes = b""
) -> bytes:
    """Host-side twin of ``make_words``: the exact message bytes."""
    chunk = int(chunk_int).to_bytes(width, "little") if width else b""
    return bytes(nonce) + bytes([tb]) + chunk + extra_const_chunk
