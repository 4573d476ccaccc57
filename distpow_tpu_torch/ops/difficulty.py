"""Trailing-zero-nibble difficulty as per-digest-word masks.

A trailing ``'0'`` hex character is a zero nibble of the raw digest,
counted from the end (worker.go:354-356).  For a fixed difficulty ``k``
the predicate "digest has >= k trailing zero nibbles" is one constant
mask per digest word: AND, OR together, compare with zero.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..models.registry import HashModel


def nibble_masks(k: int, model: HashModel) -> Tuple[int, ...]:
    """Per-digest-word masks covering the last ``k`` nibbles.

    The digest has >= k trailing zero nibbles iff ``word_i & mask_i == 0``
    for every word.  ``k`` may be 0 (all masks zero) up to
    ``model.max_difficulty``.
    """
    if k < 0:
        raise ValueError("difficulty must be non-negative")
    if k > model.max_difficulty:
        raise ValueError(
            f"difficulty {k} exceeds {model.name}'s digest nibble count "
            f"({model.max_difficulty}); the puzzle is unsatisfiable"
        )
    masks = [0] * model.digest_words
    for t in range(k):
        byte_idx = model.digest_bytes - 1 - t // 2
        nib = 0x0F if t % 2 == 0 else 0xF0
        word, j = divmod(byte_idx, 4)
        shift = 8 * j if model.word_byteorder == "little" else 8 * (3 - j)
        masks[word] |= nib << shift
    return tuple(masks)


def meets_difficulty(state: Sequence, masks: Sequence[int]) -> torch.Tensor:
    """Bool tensor: True where the digest words pass the masks."""
    acc = None
    for w, m in zip(state, masks):
        if m == 0:
            continue
        term = torch.as_tensor(w, dtype=torch.int64) & m
        acc = term if acc is None else (acc | term)
    if acc is None:
        return torch.ones_like(torch.as_tensor(state[0]), dtype=torch.bool)
    return acc == 0
