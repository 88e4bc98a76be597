"""Mask helpers.  Convention: ``True`` = masked.

Counterpart of ``openviic_tpu/models/masks.py``.  The padding mask keeps the
"sum over the last dim == padding_idx" quirk, which flags both pad tokens
(id 0) and all-zero feature rows; padded feature rows are exactly zero, so
this convention is load-bearing."""

from __future__ import annotations

import torch


def generate_padding_mask(sequences: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """(bs, seq_len) ids or (bs, seq_len, dim) features -> (bs, 1, 1, seq_len) bool."""
    seq = sequences[..., None] if sequences.dim() == 2 else sequences
    mask = seq.sum(dim=-1) == padding_idx
    return mask[:, None, None, :]


def generate_sequential_mask(seq_len: int, device=None) -> torch.Tensor:
    """Upper-triangular causal mask -> (1, 1, seq_len, seq_len) bool."""
    ones = torch.ones((seq_len, seq_len), dtype=torch.bool, device=device)
    return torch.triu(ones, diagonal=1)[None, None]
