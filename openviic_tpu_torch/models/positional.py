"""Positional encodings (counterpart of ``openviic_tpu/models/positional.py``):
pure functions, no parameters."""

from __future__ import annotations

import math

import numpy as np
import torch


def sinusoid_encoding_table(max_len: int, d_model: int,
                            padding_idx: int | None = None) -> np.ndarray:
    """Interleaved sin/cos table, row ``padding_idx`` zeroed: the sin/cos
    pair at dims (2i, 2i+1) share the argument pos / 10000**(2i/d_model)."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    dim = np.arange(d_model // 2, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, 2.0 * dim / d_model)
    out = np.zeros((max_len, d_model), dtype=np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    if padding_idx is not None:
        out[padding_idx] = 0.0
    return out


def sinusoid_positional_embedding(x: torch.Tensor, num_pos_feats: int,
                                  mask: torch.Tensor | None = None,
                                  temperature: float = 10000.0, normalize: bool = False,
                                  scale: float | None = None) -> torch.Tensor:
    """DETR-style 1D positional embedding over the sequence axis of a
    (bs, seq, d) tensor, float32.  Positions are the running count of
    unmasked entries (1..seq without ``mask``; ``mask`` (bs, seq) is True
    where masked).  ``normalize`` divides them by the last one (plus 1e-6)
    and multiplies by ``scale`` (default 2 pi), the DLCT encoder's
    variant."""
    if scale is None:
        scale = 2.0 * math.pi
    bs, n = x.shape[:2]
    if mask is None:
        embed = torch.arange(1, n + 1, dtype=torch.float32, device=x.device)
        embed = embed[None, :].expand(bs, n)
    else:
        embed = torch.cumsum((~mask).float(), dim=1)
    if normalize:
        embed = embed / (embed[:, -1:] + 1e-6) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=x.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos = embed[:, :, None] / dim_t
    pos = torch.stack((pos[:, :, 0::2].sin(), pos[:, :, 1::2].cos()), dim=-1)
    return pos.reshape(bs, n, -1)
