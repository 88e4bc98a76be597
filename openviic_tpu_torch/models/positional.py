"""Positional encodings (counterpart of ``openviic_tpu/models/positional.py``):
pure functions, no parameters."""

from __future__ import annotations

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
                                  temperature: float = 10000.0) -> torch.Tensor:
    """DETR-style 1D positional embedding over the sequence axis of a
    (bs, seq, d) tensor, without a mask: positions 1..seq.  Float32."""
    bs, n = x.shape[:2]
    embed = torch.arange(1, n + 1, dtype=torch.float32, device=x.device)
    embed = embed[None, :].expand(bs, n)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=x.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos = embed[:, :, None] / dim_t
    pos = torch.stack((pos[:, :, 0::2].sin(), pos[:, :, 1::2].cos()), dim=-1)
    return pos.reshape(bs, n, -1)
