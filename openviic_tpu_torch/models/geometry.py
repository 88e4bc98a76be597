"""Geometric (bounding-box) relation features (counterpart of
``openviic_tpu/models/geometry.py``): ``box_relational_embedding``, with
the trigonometric embedding on or off.  ``get_grids_position`` and
``get_combine_masks`` are not ported yet (grid and DLCT models)."""

from __future__ import annotations

import torch


def box_relational_embedding(f_g: torch.Tensor, dim_g: int = 64, wave_len: float = 1000.0,
                             trignometric_embedding: bool = True) -> torch.Tensor:
    """Pairwise log-space box displacement embedding.

    ``f_g``: (bs, n, 4) boxes as (x_min, y_min, x_max, y_max).  Returns
    (bs, n, n, dim_g) with the trig embedding, else (bs, n, n, 4).  The
    displacements are computed in the boxes' dtype; the trig embedding's
    frequencies are float32, so its product and sin/cos are float32, as in
    the JAX package."""
    x_min, y_min, x_max, y_max = f_g.split(1, dim=-1)  # each (bs, n, 1)
    cx = (x_min + x_max) * 0.5
    cy = (y_min + y_max) * 0.5
    w = (x_max - x_min) + 1.0
    h = (y_max - y_min) + 1.0

    bs = f_g.shape[0]
    delta_x = torch.log(torch.clamp_min(((cx - cx.reshape(bs, 1, -1)) / w).abs(), 1e-3))
    delta_y = torch.log(torch.clamp_min(((cy - cy.reshape(bs, 1, -1)) / h).abs(), 1e-3))
    delta_w = torch.log(w / w.reshape(bs, 1, -1))
    delta_h = torch.log(h / h.reshape(bs, 1, -1))
    position_mat = torch.stack((delta_x, delta_y, delta_w, delta_h), dim=-1)  # (bs, n, n, 4)
    if not trignometric_embedding:
        return position_mat

    feat_range = torch.arange(dim_g / 8, dtype=torch.float32, device=f_g.device)
    dim_mat = 1.0 / torch.pow(wave_len, feat_range / (dim_g / 8))
    mul_mat = 100.0 * position_mat[..., None] * dim_mat  # (bs, n, n, 4, dim_g/8)
    mul_mat = mul_mat.reshape(*mul_mat.shape[:3], -1)  # (bs, n, n, dim_g/2)
    return torch.cat((torch.sin(mul_mat), torch.cos(mul_mat)), dim=-1)
