"""Geometric (bounding-box) relation features (counterpart of
``openviic_tpu/models/geometry.py``): ``box_relational_embedding``, with
the trigonometric embedding on or off; ``get_grids_position``, the boxes
of a grid's cells; and ``get_combine_masks``, DLCT's region-to-grid
visibility masks."""

from __future__ import annotations

import numpy as np
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


def get_grids_position(batch_size: int, seq_len: int, grid_size) -> np.ndarray:
    """Normalized (0..1) boxes (x_min, y_min, x_max, y_max) of the cells of
    a ``grid_size`` = (gx, gy) grid, cell i at x index i // gx and y index
    i % gy, repeated over the batch: (batch_size, seq_len, 4) float32, a
    host constant."""
    assert seq_len == grid_size[0] * grid_size[1]
    x = np.arange(grid_size[0], dtype=np.float32)
    y = np.arange(grid_size[1], dtype=np.float32)
    px_min = np.repeat(x, grid_size[0])
    py_min = np.tile(y, grid_size[1])
    boxes = np.stack([px_min / grid_size[0], py_min / grid_size[1],
                      (px_min + 1) / grid_size[0], (py_min + 1) / grid_size[1]], axis=-1)
    return np.broadcast_to(boxes[None], (batch_size, seq_len, 4)).copy()


def get_combine_masks(boxes: torch.Tensor, grid_size: int = 7) -> torch.Tensor:
    """Region-to-grid visibility masks, True = masked: for each region box
    (bs, n, 4), normalized, the grid cells from the cell holding its
    (x_min, y_min) corner to the one holding (x_max, y_max) are visible.
    A coordinate's cell index is the count of grid lines arange(g) / g (in
    float32) at or below it, less one, and at least 0; the boxes are
    compared in float32 whatever their dtype, so bf16 boxes decide by their
    rounded values, as in the JAX package.  Returns (bs, 1, n, g * g)."""
    grids = torch.arange(grid_size, dtype=torch.float32, device=boxes.device) / grid_size
    coords = boxes.float()

    def lower_bound(c: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min((grids <= c[..., None]).sum(-1) - 1, 0)

    x1, y1, x2, y3 = (lower_bound(coords[..., i]) for i in range(4))
    cells = torch.arange(grid_size * grid_size, device=boxes.device)
    gy, gx = cells // grid_size, cells % grid_size
    visible = ((gy >= y1[..., None]) & (gy <= y3[..., None])
               & (gx >= x1[..., None]) & (gx <= x2[..., None]))
    return (~visible)[:, None]
