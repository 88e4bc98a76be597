"""Vision (visual-feature) embeddings (counterparts of
``openviic_tpu/models/vision_embedding.py``): ``FeatureEmbedding``, a
linear projection D_FEATURE -> D_MODEL plus dropout, its padding mask from
all-zero feature rows; ``DualFeatureEmbedding``, separate region and grid
projections; and ``GeometricDualFeatureEmbedding``, which adds DLCT's
region <-> grid visibility masks."""

from __future__ import annotations

import torch
from torch import nn

from openviic_tpu_torch.builders import META_VISION_EMBEDDING
from openviic_tpu_torch.models.geometry import get_combine_masks
from openviic_tpu_torch.models.initializers import TorchLinear
from openviic_tpu_torch.models.masks import generate_padding_mask


@META_VISION_EMBEDDING.register()
class FeatureEmbedding(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.proj = TorchLinear(config.D_FEATURE, config.D_MODEL)
        self.dropout = nn.Dropout(config.DROPOUT)

    def forward(self, features):
        masks = generate_padding_mask(features, padding_idx=0)
        return self.dropout(self.proj(features)), masks


@META_VISION_EMBEDDING.register()
class DualFeatureEmbedding(nn.Module):
    """``region_proj`` (D_REGION_FEATURE -> D_MODEL) and ``grid_proj``
    (D_GRID_FEATURE -> D_MODEL), each with its padding mask."""

    def __init__(self, config):
        super().__init__()
        self.region_proj = TorchLinear(config.D_REGION_FEATURE, config.D_MODEL)
        self.grid_proj = TorchLinear(config.D_GRID_FEATURE, config.D_MODEL)
        self.dropout = nn.Dropout(config.DROPOUT)

    def forward(self, region_features, grid_features):
        region_masks = generate_padding_mask(region_features, padding_idx=0)
        grid_masks = generate_padding_mask(grid_features, padding_idx=0)
        return ((self.dropout(self.region_proj(region_features)), region_masks),
                (self.dropout(self.grid_proj(grid_features)), grid_masks))


@META_VISION_EMBEDDING.register()
class GeometricDualFeatureEmbedding(DualFeatureEmbedding):
    """The dual projections and DLCT's attention masks over [regions |
    grids]: ``region2all`` (bs, 1, n_r, n_r + n_g) is the regions' padding
    mask broadcast over the region queries, then each region's grid cells
    (``get_combine_masks``); ``grid2all`` (bs, 1, n_g, n_r + n_g) is that
    visibility transposed, then the grids' padding mask broadcast over the
    grid queries.  The grid side is sqrt(grid_boxes rows); grid rows past
    its square (the loader's bucket padding, 49 -> 56) are masked in the
    visibility, as in the JAX package."""

    def forward(self, region_features, region_boxes, grid_features, grid_boxes):
        region_masks = generate_padding_mask(region_features, padding_idx=0)
        grid_masks = generate_padding_mask(grid_features, padding_idx=0)
        grid_size = int(grid_boxes.shape[1] ** 0.5)
        n_regions, n_grids = region_features.shape[1], grid_features.shape[1]
        region2grid = get_combine_masks(region_boxes, grid_size)
        if grid_size * grid_size != n_grids:
            region2grid = nn.functional.pad(region2grid, (0, n_grids - grid_size * grid_size),
                                            value=True)
        grid2region = region2grid.transpose(2, 3)
        region2all = torch.cat(
            [region_masks.expand(-1, -1, n_regions, -1), region2grid], dim=-1)
        grid2all = torch.cat([grid2region, grid_masks.expand(-1, -1, n_grids, -1)], dim=-1)
        (regions, _), (grids, _) = super().forward(region_features, grid_features)
        return (regions, region_masks), (grids, grid_masks), (region2all, grid2all)
