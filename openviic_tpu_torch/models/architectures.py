"""Registered captioning architectures (counterpart of
``openviic_tpu/models/architectures.py``): the single-stream shells
``StandardTransformerUsingRegion``, ``StandardTransformerUsingGrid``,
``MeshedMemoryTransformer`` and ``CamoTransformer`` (one vision stream into
the encoder their config names), ``ObjectRelationTransformer``, and the
two-stream ``DLCTTransformer`` and ``UnifiedTransformer``."""

from __future__ import annotations

from typing import Dict

import torch

from openviic_tpu_torch.builders import (
    META_ARCHITECTURE,
    build_decoder,
    build_encoder,
    build_vision_embedding,
)
from openviic_tpu_torch.models.base import BaseTransformer


@META_ARCHITECTURE.register()
class StandardTransformerUsingRegion(BaseTransformer):
    feature_key = "region_features"

    def __init__(self, config, vocab):
        super().__init__(config, vocab)
        self.vision_embedding = build_vision_embedding(config.VISION_EMBEDDING)
        self.encoder = build_encoder(config.ENCODER)
        self.decoder = build_decoder(config.DECODER, vocab)

    def encoder_forward(self, batch: Dict[str, torch.Tensor]):
        features, padding_mask = self.vision_embedding(batch[self.feature_key])
        return self.encoder(features, padding_mask), padding_mask


@META_ARCHITECTURE.register()
class StandardTransformerUsingGrid(StandardTransformerUsingRegion):
    """The same model over ``batch["grid_features"]``."""

    feature_key = "grid_features"


@META_ARCHITECTURE.register()
class MeshedMemoryTransformer(StandardTransformerUsingRegion):
    """The shell of the Meshed-Memory and the augmented-memory configs."""


@META_ARCHITECTURE.register()
class CamoTransformer(StandardTransformerUsingRegion):
    """The shell of the CAMO config."""


@META_ARCHITECTURE.register()
class ObjectRelationTransformer(BaseTransformer):
    """Region features and their boxes: ``batch["region_boxes"]`` (bs, n, 4)
    as (x_min, y_min, x_max, y_max) feed the ``GeometricEncoder``; padded
    regions have zero boxes (w = h = 1), which the padding mask hides."""

    def __init__(self, config, vocab):
        super().__init__(config, vocab)
        self.vision_embedding = build_vision_embedding(config.VISION_EMBEDDING)
        self.encoder = build_encoder(config.ENCODER)
        self.decoder = build_decoder(config.DECODER, vocab)

    def encoder_forward(self, batch: Dict[str, torch.Tensor]):
        features, padding_mask = self.vision_embedding(batch["region_features"])
        return self.encoder(features, batch["region_boxes"], padding_mask), padding_mask


@META_ARCHITECTURE.register()
class UnifiedTransformer(StandardTransformerUsingRegion):
    """``region_features``, ``region_boxes``, ``grid_features`` and
    ``grid_boxes`` concatenated along the sequence axis into one stream for
    a single-stream encoder, as the JAX package (and the reference) do.
    That concatenation only typechecks when every stream is 4 wide, so
    VISION_EMBEDDING's D_FEATURE is 4; no shipped config builds it and it
    has no full-width configuration: the port carries it for parity with
    the JAX package at that shape."""

    def encoder_forward(self, batch: Dict[str, torch.Tensor]):
        features = torch.cat([batch["region_features"], batch["region_boxes"],
                              batch["grid_features"], batch["grid_boxes"]], dim=1)
        features, padding_mask = self.vision_embedding(features)
        return self.encoder(features, padding_mask), padding_mask


@META_ARCHITECTURE.register()
class DLCTTransformer(BaseTransformer):
    """The dual-level collaborative transformer: ``region_features`` (bs,
    n_r, D_REGION_FEATURE) with their normalized ``region_boxes`` and
    ``grid_features`` (bs, n_g, D_GRID_FEATURE) with ``grid_boxes``
    (``models.geometry.get_grids_position``) through
    ``GeometricDualFeatureEmbedding`` and ``DualCollaborativeLevelEncoder``;
    the decoder cross-attends to the n_r + n_g rows of both streams."""

    def __init__(self, config, vocab):
        super().__init__(config, vocab)
        self.vision_embedding = build_vision_embedding(config.VISION_EMBEDDING)
        self.encoder = build_encoder(config.ENCODER)
        self.decoder = build_decoder(config.DECODER, vocab)

    def encoder_forward(self, batch: Dict[str, torch.Tensor]):
        (regions, region_masks), (grids, grid_masks), (region2all, grid2all) = \
            self.vision_embedding(batch["region_features"], batch["region_boxes"],
                                  batch["grid_features"], batch["grid_boxes"])
        return self.encoder(regions, batch["region_boxes"], region_masks, region2all,
                            grids, batch["grid_boxes"], grid_masks, grid2all)
