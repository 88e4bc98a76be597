"""Registered captioning architectures (counterpart of
``openviic_tpu/models/architectures.py``): ``StandardTransformerUsingRegion``,
``StandardTransformerUsingGrid`` and ``ObjectRelationTransformer``."""

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
