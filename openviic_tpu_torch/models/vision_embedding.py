"""Vision (visual-feature) embeddings: ``FeatureEmbedding``, the counterpart
of ``openviic_tpu/models/vision_embedding.py:FeatureEmbedding`` — a linear
projection D_FEATURE -> D_MODEL plus dropout; the padding mask comes from
all-zero feature rows."""

from __future__ import annotations

from torch import nn

from openviic_tpu_torch.builders import META_VISION_EMBEDDING
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
