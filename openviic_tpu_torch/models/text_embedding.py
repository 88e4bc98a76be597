"""Text (token) embeddings: ``UsualEmbedding`` without pretrained vectors,
the counterpart of ``openviic_tpu/models/text_embedding.py:UsualEmbedding``.
Returns ``(features, (padding_mask, sequential_mask))``."""

from __future__ import annotations

from torch import nn

from openviic_tpu_torch.builders import META_TEXT_EMBEDDING
from openviic_tpu_torch.models.initializers import PaddedEmbedding
from openviic_tpu_torch.models.masks import (
    generate_padding_mask,
    generate_sequential_mask,
)


@META_TEXT_EMBEDDING.register()
class UsualEmbedding(nn.Module):
    def __init__(self, config, vocab):
        super().__init__()
        if config.WORD_EMBEDDING is not None:
            raise NotImplementedError(
                "pretrained word embeddings are not ported yet"
            )
        self.padding_idx = vocab.padding_idx
        self.embedding = PaddedEmbedding(len(vocab), config.D_MODEL, vocab.padding_idx)

    def forward(self, tokens):
        padding_masks = generate_padding_mask(tokens, self.padding_idx)
        sequential_masks = generate_sequential_mask(tokens.shape[-1], tokens.device)
        return self.embedding(tokens), (padding_masks, sequential_masks)
