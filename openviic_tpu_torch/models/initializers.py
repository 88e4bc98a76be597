"""Weight initialisation with the JAX package's schemes
(``openviic_tpu/models/initializers.py``), drawn from an explicit
``torch.Generator``.

Two linear flavours exist: attention projections use xavier-uniform kernels
and zero biases; every other linear uses torch's ``nn.Linear`` default
(U(+-1/sqrt(fan_in)) for kernel and bias).  The classes below differ from
``nn.Linear`` only in ``reset_with``; ``initialize`` walks a model and calls
it.  Embeddings are N(0, 1) with the pad row zeroed; LayerNorms are ones and
zeros."""

from __future__ import annotations

import math

import torch
from torch import nn


class XavierLinear(nn.Linear):
    def reset_with(self, generator: torch.Generator) -> None:
        fan_out, fan_in = self.weight.shape
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class TorchLinear(nn.Linear):
    def reset_with(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)


class PaddedEmbedding(nn.Embedding):
    """``nn.Embedding`` initialised N(0, 1) with row ``pad_row`` zeroed (the
    row is an ordinary trainable row, as in the JAX package)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, pad_row: int):
        super().__init__(num_embeddings, embedding_dim)
        self.pad_row = pad_row

    def reset_with(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 1.0, generator=generator)
        self.weight[self.pad_row].zero_()


@torch.no_grad()
def initialize(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter of ``model`` in module order."""
    for module in model.modules():
        if hasattr(module, "reset_with"):
            module.reset_with(generator)
        elif isinstance(module, nn.LayerNorm):
            module.reset_parameters()
