"""Weight initialisation with the JAX package's schemes
(``openviic_tpu/models/initializers.py``), drawn from an explicit
``torch.Generator``.

Two linear flavours exist: attention projections use xavier-uniform kernels
and zero biases; every other linear uses torch's ``nn.Linear`` default
(U(+-1/sqrt(fan_in)) for kernel and bias).  The classes below differ from
``nn.Linear`` only in ``reset_with``; ``initialize`` walks a model and calls
it.  Embeddings are N(0, 1) with the pad row zeroed; LayerNorms are ones and
zeros.  A module with raw parameters of its own draws them in its
``reset_with`` (the augmented memory's slots: ``normal_init``, the JAX
``normal_stddev``).  The AoA gate's and CAMO's fusion linears are
``TorchLinear``: their bias bound 1/sqrt(fan_in) with fan-in 2 and 3
d_model is the JAX package's ``torch_linear_bias`` of those widths."""

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


class PerHeadXavierLinear(nn.Linear):
    """Linear(d_g, h) whose h output columns are initialised as h separate
    Linear(d_g, 1) layers would be by xavier-uniform (the JAX
    ``_per_head_xavier``: bound sqrt(6 / (d_g + 1))); zero bias."""

    def reset_with(self, generator: torch.Generator) -> None:
        bound = math.sqrt(6.0 / (self.in_features + 1))
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class TorchLinear(nn.Linear):
    def reset_with(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)


def normal_init(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, std**2) in place (the JAX ``normal_stddev(std)``)."""
    param.normal_(0.0, std, generator=generator)


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
