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
d_model is the JAX package's ``torch_linear_bias`` of those widths.

The frozen language model's backbones keep the schemes of the modules the
JAX package builds them from: the transformers Flax encoders' normal(0,
0.02) kernels and embeddings with zero biases (``NormalLinear``,
``NormalEmbedding``), and for the stand-in mini backbone Flax's default
Dense kernel, lecun-normal (a normal truncated at two standard deviations,
rescaled to variance 1 / fan_in; ``LecunLinear``) with zero biases, and
``torch_embedding_init``'s N(0, 1) embeddings.  ``LSTMTextEmbedding``'s
cell keeps Flax's ``OptimizedLSTMCell`` schemes: lecun-normal input
kernels, orthogonal recurrent kernels (``OrthogonalLinear``), zero
biases.

The JAX module's functions (``torch_linear_kernel``, ``torch_linear_bias``,
``normal_stddev``, ``torch_embedding_init``) return Flax initialisers that
``model.init`` calls with a PRNG key; here the same draws are the layers'
``reset_with`` and ``normal_init``, which ``initialize`` runs (``build_model``
calls it)."""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn

_deferred = threading.local()


@contextlib.contextmanager
def without_default_init():
    """The layers below built in the block (on this thread) skip their
    constructors' random draw, leaving their parameters uninitialised for a
    caller that loads every one of them next (at RSTNet's width the draw
    alone takes seconds on the host)."""
    _deferred.on = True
    try:
        yield
    finally:
        _deferred.on = False


class _DeferredInit:
    """``reset_parameters`` (the constructor's draw) unless
    ``without_default_init`` is on."""

    def reset_parameters(self) -> None:
        if not getattr(_deferred, "on", False):
            super().reset_parameters()


class XavierLinear(_DeferredInit, nn.Linear):
    def reset_with(self, generator: torch.Generator) -> None:
        fan_out, fan_in = self.weight.shape
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class PerHeadXavierLinear(_DeferredInit, nn.Linear):
    """Linear(d_g, h) whose h output columns are initialised as h separate
    Linear(d_g, 1) layers would be by xavier-uniform (the JAX
    ``_per_head_xavier``: bound sqrt(6 / (d_g + 1))); zero bias."""

    def reset_with(self, generator: torch.Generator) -> None:
        bound = math.sqrt(6.0 / (self.in_features + 1))
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class TorchLinear(_DeferredInit, nn.Linear):
    def reset_with(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)


class NormalLinear(_DeferredInit, nn.Linear):
    """N(0, 0.02**2) weights, zero bias (transformers' Flax encoders at
    ``initializer_range`` 0.02)."""

    def reset_with(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 0.02, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class LecunLinear(_DeferredInit, nn.Linear):
    """Flax's default ``Dense``/``DenseGeneral`` init: lecun-normal weights
    (truncated at +-2 standard deviations, std sqrt(1 / fan_in) / 0.8796...
    so that the variance is 1 / fan_in), zero bias."""

    def reset_with(self, generator: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.in_features) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class OrthogonalLinear(_DeferredInit, nn.Linear):
    """An orthogonal weight, zero bias (Flax's ``initializers.orthogonal()``
    and ``zeros_init()``, the recurrent kernels of ``OptimizedLSTMCell``)."""

    def reset_with(self, generator: torch.Generator) -> None:
        nn.init.orthogonal_(self.weight, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class NormalEmbedding(_DeferredInit, nn.Embedding):
    """``nn.Embedding`` drawn N(0, std**2), no row zeroed."""

    def __init__(self, num_embeddings: int, embedding_dim: int, std: float):
        super().__init__(num_embeddings, embedding_dim)
        self.std = std

    def reset_with(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.std, generator=generator)


def normal_init(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, std**2) in place (the JAX ``normal_stddev(std)``)."""
    param.normal_(0.0, std, generator=generator)


class PaddedEmbedding(_DeferredInit, nn.Embedding):
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
