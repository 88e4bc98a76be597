"""Position-wise feed-forward layer (counterpart of
``openviic_tpu/models/ffn.py:PositionWiseFeedForward``): fc1 -> ReLU ->
dropout -> fc2 -> dropout -> post-LN residual (sum and LayerNorm in f32,
rounded once, ``attention.residual_layer_norm``).  The MoE variant is not
ported."""

from __future__ import annotations

import torch
from torch import nn

from openviic_tpu_torch.models.attention import residual_layer_norm
from openviic_tpu_torch.models.initializers import TorchLinear


class PositionWiseFeedForward(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.fc1 = TorchLinear(config.D_MODEL, config.D_FF)
        self.fc2 = TorchLinear(config.D_FF, config.D_MODEL)
        self.dropout = nn.Dropout(config.DROPOUT)
        self.dropout_2 = nn.Dropout(config.DROPOUT)
        self.layer_norm = nn.LayerNorm(config.D_MODEL, eps=1e-5)

    def forward(self, x):
        out = self.fc2(self.dropout_2(torch.relu(self.fc1(x))))
        return residual_layer_norm(self.layer_norm, x, self.dropout(out))


def make_pwff(config) -> PositionWiseFeedForward:
    if config.get("MOE_EXPERTS"):
        raise NotImplementedError("the MoE feed-forward is not ported yet")
    return PositionWiseFeedForward(config)
