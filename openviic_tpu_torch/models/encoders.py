"""Encoder stack (counterpart of ``openviic_tpu/models/encoders.py:Encoder``):
LayerNorm + DETR sinusoid positions, then N self-attention + FFN layers
whose padded query rows are zeroed."""

from __future__ import annotations

from torch import nn

from openviic_tpu_torch.builders import META_ENCODER
from openviic_tpu_torch.models.attention import MultiHeadAttention
from openviic_tpu_torch.models.ffn import make_pwff
from openviic_tpu_torch.models.positional import sinusoid_positional_embedding


class EncoderLayer(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.mhatt = MultiHeadAttention(config)
        self.pwff = make_pwff(config)

    def forward(self, queries, keys, values, padding_mask, attention_mask):
        att = self.mhatt(queries, keys, values, attention_mask=attention_mask)
        ff = self.pwff(att)
        # padding_mask is (bs, 1, 1, len) over the queries
        return ff.masked_fill(padding_mask[:, 0, 0, :, None], 0.0)


@META_ENCODER.register()
class Encoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.d_model = config.D_MODEL
        self.layer_norm = nn.LayerNorm(config.D_MODEL, eps=1e-5)
        self.layers = nn.ModuleList(
            EncoderLayer(config.SELF_ATTENTION) for _ in range(config.LAYERS)
        )

    def forward(self, features, padding_mask):
        pos = sinusoid_positional_embedding(features, self.d_model)
        out = (self.layer_norm(features) + pos).to(features.dtype)
        for layer in self.layers:
            out = layer(out, out, out, padding_mask, padding_mask)
        return out
