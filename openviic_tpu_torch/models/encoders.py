"""Encoder stacks (counterparts of ``openviic_tpu/models/encoders.py``):
``Encoder`` (LayerNorm + DETR sinusoid positions, then N self-attention +
FFN layers whose padded query rows are zeroed), ``MultilevelEncoder`` (the
same, returning every layer's output for the Meshed-Memory decoder),
``GeometricEncoder`` (the Object Relation Transformer's per-head geometric
attention bias from the region boxes), CAMO's
``CrossAttentionMultiLevelEncoder`` and DLCT's
``DualCollaborativeLevelEncoder``."""

from __future__ import annotations

import torch
from torch import nn

from openviic_tpu_torch.builders import META_ENCODER
from openviic_tpu_torch.models.attention import MultiHeadAttention
from openviic_tpu_torch.models.ffn import make_pwff
from openviic_tpu_torch.models.geometry import box_relational_embedding
from openviic_tpu_torch.models.initializers import PerHeadXavierLinear, TorchLinear
from openviic_tpu_torch.models.positional import sinusoid_positional_embedding
from openviic_tpu_torch.ops.geo_attention import geo_fused_enabled


def geometry_heads(fc_gs: nn.Linear, head_parallel=None):
    """``fc_gs``'s (weight (h, d_g), bias (h,)): under ``head_parallel``
    (mesh, axis) the rank's heads' rows of each (their gradients
    all-gathered back, as they are replicated parameters), else whole."""
    weight, bias = fc_gs.weight, fc_gs.bias
    if head_parallel is not None:
        from openviic_tpu_torch.parallel import collectives

        weight, bias = (collectives.split(t, *head_parallel, 0) for t in (weight, bias))
    return weight, bias


def relu_geometry(fc_gs: nn.Linear, boxes: torch.Tensor, d_g: int, trig: bool,
                  head_parallel=None) -> torch.Tensor:
    """Per-head geometry weights relu(fc_gs(box_relational_embedding(boxes)))
    of (bs, n, 4) boxes, as (bs, h, n, n); under ``head_parallel`` the
    rank's heads only (``geometry_heads``)."""
    emb = box_relational_embedding(boxes, dim_g=d_g, trignometric_embedding=trig)
    weight, bias = geometry_heads(fc_gs, head_parallel)
    dtype = torch.promote_types(emb.dtype, weight.dtype)
    out = nn.functional.linear(emb.to(dtype), weight.to(dtype), bias.to(dtype))
    return torch.relu(out.permute(0, 3, 1, 2))


class EncoderLayer(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.mhatt = MultiHeadAttention(config)
        self.pwff = make_pwff(config)

    def forward(self, queries, keys, values, padding_mask, attention_mask, **kwargs):
        att = self.mhatt(queries, keys, values, attention_mask=attention_mask, **kwargs)
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

    def layer_outputs(self, features, padding_mask, **layer_kwargs):
        """Every layer's output, in order; ``layer_kwargs`` go to every
        layer's attention."""
        pos = sinusoid_positional_embedding(features, self.d_model)
        out = (self.layer_norm(features) + pos).to(features.dtype)
        outs = []
        for layer in self.layers:
            out = layer(out, out, out, padding_mask, padding_mask, **layer_kwargs)
            outs.append(out)
        return outs

    def forward(self, features, padding_mask, **layer_kwargs):
        return self.layer_outputs(features, padding_mask, **layer_kwargs)[-1]


@META_ENCODER.register()
class MultilevelEncoder(Encoder):
    """The Meshed-Memory encoder: every layer's output, stacked to (bs, N,
    n, d) for ``MeshedDecoder``."""

    def forward(self, features, padding_mask):
        return torch.stack(self.layer_outputs(features, padding_mask), dim=1)


@META_ENCODER.register()
class CrossAttentionMultiLevelEncoder(Encoder):
    """CAMO: three layers, then one shared ``self_attn`` lets layer 2 attend
    to layer 1 and layer 3 to the updated layer 2 (each added at weight
    0.1), and an MLP of the three original outputs (``mlp1`` over their
    concatenation, ``mlp2``, each followed by a leaky ReLU of slope 0.01)
    is added to layer 3's at weight 0.2.  The three-layer unpack is the
    JAX package's (and the reference's): other depths raise."""

    def __init__(self, config):
        super().__init__(config)
        self.self_attn = MultiHeadAttention(config.SELF_ATTENTION)
        self.mlp1 = TorchLinear(3 * config.D_MODEL, config.D_MODEL)
        self.mlp2 = TorchLinear(config.D_MODEL, config.D_MODEL)

    def forward(self, features, padding_mask):
        outs = self.layer_outputs(features, padding_mask)
        out1, out2, out3 = outs
        out2 = 0.1 * self.self_attn(out2, out1, out1, attention_mask=padding_mask) + out2
        out3 = 0.1 * self.self_attn(out3, out2, out2, attention_mask=padding_mask) + out3
        out = nn.functional.leaky_relu(self.mlp1(torch.cat(outs, dim=-1)))
        out = nn.functional.leaky_relu(self.mlp2(out))
        return out3 + 0.2 * out


@META_ENCODER.register()
class GeometricEncoder(Encoder):
    """The Object Relation Transformer's encoder: per-head geometry weights
    relu(fc_gs(box_relational_embedding(boxes))) enter every layer's
    attention as a log bias.  ``fc_gs`` is one Linear(d_g, h) (d_g =
    d_model / heads with the trig embedding, else 4), its columns
    initialised as h separate Linear(d_g, 1) layers.  With
    ``OPENVIIC_GEO_FUSED``, the trig embedding and d_g % 8 == 0 the bias is
    built inside ``ops.geo_fused_attention`` from the boxes instead.  Under
    a ``model`` axis that divides the heads (``head_parallel``, set by
    ``parallel.tensor_parallel.shard_model``) d_g stays that of the whole
    head count and both paths take the rank's heads of ``fc_gs``."""

    head_parallel = None

    def __init__(self, config):
        super().__init__(config)
        self.trignometric_embedding = config.TRIGNOMETRIC_EMBEDDING
        self.n_heads = config.SELF_ATTENTION.HEAD
        self.d_g = config.D_MODEL // self.n_heads if self.trignometric_embedding else 4
        self.fc_gs = PerHeadXavierLinear(self.d_g, self.n_heads)

    def geometry_weights(self, boxes: torch.Tensor) -> torch.Tensor:
        """(bs, n, 4) boxes -> (bs, h, n, n) non-negative weights (the
        rank's heads under ``head_parallel``)."""
        return relu_geometry(self.fc_gs, boxes, self.d_g, self.trignometric_embedding,
                             self.head_parallel)

    def forward(self, features, boxes, padding_mask):
        if geo_fused_enabled() and self.trignometric_embedding and self.d_g % 8 == 0:
            weight, bias = geometry_heads(self.fc_gs, self.head_parallel)
            return super().forward(features, padding_mask, geometry_fused={
                "boxes": boxes, "kernel": weight.t(), "bias": bias,
            })
        return super().forward(features, padding_mask,
                               relative_geometry_weights=self.geometry_weights(boxes))


@META_ENCODER.register()
class DualCollaborativeLevelEncoder(nn.Module):
    """DLCT: a region stack and a grid stack side by side, each layer of
    each followed by a locally constrained cross-attention over [regions |
    grids].  One ``fc_gs`` maps the box-relation embedding of all n_r + n_g
    boxes to per-head geometry weights relu(.) (bs, h, n, n), sliced per
    attention: regions to regions, grids to grids, regions to all, grids
    to all.  Both streams start as their LayerNorm plus the normalized
    sinusoid positions; in every layer the concatenated stream gets the
    positions of its own length added before the cross-attentions, whose
    masks are the visibility masks ``region2all`` and ``grid2all`` while
    their padded query rows are zeroed by the plain padding masks.  Returns
    the concatenated stream (bs, n_r + n_g, d) and its padding mask (bs, 1,
    1, n_r + n_g).  The layers are ``region``, ``grid``, ``region2grid``
    and ``grid2region`` (the JAX ``region_<i>`` ...).  Under a ``model``
    axis that divides the heads (``head_parallel``) the geometry weights
    are the rank's heads', as ``GeometricEncoder``'s."""

    head_parallel = None

    def __init__(self, config):
        super().__init__()
        self.d_model = config.D_MODEL
        self.trignometric_embedding = config.TRIGNOMETRIC_EMBEDDING
        self.n_heads = config.HEAD
        self.d_g = config.D_MODEL // self.n_heads if self.trignometric_embedding else 4
        self.fc_gs = PerHeadXavierLinear(self.d_g, self.n_heads)
        self.layer_norm_region = nn.LayerNorm(config.D_MODEL, eps=1e-5)
        self.layer_norm_grid = nn.LayerNorm(config.D_MODEL, eps=1e-5)

        def stack(attention):
            return nn.ModuleList(EncoderLayer(attention) for _ in range(config.LAYERS))
        self.region = stack(config.SELF_ATTENTION)
        self.grid = stack(config.SELF_ATTENTION)
        self.region2grid = stack(config.CROSS_ATTENTION)
        self.grid2region = stack(config.CROSS_ATTENTION)

    def _pos(self, x):
        return sinusoid_positional_embedding(x, self.d_model, normalize=True)

    def forward(self, region_features, region_boxes, region_padding_mask, region2all_mask,
                grid_features, grid_boxes, grid_padding_mask, grid2all_mask):
        n_r = region_features.shape[1]
        g = relu_geometry(self.fc_gs, torch.cat([region_boxes, grid_boxes], dim=1), self.d_g,
                          self.trignometric_embedding, self.head_parallel)  # (bs, h, n, n)
        regions = (self.layer_norm_region(region_features)
                   + self._pos(region_features)).to(region_features.dtype)
        grids = (self.layer_norm_grid(grid_features)
                 + self._pos(grid_features)).to(grid_features.dtype)
        for l_region, l_grid, l_r2g, l_g2r in zip(self.region, self.grid, self.region2grid,
                                                  self.grid2region):
            regions = l_region(regions, regions, regions, region_padding_mask,
                               region_padding_mask,
                               relative_geometry_weights=g[:, :, :n_r, :n_r])
            grids = l_grid(grids, grids, grids, grid_padding_mask, grid_padding_mask,
                           relative_geometry_weights=g[:, :, n_r:, n_r:])
            combined = torch.cat([regions, grids], dim=1)
            # float32 from here, as the JAX sum of a bf16 stream and the f32
            # positions promotes
            combined = combined + self._pos(combined)
            regions = l_r2g(regions, combined, combined, region_padding_mask, region2all_mask,
                            relative_geometry_weights=g[:, :, :n_r, :])
            grids = l_g2r(grids, combined, combined, grid_padding_mask, grid2all_mask,
                          relative_geometry_weights=g[:, :, n_r:, :])
        return (torch.cat([regions, grids], dim=1),
                torch.cat([region_padding_mask, grid_padding_mask], dim=-1))
