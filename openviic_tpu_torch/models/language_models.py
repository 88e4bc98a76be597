"""The frozen pretrained language model of RSTNet's adaptive decoder
(counterpart of ``openviic_tpu/models/language_models.py``): ``BERTModel``
and ``PhoBERTModel``, a frozen encoder backbone, then a projection to the
captioner's width, sinusoid positions, one ``EncoderLayer`` and a vocab
head, giving ``(log_probs, language_feature)``.

The backbone is what the JAX package builds without a download:

 - with ``PRETRAINED_NAME`` set, the BERT/RoBERTa encoder at the offline
   config of ``_load_hf_backbone`` (``HFEncoderBackbone``: vocab
   ``VOCAB_SIZE``, ``HIDDEN_SIZE`` wide, 4 layers of 8 heads, intermediate
   4 x hidden, 512 positions, 2 token types, LayerNorm eps 1e-12, exact
   erf GELU, no dropout), written here in plain PyTorch with the
   transformers Flax module's parameter names.  Both families build the
   same encoder offline: position ids ``cumsum(mask) * mask + 1`` (the
   RoBERTa padding offset; BERT's pad id 0 also resolves to 1 there),
   token type 0, an all-ones attention mask, so pad tokens are attended.
   The JAX package builds it when ``transformers`` is importable and no hub
   cache holds the named config, which is where its tests run; a JAX
   install without ``transformers`` builds the mini backbone in both
   cases.  ``PRETRAINED_NAME`` never reads a hub cache or downloads here.
 - without it, ``MiniBertBackbone`` (the JAX ``_MiniBertBackbone``): token
   and position embeddings, Flax's ``MultiHeadDotProductAttention`` (3-D
   kernels in the JAX tree, ``nn.Linear`` weights here) and tanh-GELU
   feed-forwards, post-LN with eps 1e-12.

Its parameters require no grad and its output is detached (the JAX
package's ``stop_gradient``); ``frozen_param_mask`` keeps them out of the
optimizer.  The projection, position table, encoder layer and vocab head
train.  The whole module runs without dropout in every mode, as the JAX
package calls it without ``train``.

``signals`` gives the language feature alone: the adaptive decoder and the
signal table use it, so that no signal path builds the (rows, VOCAB_SIZE)
log-probs that JAX's jit drops as dead code (at 64 001 ids and 10 000
rows, 2.56 GB of f32).  The module computes in its parameters' dtype; the
JAX package's transformers encoder computes in f32 whatever its
parameters' dtype (its modules' ``dtype``), which the port does not
mirror at bf16."""

from __future__ import annotations

import math

import torch
from torch import nn

from openviic_tpu_torch.builders import META_PRETRAINED_LANGUAGE_MODEL
from openviic_tpu_torch.models.encoders import EncoderLayer
from openviic_tpu_torch.models.initializers import (
    LecunLinear,
    NormalEmbedding,
    NormalLinear,
    TorchLinear,
)
from openviic_tpu_torch.models.masks import generate_padding_mask, generate_sequential_mask
from openviic_tpu_torch.models.positional import sinusoid_encoding_table

# the offline config of the JAX package's ``_load_hf_backbone`` and the
# transformers defaults it keeps
HF_LAYERS, HF_HEADS = 4, 8
HF_POSITIONS, HF_TOKEN_TYPES = 512, 2
HF_LN_EPS = 1e-12
HF_PADDING_IDX = 1


def _heads_attention(q, k, v, mask=None):
    """Softmax attention of (b, n, h, d) q, k, v, the query scaled by
    1 / sqrt(d) first (Flax's ``dot_product_attention_weights``); ``mask``
    (b, 1, 1, n) True = attend, elsewhere the score is the dtype's lowest
    value.  Scores and the softmax in float32.  -> (b, n, h * d)."""
    b, n, h, d = q.shape
    q = q.float() / math.sqrt(d)
    att = torch.einsum("bqhd,bkhd->bhqk", q, k.float())
    if mask is not None:
        att = att.masked_fill(~mask, torch.finfo(torch.float32).min)
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v.float())
    return out.reshape(b, n, h * d).to(v.dtype)


class _HFSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = NormalLinear(hidden, hidden)
        self.key = NormalLinear(hidden, hidden)
        self.value = NormalLinear(hidden, hidden)

    def forward(self, x, mask):
        b, n, d = x.shape
        split = lambda t: t.reshape(b, n, self.heads, d // self.heads)  # noqa: E731
        return _heads_attention(split(self.query(x)), split(self.key(x)), split(self.value(x)),
                                mask)


class _HFResidualOutput(nn.Module):
    """``LayerNorm(dense(h) + residual)``."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.dense = NormalLinear(d_in, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=HF_LN_EPS)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class _HFAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        setattr(self, "self", _HFSelfAttention(hidden, heads))  # the transformers name
        self.output = _HFResidualOutput(hidden, hidden)

    def forward(self, x, mask):
        return self.output(getattr(self, "self")(x, mask), x)


class _HFIntermediate(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dense = NormalLinear(hidden, 4 * hidden)

    def forward(self, x):
        return nn.functional.gelu(self.dense(x))  # the exact (erf) form


class _HFLayer(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.attention = _HFAttention(hidden, heads)
        self.intermediate = _HFIntermediate(hidden)
        self.output = _HFResidualOutput(4 * hidden, hidden)

    def forward(self, x, mask):
        a = self.attention(x, mask)
        return self.output(self.intermediate(a), a)


class _HFEncoder(nn.Module):
    def __init__(self, hidden: int, heads: int, layers: int):
        super().__init__()
        self.layer = nn.ModuleList(_HFLayer(hidden, heads) for _ in range(layers))


class _HFEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int):
        super().__init__()
        self.word_embeddings = NormalEmbedding(vocab_size, hidden, std=0.02)
        self.position_embeddings = NormalEmbedding(HF_POSITIONS, hidden, std=0.02)
        self.token_type_embeddings = NormalEmbedding(HF_TOKEN_TYPES, hidden, std=0.02)
        self.LayerNorm = nn.LayerNorm(hidden, eps=HF_LN_EPS)

    def forward(self, input_ids, position_ids):
        token_type = self.token_type_embeddings(torch.zeros_like(input_ids))
        x = self.word_embeddings(input_ids) + token_type + self.position_embeddings(position_ids)
        return self.LayerNorm(x)


class _HFPooler(nn.Module):
    """Kept for a one-to-one parameter tree; the language model never
    calls it."""

    def __init__(self, hidden: int):
        super().__init__()
        self.dense = NormalLinear(hidden, hidden)


class _HFModel(nn.Module):
    def __init__(self, vocab_size: int, hidden: int):
        super().__init__()
        self.embeddings = _HFEmbeddings(vocab_size, hidden)
        self.encoder = _HFEncoder(hidden, HF_HEADS, HF_LAYERS)
        self.pooler = _HFPooler(hidden)


class HFEncoderBackbone(nn.Module):
    """The JAX ``_HFBackboneAdapter`` over the transformers Flax BERT/RoBERTa
    module at its offline config; the encoder's parameters sit under
    ``hf``, as there."""

    def __init__(self, vocab_size: int, hidden: int):
        super().__init__()
        self.hf = _HFModel(vocab_size, hidden)

    def forward(self, input_ids, attention_mask=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        mask = attention_mask.long()
        position_ids = torch.cumsum(mask, dim=1) * mask + HF_PADDING_IDX
        x = self.hf.embeddings(input_ids, position_ids)
        keep = (mask > 0)[:, None, None, :]
        for layer in self.hf.encoder.layer:
            x = layer(x, keep)
        return x


class _FlaxMultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` (qkv features = the input
    width): query/key/value kernels (in, h, d) and out (h, d, out) in the
    JAX tree, ``nn.Linear`` weights here (``compat.from_jax`` reshapes)."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = LecunLinear(hidden, hidden)
        self.key = LecunLinear(hidden, hidden)
        self.value = LecunLinear(hidden, hidden)
        self.out = LecunLinear(hidden, hidden)

    def forward(self, x, mask):
        b, n, d = x.shape
        split = lambda t: t.reshape(b, n, self.heads, d // self.heads)  # noqa: E731
        return self.out(_heads_attention(split(self.query(x)), split(self.key(x)),
                                         split(self.value(x)), mask))


class MiniBertBackbone(nn.Module):
    """The JAX ``_MiniBertBackbone``: the stand-in encoder built when no
    ``PRETRAINED_NAME`` is given."""

    def __init__(self, vocab_size: int, hidden: int, num_layers: int, num_heads: int,
                 max_positions: int = 512):
        super().__init__()
        self.num_layers = num_layers
        self.tok_emb = NormalEmbedding(vocab_size, hidden, std=1.0)
        self.pos_emb = NormalEmbedding(max_positions, hidden, std=1.0)
        self.emb_ln = nn.LayerNorm(hidden, eps=1e-12)
        for i in range(num_layers):  # the JAX names
            setattr(self, f"attn_{i}", _FlaxMultiHeadAttention(hidden, num_heads))
            setattr(self, f"ln1_{i}", nn.LayerNorm(hidden, eps=1e-12))
            setattr(self, f"ff1_{i}", LecunLinear(hidden, 4 * hidden))
            setattr(self, f"ff2_{i}", LecunLinear(4 * hidden, hidden))
            setattr(self, f"ln2_{i}", nn.LayerNorm(hidden, eps=1e-12))

    def forward(self, input_ids, attention_mask=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.emb_ln(self.tok_emb(input_ids) + self.pos_emb(pos)[None])
        mask = None if attention_mask is None else (attention_mask > 0)[:, None, None, :]
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            x = layer("ln1")(x + layer("attn")(x, mask))
            h = layer("ff2")(nn.functional.gelu(layer("ff1")(x), approximate="tanh"))
            x = layer("ln2")(x + h)
        return x


class _LanguageModelBase(nn.Module):
    """Backbone, projection to ``D_MODEL``, the sinusoid table of ``MAX_LEN
    + 1`` rows, one ``EncoderLayer`` over ``ATTENTION`` and the vocab
    head."""

    def __init__(self, config):
        super().__init__()
        self.padding_idx = config.get("PADDING_IDX", 0)
        d_model, vocab_size = config.D_MODEL, config.VOCAB_SIZE
        hidden = config.get("HIDDEN_SIZE", 768)
        if config.get("PRETRAINED_NAME"):
            self.backbone = HFEncoderBackbone(vocab_size, hidden)
        else:
            self.backbone = MiniBertBackbone(vocab_size, hidden,
                                             config.get("BACKBONE_LAYERS", 2),
                                             config.get("BACKBONE_HEADS", 8))
        self.backbone.requires_grad_(False)
        self.proj_to_caption_model = TorchLinear(hidden, d_model)
        table = sinusoid_encoding_table(config.get("MAX_LEN", 54) + 1, d_model, padding_idx=0)
        self.register_buffer("pos_table", torch.from_numpy(table), persistent=False)
        self.encoder_layer = EncoderLayer(config.ATTENTION)
        self.proj_to_vocab = TorchLinear(d_model, vocab_size)
        self.train(False)

    def train(self, mode: bool = True):
        """Every mode runs without dropout (the JAX package never passes
        ``train`` to this module)."""
        return super().train(False)

    def signals(self, input_ids, attention_mask=None):
        """The (b, n, D_MODEL) language feature of ``input_ids`` (b, n)."""
        b, n = input_ids.shape
        mask_queries = generate_padding_mask(input_ids, self.padding_idx)
        mask_self = generate_sequential_mask(n, input_ids.device) | mask_queries
        seq = torch.arange(1, n + 1, device=input_ids.device)
        seq = seq[None, :].expand(b, n).masked_fill(mask_queries[:, 0, 0, :], 0)
        with torch.no_grad():  # frozen: no gradient, no kept activations
            hidden = self.backbone(input_ids, attention_mask)
        feature = self.proj_to_caption_model(hidden)
        feature = feature + self.pos_table[seq].to(feature.dtype)
        return self.encoder_layer(feature, feature, feature, mask_queries, mask_self)

    def forward(self, input_ids, attention_mask=None):
        """(log_probs (b, n, VOCAB_SIZE) f32, language feature)."""
        feature = self.signals(input_ids, attention_mask)
        return torch.log_softmax(self.proj_to_vocab(feature).float(), dim=-1), feature


@META_PRETRAINED_LANGUAGE_MODEL.register()
class BERTModel(_LanguageModelBase):
    """BERT family (the JAX package's ``FlaxBertModel`` backbone)."""


@META_PRETRAINED_LANGUAGE_MODEL.register()
class PhoBERTModel(_LanguageModelBase):
    """RoBERTa family (``FlaxRobertaModel``), PhoBERT's."""
