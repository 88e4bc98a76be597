"""Text (token) embeddings (counterpart of
``openviic_tpu/models/text_embedding.py``):

 - ``UsualEmbedding``: a token embedding of D_MODEL; with
   ``WORD_EMBEDDING`` set, the pretrained vectors gathered by token id ->
   dropout -> ``proj`` to D_MODEL;
 - ``LSTMTextEmbedding``: a token embedding of D_EMBEDDING (with
   ``WORD_EMBEDDING`` set and vectors in the vocab, those vectors, frozen)
   -> ``proj`` to D_MODEL -> dropout -> a unidirectional LSTM (Flax's
   ``nn.RNN(OptimizedLSTMCell)``) from a zero carry over every position,
   padding included.

The pretrained vectors are ``vocab.word_embeddings`` (``Vocab.from_config``
with ``VOCAB.WORD_EMBEDDING``, or a ``vocab.bin`` that carries them).  They
are a constant in the JAX package, not a parameter, so here a
non-persistent buffer (``vectors``): a ``state_dict``, ``compat/from_jax``
and the checkpoints carry ``proj`` only, and a pipeline takes the vectors
from its ``vocab.bin``.  ``model.to(dtype)`` casts them with the model.
Without vectors in the vocab, ``UsualEmbedding`` reads the
``WORD_EMBEDDING`` file itself and gathers its rows by token id, in the
file's word order, not the vocab's (ids past its last row give NaN): the
JAX module's fallback (``openviic_tpu/models/text_embedding.py:56-60``),
mirrored; ``LSTMTextEmbedding`` then trains an embedding of its own, as
there.

Both return ``(features, (padding_mask, sequential_mask))``.  A decode
step calls the embedding on the step's one token, so there the LSTM starts
afresh from the zero carry at every step, while the teacher-forced pass
carries its state over the prefix: the JAX decoder's behaviour
(``openviic_tpu/models/decoders.py:461``, ``:645``), mirrored."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from openviic_tpu_torch.builders import META_TEXT_EMBEDDING, build_word_embedding
from openviic_tpu_torch.models.initializers import (
    LecunLinear,
    OrthogonalLinear,
    PaddedEmbedding,
    TorchLinear,
)
from openviic_tpu_torch.models.masks import (
    generate_padding_mask,
    generate_sequential_mask,
)

GATES = ("i", "f", "g", "o")  # Flax's order: input, forget, cell, output


def _vectors(vocab, config, fallback: bool):
    """The (rows, dim) f32 pretrained vectors: the vocab's, else (with
    ``fallback``) every row of the ``WORD_EMBEDDING`` file in its own
    order, padded with NaN rows to the vocab's size; None without either."""
    if config.WORD_EMBEDDING is None:
        return None
    vectors = getattr(vocab, "word_embeddings", None)
    if vectors is None:
        if not fallback:
            return None
        vectors = build_word_embedding(config).vectors
        if len(vectors) < len(vocab):  # jnp.take's fill for ids past the file's rows
            pad = np.full((len(vocab) - len(vectors), vectors.shape[1]), np.nan, np.float32)
            vectors = np.concatenate([vectors, pad])
    return torch.from_numpy(np.asarray(vectors, np.float32).copy())


def _masks(tokens, padding_idx: int):
    return (generate_padding_mask(tokens, padding_idx),
            generate_sequential_mask(tokens.shape[-1], tokens.device))


@META_TEXT_EMBEDDING.register()
class UsualEmbedding(nn.Module):
    def __init__(self, config, vocab):
        super().__init__()
        self.padding_idx = vocab.padding_idx
        vectors = _vectors(vocab, config, fallback=True)
        if vectors is None:
            self.embedding = PaddedEmbedding(len(vocab), config.D_MODEL, vocab.padding_idx)
            return
        self.register_buffer("vectors", vectors, persistent=False)
        self.dropout = nn.Dropout(config.DROPOUT)
        self.proj = TorchLinear(vectors.shape[1], config.D_MODEL)

    def forward(self, tokens):
        if hasattr(self, "embedding"):
            return self.embedding(tokens), _masks(tokens, self.padding_idx)
        features = self.proj(self.dropout(self.vectors[tokens]))
        return features, _masks(tokens, self.padding_idx)


class FlaxLSTM(nn.Module):
    """Flax's ``nn.RNN(nn.OptimizedLSTMCell(features))`` over (bs, L, d):
    ``cell`` holds its eight projections under their Flax names
    (``ii``, ``if``, ``ig``, ``io`` without bias; ``hi``, ``hf``, ``hg``,
    ``ho`` with), so ``from_jax`` carries them one to one.  Per step

        i, f, g, o = (h W_h + b_h) + x W_i   (split in GATES order)
        c = sigmoid(f) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)

    from c = h = 0 in f32, as Flax's carry: the recurrent product runs in
    f32, the input product in the input's dtype (Flax's promotion).  The
    output is h rounded to the input's dtype: the JAX cell returns f32 at
    bf16 parameters, which the JAX package's bf16 decode then cannot write
    into its bf16 cache (a ``TypeError`` in ``dynamic_update_slice``);
    the port keeps the decode in its compute dtype instead."""

    def __init__(self, features: int):
        super().__init__()
        cell = {}
        for gate in GATES:
            cell[f"i{gate}"] = LecunLinear(features, features, bias=False)
            cell[f"h{gate}"] = OrthogonalLinear(features, features)
        self.cell = nn.ModuleDict(cell)

    def forward(self, x):
        cell = self.cell
        w_i = torch.cat([cell[f"i{g}"].weight for g in GATES])
        w_h = torch.cat([cell[f"h{g}"].weight for g in GATES]).float()
        b_h = torch.cat([cell[f"h{g}"].bias for g in GATES]).float()
        x_proj = nn.functional.linear(x, w_i)  # every position's input product at once
        h = c = x.new_zeros((x.shape[0], w_h.shape[1]), dtype=torch.float32)
        out = []
        for t in range(x.shape[1]):
            y = nn.functional.linear(h, w_h, b_h) + x_proj[:, t].float()
            i, f, g, o = y.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1).to(x.dtype)


@META_TEXT_EMBEDDING.register()
class LSTMTextEmbedding(nn.Module):
    """Embedding of D_EMBEDDING (pad row zeroed at init; the vocab's frozen
    vectors with ``WORD_EMBEDDING``) -> ``proj`` to D_MODEL -> dropout ->
    ``FlaxLSTM`` (JAX ``LSTMTextEmbedding``)."""

    def __init__(self, config, vocab):
        super().__init__()
        self.padding_idx = vocab.padding_idx
        vectors = _vectors(vocab, config, fallback=False)
        if vectors is None:
            self.embedding = PaddedEmbedding(len(vocab), config.D_EMBEDDING, vocab.padding_idx)
            d_in = config.D_EMBEDDING
        else:
            self.register_buffer("vectors", vectors, persistent=False)
            d_in = vectors.shape[1]
        self.proj = TorchLinear(d_in, config.D_MODEL)
        self.dropout = nn.Dropout(config.DROPOUT)
        self.lstm = FlaxLSTM(config.D_MODEL)

    def forward(self, tokens):
        table = self.embedding(tokens) if hasattr(self, "embedding") else self.vectors[tokens]
        features = self.dropout(self.proj(table))
        return self.lstm(features), _masks(tokens, self.padding_idx)
