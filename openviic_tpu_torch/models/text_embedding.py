"""Text (token) embeddings (counterpart of
``openviic_tpu/models/text_embedding.py``), without pretrained vectors:

 - ``UsualEmbedding``: a token embedding of D_MODEL;
 - ``LSTMTextEmbedding``: a token embedding of D_EMBEDDING -> ``proj`` to
   D_MODEL -> dropout -> a unidirectional LSTM (Flax's
   ``nn.RNN(OptimizedLSTMCell)``) from a zero carry over every position,
   padding included.

Both return ``(features, (padding_mask, sequential_mask))``.  A decode
step calls the embedding on the step's one token, so there the LSTM starts
afresh from the zero carry at every step, while the teacher-forced pass
carries its state over the prefix: the JAX decoder's behaviour
(``openviic_tpu/models/decoders.py:461``, ``:645``), mirrored."""

from __future__ import annotations

import torch
from torch import nn

from openviic_tpu_torch.builders import META_TEXT_EMBEDDING
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


def _refuse_pretrained(config) -> None:
    if config.WORD_EMBEDDING is not None:
        raise NotImplementedError("pretrained word embeddings are not ported yet")


def _masks(tokens, padding_idx: int):
    return (generate_padding_mask(tokens, padding_idx),
            generate_sequential_mask(tokens.shape[-1], tokens.device))


@META_TEXT_EMBEDDING.register()
class UsualEmbedding(nn.Module):
    def __init__(self, config, vocab):
        super().__init__()
        _refuse_pretrained(config)
        self.padding_idx = vocab.padding_idx
        self.embedding = PaddedEmbedding(len(vocab), config.D_MODEL, vocab.padding_idx)

    def forward(self, tokens):
        return self.embedding(tokens), _masks(tokens, self.padding_idx)


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
    """Embedding of D_EMBEDDING (pad row zeroed at init) -> ``proj`` to
    D_MODEL -> dropout -> ``FlaxLSTM`` (JAX ``LSTMTextEmbedding``)."""

    def __init__(self, config, vocab):
        super().__init__()
        _refuse_pretrained(config)
        self.padding_idx = vocab.padding_idx
        self.embedding = PaddedEmbedding(len(vocab), config.D_EMBEDDING, vocab.padding_idx)
        self.proj = TorchLinear(config.D_EMBEDDING, config.D_MODEL)
        self.dropout = nn.Dropout(config.DROPOUT)
        self.lstm = FlaxLSTM(config.D_MODEL)

    def forward(self, tokens):
        features = self.dropout(self.proj(self.embedding(tokens)))
        return self.lstm(features), _masks(tokens, self.padding_idx)
