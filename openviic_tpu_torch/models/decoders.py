"""Caption decoder (counterpart of ``openviic_tpu/models/decoders.py``:
``DecoderLayer``, ``_DecoderBase``, ``Decoder``).

Teacher-forced and step decoding share the weights.  Step decoding threads
an explicit DecodeCache dict: per layer ``{"self": {"k", "v"}, "cross":
{"k", "v"}}`` plus a running token-was-pad mask ``"pad"`` (rows, L).  The
port updates the self-attention K/V and the pad mask in place.  Semantics
follow the JAX package:

 - self-attention at step t masks cached positions j > t and positions
   whose token was <pad>;
 - the positional index at step t is t+1 whatever the pad status;
 - each layer's output is zeroed where the *input* token is <pad>.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from openviic_tpu_torch.builders import META_DECODER, build_text_embedding
from openviic_tpu_torch.models.attention import MultiHeadAttention
from openviic_tpu_torch.models.ffn import make_pwff
from openviic_tpu_torch.models.initializers import TorchLinear
from openviic_tpu_torch.models.masks import (
    generate_padding_mask,
    generate_sequential_mask,
)
from openviic_tpu_torch.models.positional import sinusoid_encoding_table

DecodeCache = Dict[str, Any]


class DecoderLayer(nn.Module):
    """Masked self-attention + cross-attention + FFN."""

    def __init__(self, config):
        super().__init__()
        self.self_attn = MultiHeadAttention(config.SELF_ATTENTION)
        self.enc_attn = MultiHeadAttention(config.ENC_ATTENTION)
        self.pwff = make_pwff(config.ENC_ATTENTION)

    def forward(self, queries, keys, values, self_padding_mask,
                self_attention_mask, enc_attention_mask):
        self_att = self.self_attn(queries, queries, queries, self_attention_mask)
        enc_att = self.enc_attn(self_att, keys, values, enc_attention_mask)
        ff = self.pwff(enc_att)
        return ff.masked_fill(self_padding_mask[:, 0, 0, :, None], 0.0)

    def prepare_cache(self, memory) -> DecodeCache:
        return {"cross": self.enc_attn.precompute_cache(memory)}

    def step(self, queries, layer_cache, decode_index, self_attention_mask,
             enc_attention_mask, ancestry=None, beam_select=None,
             mask_axis: str = "q"):
        self_att = self.self_attn.decode_self(
            queries, layer_cache["self"], decode_index, self_attention_mask,
            ancestry=ancestry, beam_select=beam_select, mask_axis=mask_axis,
        )
        enc_att = self.enc_attn.decode_cross(
            self_att, layer_cache["cross"], enc_attention_mask,
            beam_select=beam_select,
        )
        return self.pwff(enc_att)


class _DecoderBase(nn.Module):
    """Shared teacher-forced/step plumbing."""

    layer_cls = DecoderLayer

    def __init__(self, config, vocab):
        super().__init__()
        self.config = config
        self.vocab = vocab
        self.padding_idx = vocab.padding_idx
        self.word_emb = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        table = sinusoid_encoding_table(
            vocab.max_caption_length + 1, config.D_MODEL, padding_idx=0
        )
        # a constant of the architecture, not a parameter
        self.register_buffer("pos_table", torch.from_numpy(table), persistent=False)
        self.layers = nn.ModuleList(
            type(self).layer_cls(config.ATTENTION) for _ in range(config.LAYERS)
        )
        self.fc = TorchLinear(config.D_MODEL, len(vocab), bias=False)

    # -- teacher-forced ------------------------------------------------
    def forward(self, caption_tokens, encoder_features, encoder_attention_mask,
                raw_logits: bool = False):
        b_s, seq_len = caption_tokens.shape[:2]
        pad_mask = generate_padding_mask(caption_tokens, self.padding_idx)
        self_mask = generate_sequential_mask(seq_len, caption_tokens.device) | pad_mask
        seq = torch.arange(1, seq_len + 1, device=caption_tokens.device)
        seq = seq[None, :].expand(b_s, seq_len).masked_fill(pad_mask[:, 0, 0, :], 0)

        embedded, _ = self.word_emb(caption_tokens)
        out = embedded + self.pos_table[seq].to(embedded.dtype)
        for layer in self.layers:
            out = layer(out, encoder_features, encoder_features, pad_mask,
                        self_mask, encoder_attention_mask)
        out = self.fc(out)
        if raw_logits:
            return out
        return torch.log_softmax(out.float(), dim=-1)

    # -- step decoding --------------------------------------------------
    def init_cache(self, batch_size: int, dtype=torch.float32, device="cpu") -> DecodeCache:
        """Zero-initialised cache; cross-attention K/V come from
        ``prepare_cache``."""
        from openviic_tpu_torch.models.base import make_decode_cache

        return make_decode_cache(self.config, self.vocab, batch_size, dtype, device)

    def prepare_cache(self, cache: DecodeCache, encoder_features) -> DecodeCache:
        """Project cross-attention K/V once per decode."""
        layers = [
            dict(lc, **layer.prepare_cache(encoder_features))
            for layer, lc in zip(self.layers, cache["layers"])
        ]
        return {**cache, "layers": layers}

    def _step_masks(self, tokens_t, t: int, cache: DecodeCache, ancestry=None):
        """Record this step's pad flag (in place) and build the
        self-attention mask (rows, 1, 1, L).  With ``ancestry`` each row's
        mask is resolved through the ancestry table."""
        pad = cache["pad"]
        pad[:, t] = tokens_t[:, 0] == self.padding_idx
        L = pad.shape[1]
        future = torch.arange(L, device=pad.device)[None, :] > t
        pad_read = pad
        if ancestry is not None:
            b_s, n_beams, _ = ancestry.shape
            pad_read = torch.gather(pad.reshape(b_s, n_beams, L), 1, ancestry)
            pad_read = pad_read.reshape(pad.shape)
        return (pad_read | future)[:, None, None, :]

    def step(self, t: int, tokens_t, cache: DecodeCache, encoder_attention_mask,
             ancestry=None, raw_head=False, beam_select=None):
        """One decode step.  ``tokens_t``: (rows, 1) current input token.

        Returns (head, cache).  ``head`` is the (rows, vocab) log-probs; with
        ``raw_head=True`` it is ``(logits f32, logsumexp (rows,))`` so the
        beam search can fold the log-softmax into selection; with
        ``raw_head="hidden"`` it is the (rows, d_model) pre-head hidden
        state, for the fused head + lse + top-k kernel (ops/head_topk.py)."""
        # beam-resident decode keeps the pad mask raw (each slot's own
        # rows) and applies it on the slot axis inside the attention
        raw_mask = beam_select is not None and ancestry is not None
        self_mask = self._step_masks(
            tokens_t, t, cache, ancestry=None if raw_mask else ancestry
        )
        is_pad = (tokens_t[:, :1] == self.padding_idx)[:, :, None]  # (rows, 1, 1)

        embedded, _ = self.word_emb(tokens_t)
        out = embedded + self.pos_table[t + 1][None, None, :].to(embedded.dtype)
        for layer, layer_cache in zip(self.layers, cache["layers"]):
            out = layer.step(
                out, layer_cache, t, self_mask, encoder_attention_mask,
                ancestry=ancestry, beam_select=beam_select,
                mask_axis="p" if raw_mask else "q",
            )
            out = out.masked_fill(is_pad, 0.0)

        if raw_head == "hidden":
            return out[:, 0, :], cache
        logits = self.fc(out).float()[:, 0, :]
        if raw_head:
            return (logits, torch.logsumexp(logits, dim=-1)), cache
        return torch.log_softmax(logits, dim=-1), cache


@META_DECODER.register()
class Decoder(_DecoderBase):
    """Generic N-layer masked decoder."""

    layer_cls = DecoderLayer
