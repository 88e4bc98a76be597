"""BaseTransformer: the architecture shell (counterpart of
``openviic_tpu/models/base.py``): vision embedding -> encoder -> decoder,
with the decode API ``encoder_forward`` / ``prepare_cache`` /
``decode_step`` that the beam search drives."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from openviic_tpu_torch.models.decoders import DecodeCache


def make_decode_cache(decoder_config, vocab, batch_size: int,
                      dtype=torch.float32, device="cpu") -> DecodeCache:
    """A zero DecodeCache from config shapes (no parameters needed); the
    cross-attention entries are filled by ``prepare_cache``."""
    if decoder_config.ARCHITECTURE != "Decoder":
        raise NotImplementedError(
            f"decode cache for {decoder_config.ARCHITECTURE} is not ported yet"
        )
    L = vocab.max_caption_length
    self_cfg = decoder_config.ATTENTION.SELF_ATTENTION
    layers = []
    for _ in range(decoder_config.LAYERS):
        k = torch.zeros((batch_size, L, self_cfg.HEAD, self_cfg.D_KEY), dtype=dtype, device=device)
        v = torch.zeros((batch_size, L, self_cfg.HEAD, self_cfg.D_VALUE), dtype=dtype, device=device)
        layers.append({"self": {"k": k, "v": v}, "cross": None})
    pad = torch.zeros((batch_size, L), dtype=torch.bool, device=device)
    return {"layers": layers, "pad": pad}


class BaseTransformer(nn.Module):
    """Composition shell; subclasses define the modules and
    ``encoder_forward``."""

    def __init__(self, config, vocab):
        super().__init__()
        self.config = config
        self.vocab = vocab

    def encoder_forward(self, batch: Dict[str, torch.Tensor]):
        raise NotImplementedError

    def forward(self, batch: Dict[str, torch.Tensor], raw_logits: bool = False):
        """Teacher-forced forward -> (bs, seq_len, vocab) f32 log-probs
        (``raw_logits=True``: the head logits in compute dtype)."""
        encoder_features, encoder_padding_mask = self.encoder_forward(batch)
        return self.decoder(
            batch["caption_tokens"], encoder_features, encoder_padding_mask,
            raw_logits=raw_logits,
        )

    def prepare_cache(self, cache: DecodeCache, encoder_features) -> DecodeCache:
        return self.decoder.prepare_cache(cache, encoder_features)

    def decode_step(self, t: int, tokens_t, cache: DecodeCache,
                    encoder_attention_mask, ancestry=None, beam_select=None,
                    raw_head=False):
        """One decoder step; ``beam_select`` (the beam size) switches the
        attention layers to beam-resident mode, grouping rows by image."""
        return self.decoder.step(
            t, tokens_t, cache, encoder_attention_mask, ancestry=ancestry,
            raw_head=raw_head, beam_select=beam_select,
        )
