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
                      dtype=torch.float32, device="cpu", model_parallel: int = 1,
                      whole_heads=()) -> DecodeCache:
    """A zero DecodeCache from config shapes (no parameters needed); the
    cross-attention entries are filled by ``prepare_cache``.  ``Decoder``
    and ``MeshedDecoder`` share its layout; ``AdaptiveDecoder``'s has one
    layer more, over ``ADAPTIVE_ATTENTION``.  A tensor-parallel model keeps
    1 / ``model_parallel`` of the heads a rank where that divides them,
    except in the layers that ``whole_heads`` (a bool a layer) marks, whose
    decode runs a whole-layer kernel on every head; an attention whose
    heads the axis does not divide attends whole heads, and keeps them."""
    arch = decoder_config.ARCHITECTURE
    if arch not in ("Decoder", "MeshedDecoder", "AdaptiveDecoder"):
        raise NotImplementedError(f"decode cache for {arch} is not ported yet")
    L = vocab.max_caption_length
    attentions = [decoder_config.ATTENTION] * decoder_config.LAYERS
    if arch == "AdaptiveDecoder":
        attentions.append(decoder_config.ADAPTIVE_ATTENTION)
    layers = []
    for i, attention in enumerate(attentions):
        self_cfg = attention.SELF_ATTENTION
        whole = self_cfg.HEAD % model_parallel or (i < len(whole_heads) and whole_heads[i])
        shape = (batch_size, L, self_cfg.HEAD if whole else self_cfg.HEAD // model_parallel)
        k = torch.zeros(shape + (self_cfg.D_KEY,), dtype=dtype, device=device)
        v = torch.zeros(shape + (self_cfg.D_VALUE,), dtype=dtype, device=device)
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
        (``raw_logits=True``: the head logits in compute dtype;
        ``"hidden"``: the (bs, seq_len, d_model) pre-head hidden state)."""
        encoder_features, encoder_padding_mask = self.encoder_forward(batch)
        return self.decoder(
            batch["caption_tokens"], encoder_features, encoder_padding_mask,
            raw_logits=raw_logits,
        )

    def prepare_cache(self, cache: DecodeCache, encoder_features,
                      whole_heads=()) -> DecodeCache:
        return self.decoder.prepare_cache(cache, encoder_features, whole_heads)

    @torch.no_grad()
    def compute_language_table(self):
        """The (vocab, d) language-signal table of a decoder with a frozen
        language model (``AdaptiveDecoder.language_signal_table``), None
        for the others.  Computed once per checkpoint and passed to
        ``beam_search(..., language_table=...)``, it replaces the language
        model of every decode step by a gather, exactly."""
        fn = getattr(self.decoder, "language_signal_table", None)
        return None if fn is None else fn()

    def decode_step(self, t: int, tokens_t, cache: DecodeCache,
                    encoder_attention_mask, ancestry=None, beam_select=None,
                    raw_head=False, resident_kernel: bool = False,
                    attn_kernel: bool = False):
        """One decoder step; ``beam_select`` (the beam size) switches the
        attention layers to beam-resident mode, grouping rows by image, and
        only then are the step kernels threaded: ``resident_kernel`` (one
        ``ops.resident_layer_step`` per layer) and ``attn_kernel`` (the
        self-attention through ``ops.beam_select_attention``)."""
        kwargs = {}
        if beam_select is not None:
            kwargs["beam_select"] = beam_select
            if resident_kernel:
                kwargs["resident_kernel"] = True
            if attn_kernel:
                kwargs["attn_kernel"] = True
        return self.decoder.step(
            t, tokens_t, cache, encoder_attention_mask, ancestry=ancestry,
            raw_head=raw_head, **kwargs,
        )
