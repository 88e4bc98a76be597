"""Caption decoders (counterpart of ``openviic_tpu/models/decoders.py``:
``DecoderLayer``, ``MeshedDecoderLayer``, ``_DecoderBase``, ``Decoder``,
``MeshedDecoder``).

Teacher-forced and step decoding share the weights.  Step decoding threads
an explicit DecodeCache dict: per layer ``{"self": {"k", "v"}, "cross":
{"k", "v"}}`` plus a running token-was-pad mask ``"pad"`` (rows, L).  The
port updates the self-attention K/V and the pad mask in place.  Semantics
follow the JAX package:

 - self-attention at step t masks cached positions j > t and positions
   whose token was <pad>;
 - the positional index at step t is t+1 whatever the pad status;
 - each layer's output is zeroed where the *input* token is <pad>.

A layer's decode step can also run as one kernel, as in the JAX package:
``resident_kernel`` on the beam-resident path (``ops.resident_layer_step``)
and ``OPENVIIC_FUSED_STEP=1`` on the non-resident path
(``ops.fused_layer_step``); both read the layer's weight pack
(``DecoderLayer.fused_weights``), built once per dtype.  Neither runs a
layer with the Attention-on-Attention gate, which they do not implement.
A layer whose FFN is the Switch MoE passes the same gates, as in the JAX
package, whose weight pack then fails; the port raises ``ValueError``
there (``MOE_LAYER_KERNEL``).

The Meshed-Memory decoder's layers cross-attend each of the encoder's N
levels (memory (bs, N, n, d)) with one shared ``enc_attn`` and fuse them
through sigmoid gates.  It has no whole-layer kernel; ``resident_kernel``
on it raises, where the JAX package fails (see ``MeshedDecoderLayer.step``).

RSTNet's ``AdaptiveDecoder`` runs N standard layers and one more over
``ADAPTIVE_ATTENTION``, every layer given per-position language signals
from a frozen language model (``models/language_models.py``).  Those
signals are an attention input, so no whole-layer kernel runs its layers
(the JAX gates need an empty option set), and the beam search decodes it
off the beam-resident path.  A decode step needs the signal of the
current token only, a pure function of its id: ``language_signal_table``
computes them all once, and a step given the table in its cache
(``"language_table"``) gathers a row instead of running the language
model.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from openviic_tpu_torch.builders import (
    META_DECODER,
    build_pretrained_language_model,
    build_text_embedding,
)
from openviic_tpu_torch.models.attention import MultiHeadAttention
from openviic_tpu_torch.models.ffn import MoEPositionWiseFeedForward, make_pwff
from openviic_tpu_torch.models.initializers import TorchLinear, XavierLinear
from openviic_tpu_torch.models.masks import (
    generate_padding_mask,
    generate_sequential_mask,
)
from openviic_tpu_torch.models.positional import sinusoid_encoding_table
from openviic_tpu_torch.ops.fused_decoder_step import fused_layer_step, fused_step_enabled
from openviic_tpu_torch.ops.resident_layer_step import resident_layer_step

DecodeCache = Dict[str, Any]

# the JAX package's failure that both whole-layer kernels meet on a layer
# whose FFN is the Switch MoE (its gates let the layer in)
MOE_LAYER_KERNEL = (
    "resident_kernel and OPENVIIC_FUSED_STEP=1 do not run a decoder layer whose FFN is the "
    "Switch MoE: in the JAX package both gates let it in and the weight pack fails "
    "(AttributeError: \"MoEPositionWiseFeedForward\" object has no attribute \"fc1\", "
    "openviic_tpu/models/decoders.py:183)")


# the per-query attention inputs a decoder may thread through its layers'
# options (the adaptive decoder's), as against the decode switches
ATTENTION_INPUTS = ("language_signals",)


def _inputs(options) -> Dict[str, Any]:
    return {k: options[k] for k in ATTENTION_INPUTS if k in options}


def _decode_self(self_attn, queries, layer_cache, decode_index, self_attention_mask,
                 ancestry, options):
    """A layer's self-attention decode step with the decoder's attention
    ``options`` (``beam_select``, ``mask_axis``, ``attn_kernel``, and the
    attention inputs of ``ATTENTION_INPUTS``)."""
    return self_attn.decode_self(
        queries, layer_cache["self"], decode_index, self_attention_mask,
        ancestry=ancestry, beam_select=options.get("beam_select"),
        mask_axis=options.get("mask_axis", "q"),
        attn_kernel=options.get("attn_kernel", False), **_inputs(options),
    )


class DecoderLayer(nn.Module):
    """Masked self-attention + cross-attention + FFN."""

    def __init__(self, config):
        super().__init__()
        self.self_attn = MultiHeadAttention(config.SELF_ATTENTION)
        self.enc_attn = MultiHeadAttention(config.ENC_ATTENTION)
        self.pwff = make_pwff(config.ENC_ATTENTION)

    def forward(self, queries, keys, values, self_padding_mask,
                self_attention_mask, enc_attention_mask, **inputs):
        """``inputs``: per-query attention inputs for both attentions (the
        adaptive decoder's ``language_signals``)."""
        self_att = self.self_attn(queries, queries, queries, self_attention_mask, **inputs)
        enc_att = self.enc_attn(self_att, keys, values, enc_attention_mask, **inputs)
        ff = self.pwff(enc_att)
        return ff.masked_fill(self_padding_mask[:, 0, 0, :, None], 0.0)

    def prepare_cache(self, memory) -> DecodeCache:
        return {"cross": self.enc_attn.precompute_cache(memory)}

    def step(self, queries, layer_cache, decode_index, self_attention_mask,
             enc_attention_mask, ancestry=None, resident_kernel=False,
             is_pad_t=None, **kwargs):
        """One decode step of the layer.  ``kwargs`` are the attention
        options the decoder threads (``beam_select``, ``mask_axis``,
        ``attn_kernel``), as in the JAX package: with ``resident_kernel``
        and no option but ``beam_select``/``mask_axis`` the whole step runs
        as ``ops.resident_layer_step``; with ``OPENVIIC_FUSED_STEP=1``, no
        option and no ancestry, as ``ops.fused_layer_step``.  The self K/V
        cache is updated in place either way.  In train mode (dropout-active
        sampling) neither whole-layer kernel runs, since neither implements
        dropout (the JAX package's gate, ``decoders.py:83-98``); the
        beam-select attention kernel still does, as dropout acts after the
        attention."""
        if (not self.training and resident_kernel
                and self._can_resident_step(kwargs, ancestry, is_pad_t)):
            return self._resident_step(
                queries, layer_cache, decode_index, self_attention_mask,
                enc_attention_mask, ancestry, is_pad_t,
            )
        if not self.training and self._can_fuse_step(kwargs, ancestry):
            return self._fused_step(
                queries, layer_cache, decode_index, self_attention_mask, enc_attention_mask,
            )
        self_att = _decode_self(self.self_attn, queries, layer_cache, decode_index,
                                self_attention_mask, ancestry, kwargs)
        enc_att = self.enc_attn.decode_cross(
            self_att, layer_cache["cross"], enc_attention_mask,
            beam_select=kwargs.get("beam_select"), **_inputs(kwargs),
        )
        return self.pwff(enc_att)

    def _kernel_layer(self) -> bool:
        """Whether the whole-layer kernels implement this layer: plain SDPA
        in both attentions and no AoA gate (the JAX gates,
        ``decoders.py:120-127``, ``:160-167``)."""
        return all(type(mha.attention).__name__ == "ScaledDotProductAttention"
                   and not mha.use_aoa for mha in (self.self_attn, self.enc_attn))

    # -- beam-resident whole-layer step (ops/resident_layer_step.py) -----
    def _can_resident_step(self, kwargs, ancestry, is_pad_t) -> bool:
        # an ``attn_kernel`` option keeps the unfused step, whose
        # self-attention then runs through the beam-select kernel (the JAX
        # package's precedence, decoders.py:118-128)
        return (
            ancestry is not None
            and is_pad_t is not None
            and kwargs.get("beam_select") is not None
            and set(kwargs) <= {"beam_select", "mask_axis"}
            and self._kernel_layer()
        )

    def _resident_step(self, queries, layer_cache, decode_index, self_attention_mask,
                       enc_attention_mask, ancestry, is_pad_t):
        sc, cc = layer_cache["self"], layer_cache["cross"]
        y, k_new, v_new = resident_layer_step(
            queries, sc["k"], sc["v"], cc["k"], cc["v"], ancestry,
            self_attention_mask, enc_attention_mask, is_pad_t, decode_index,
            self.fused_weights(queries.dtype), n_heads=sc["k"].shape[2],
        )
        sc["k"][:, decode_index] = k_new
        sc["v"][:, decode_index] = v_new
        return y

    # -- non-resident whole-layer step (OPENVIIC_FUSED_STEP=1) -----------
    def _can_fuse_step(self, kwargs, ancestry) -> bool:
        return (fused_step_enabled() and not kwargs and ancestry is None
                and self._kernel_layer())

    def _fused_step(self, queries, layer_cache, decode_index, self_attention_mask,
                    enc_attention_mask):
        sc, cc = layer_cache["self"], layer_cache["cross"]
        n, L, h = sc["k"].shape[:3]
        M = cc["k"].shape[1]

        def flat(c):  # (rows, S, h, d) -> (rows, S, D), a view
            return c.reshape(c.shape[0], c.shape[1], -1)

        self_mask = self_attention_mask[:, 0, 0, :].expand(n, L).contiguous()
        cross_mask = enc_attention_mask[:, 0, 0, :].expand(n, M).contiguous()
        y, _, _ = fused_layer_step(
            queries[:, 0, :], flat(sc["k"]), flat(sc["v"]), flat(cc["k"]), flat(cc["v"]),
            self_mask, cross_mask, decode_index, self.fused_weights(queries.dtype),
            n_heads=h,
        )
        return y[:, None, :]

    def fused_weights(self, dtype) -> Dict[str, torch.Tensor]:
        """The whole-layer kernels' weight dict (the JAX ``_fused_weights``:
        (in, out) kernels, q | k | v concatenated), in ``dtype``, contiguous.
        Built once and kept until a parameter is replaced or changed in
        place (checked by data pointer and version counter).  A MoE FFN,
        which the kernels do not implement, raises ``MOE_LAYER_KERNEL``."""
        if isinstance(self.pwff, MoEPositionWiseFeedForward):
            raise ValueError(MOE_LAYER_KERNEL)
        params = tuple(self.parameters())
        key = (dtype, tuple((p.data_ptr(), p._version) for p in params))
        cached = getattr(self, "_fused_pack", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        sa, ca, ff = self.self_attn, self.enc_attn, self.pwff

        def kernel(linear):
            return linear.weight.detach().t()

        with torch.no_grad():
            pack = {
                "wqkv": torch.cat([kernel(sa.attention.fc_q), kernel(sa.attention.fc_k),
                                   kernel(sa.attention.fc_v)], dim=1),
                "bqkv": torch.cat([sa.attention.fc_q.bias, sa.attention.fc_k.bias,
                                   sa.attention.fc_v.bias]),
                "wo": kernel(sa.attention.fc_o), "bo": sa.attention.fc_o.bias,
                "wqc": kernel(ca.attention.fc_q), "bqc": ca.attention.fc_q.bias,
                "woc": kernel(ca.attention.fc_o), "boc": ca.attention.fc_o.bias,
                "w1": kernel(ff.fc1), "b1": ff.fc1.bias,
                "w2": kernel(ff.fc2), "b2": ff.fc2.bias,
                "ln1s": sa.layer_norm.weight, "ln1b": sa.layer_norm.bias,
                "ln2s": ca.layer_norm.weight, "ln2b": ca.layer_norm.bias,
                "ln3s": ff.layer_norm.weight, "ln3b": ff.layer_norm.bias,
            }
            pack = {k: v.detach().to(dtype).contiguous() for k, v in pack.items()}
        self._fused_pack = (key, pack)
        return pack


# the JAX package's failure that ``resident_kernel`` meets on this decoder
MESHED_RESIDENT_KERNEL = (
    "resident_kernel does not run MeshedDecoder: in the JAX package its layers take the "
    "flag as an attention option, which turns off the grouped cross-attention, and the "
    "step fails (ValueError: Size of label 'b' for operand 1 does not match previous terms)")


class MeshedDecoderLayer(nn.Module):
    """Self-attention, one cross-attention per encoder level through the
    shared ``enc_attn``, fused as sum_j sigmoid(fc_alpha_j([self, cross_j]))
    * cross_j / sqrt(N), then the FFN (JAX ``MeshedDecoderLayer``)."""

    def __init__(self, config):
        super().__init__()
        self.self_attn = MultiHeadAttention(config.SELF_ATTENTION)
        self.enc_attn = MultiHeadAttention(config.ENC_ATTENTION)
        self.pwff = make_pwff(config.ENC_ATTENTION)
        self.n_levels = config.N_ENCODER_LAYERS
        for j in range(self.n_levels):  # the JAX names, fc_alpha_<j>
            setattr(self, f"fc_alpha_{j}", XavierLinear(2 * config.D_MODEL, config.D_MODEL))

    def _fuse(self, self_att, enc_atts):
        out = 0.0
        for j, enc_att in enumerate(enc_atts):
            fc_alpha = getattr(self, f"fc_alpha_{j}")
            alpha = torch.sigmoid(fc_alpha(torch.cat([self_att, enc_att], dim=-1)))
            out = out + alpha * enc_att
        # the JAX divisor: sqrt(N) in f32, then in the activations' dtype
        return out / torch.tensor(float(self.n_levels)).sqrt().to(out.dtype)

    def forward(self, queries, keys, values, self_padding_mask,
                self_attention_mask, enc_attention_mask):
        self_att = self.self_attn(queries, queries, queries, self_attention_mask)
        enc_atts = [self.enc_attn(self_att, keys[:, j], values[:, j], enc_attention_mask)
                    for j in range(self.n_levels)]
        ff = self.pwff(self._fuse(self_att, enc_atts))
        return ff.masked_fill(self_padding_mask[:, 0, 0, :, None], 0.0)

    def prepare_cache(self, memory) -> DecodeCache:
        """Each level's cross K/V, stacked to (rows, N, n, h, d)."""
        levels = [self.enc_attn.precompute_cache(memory[:, j]) for j in range(self.n_levels)]
        return {"cross": {key: torch.stack([lv[key] for lv in levels], dim=1)
                          for key in ("k", "v")}}

    def step(self, queries, layer_cache, decode_index, self_attention_mask,
             enc_attention_mask, ancestry=None, **kwargs):
        """One decode step: the self-attention through ``decode_self`` (the
        beam-select kernel under ``attn_kernel``), each level through
        ``decode_cross`` (grouped at image granularity in beam-resident
        mode).  The self K/V cache is updated in place."""
        if kwargs.get("resident_kernel"):
            raise ValueError(MESHED_RESIDENT_KERNEL)
        self_att = _decode_self(self.self_attn, queries, layer_cache, decode_index,
                                self_attention_mask, ancestry, kwargs)
        cross = layer_cache["cross"]
        enc_atts = [self.enc_attn.decode_cross(
            self_att, {"k": cross["k"][:, j], "v": cross["v"][:, j]}, enc_attention_mask,
            beam_select=kwargs.get("beam_select")) for j in range(self.n_levels)]
        return self.pwff(self._fuse(self_att, enc_atts))


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

        inputs = self._attention_inputs(caption_tokens)
        embedded, _ = self.word_emb(caption_tokens)
        out = embedded + self.pos_table[seq].to(embedded.dtype)
        for layer in self.layers:
            out = layer(out, encoder_features, encoder_features, pad_mask,
                        self_mask, encoder_attention_mask, **inputs)
        if raw_logits == "hidden":  # the pre-head state (a vocab-parallel head's input)
            return out
        out = self.fc(out)
        if raw_logits:
            return out
        return torch.log_softmax(out.float(), dim=-1)

    def _attention_inputs(self, caption_tokens) -> Dict[str, Any]:
        """Per-query attention inputs of the teacher-forced pass (none)."""
        return {}

    def _step_attention_inputs(self, tokens_t, cache: DecodeCache) -> Dict[str, Any]:
        """Per-query attention inputs of a decode step (none)."""
        return {}

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
             ancestry=None, raw_head=False, resident_kernel: bool = False, **kwargs):
        """One decode step.  ``tokens_t``: (rows, 1) current input token.
        ``kwargs`` (``beam_select``, ``attn_kernel``) go to every layer;
        ``resident_kernel`` lets each layer run as one
        ``ops.resident_layer_step`` (beam-resident decode only).

        Returns (head, cache).  ``head`` is the (rows, vocab) log-probs; with
        ``raw_head=True`` it is ``(logits f32, logsumexp (rows,))`` so the
        beam search can fold the log-softmax into selection; with
        ``raw_head="hidden"`` it is the (rows, d_model) pre-head hidden
        state, for the fused head + lse + top-k kernel (ops/head_topk.py)."""
        # beam-resident decode keeps the pad mask raw (each slot's own
        # rows) and applies it on the slot axis inside the attention
        raw_mask = kwargs.get("beam_select") is not None and ancestry is not None
        self_mask = self._step_masks(
            tokens_t, t, cache, ancestry=None if raw_mask else ancestry
        )
        is_pad = (tokens_t[:, :1] == self.padding_idx)[:, :, None]  # (rows, 1, 1)

        inputs = self._step_attention_inputs(tokens_t, cache)
        embedded, _ = self.word_emb(tokens_t)
        out = embedded + self.pos_table[t + 1][None, None, :].to(embedded.dtype)
        layer_kwargs = dict(kwargs, **inputs)
        if raw_mask:
            layer_kwargs["mask_axis"] = "p"
        if resident_kernel:
            # the whole-layer kernel zeroes <pad> rows itself as well
            layer_kwargs.update(resident_kernel=True, is_pad_t=is_pad[:, :, 0])
        for layer, layer_cache in zip(self.layers, cache["layers"]):
            out = layer.step(
                out, layer_cache, t, self_mask, encoder_attention_mask,
                ancestry=ancestry, **layer_kwargs,
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


@META_DECODER.register()
class MeshedDecoder(_DecoderBase):
    """The Meshed-Memory decoder over the stacked encoder levels."""

    layer_cls = MeshedDecoderLayer


@META_DECODER.register()
class AdaptiveDecoder(_DecoderBase):
    """RSTNet's adaptive decoder (JAX ``AdaptiveDecoder``): ``LAYERS``
    standard layers over ``ATTENTION``, one more over
    ``ADAPTIVE_ATTENTION``, and the frozen language model
    ``LANGUAGE_MODEL``, whose signals every layer's attentions receive.

    ``LANGUAGE_MODEL.SIGNAL_MODE``: ``prefix`` (the default) runs the
    language model over the whole caption; ``token`` runs it on each token
    alone, the function a decode step evaluates, with <pad> replaced by
    <bos> before the call (a <pad> row would be fully masked inside the
    language model, whose NaN softmax gradient would poison the update;
    its signal is never read).  Every path calls the language model's
    ``signals``, never its vocab head."""

    def __init__(self, config, vocab):
        super().__init__(config, vocab)
        self.layers.append(DecoderLayer(config.ADAPTIVE_ATTENTION))
        self.language_model = build_pretrained_language_model(config.LANGUAGE_MODEL)
        self.signal_mode = config.LANGUAGE_MODEL.get("SIGNAL_MODE", "prefix")

    def _attention_inputs(self, caption_tokens) -> Dict[str, Any]:
        if self.signal_mode != "token":
            return {"language_signals": self.language_model.signals(caption_tokens)}
        b_s, seq_len = caption_tokens.shape[:2]
        flat = caption_tokens.reshape(-1, 1)
        flat = torch.where(flat == self.padding_idx, self.vocab.bos_idx, flat)
        signals = self.language_model.signals(flat)
        return {"language_signals": signals.reshape(b_s, seq_len, -1)}

    def _step_attention_inputs(self, tokens_t, cache: DecodeCache) -> Dict[str, Any]:
        table = cache.get("language_table")
        if table is not None:  # one gather replaces the language model
            return {"language_signals": table[tokens_t[:, 0]][:, None]}
        return {"language_signals": self.language_model.signals(tokens_t)}

    def language_signal_table(self) -> torch.Tensor:
        """(vocab, D_MODEL) language signals of every caption-vocab id, each
        the language model's output on that id alone (the pad row
        included: zero, as the encoder layer zeroes its masked query), so a
        decode step may gather its row (``cache["language_table"]``)."""
        ids = torch.arange(len(self.vocab), device=self.fc.weight.device)[:, None]
        return self.language_model.signals(ids)[:, 0]

    def step(self, t: int, tokens_t, cache: DecodeCache, encoder_attention_mask,
             ancestry=None, raw_head=False, **kwargs):
        """One decode step over the N + 1 layers (``_DecoderBase.step``) with
        the current token's language signals; the decode switches in
        ``kwargs`` (``beam_select``, the kernels) are ignored, as the JAX
        ``AdaptiveDecoder.step`` ignores them."""
        return super().step(t, tokens_t, cache, encoder_attention_mask, ancestry=ancestry,
                            raw_head=raw_head)
