"""Scaled dot-product attention and the MultiHeadAttention wrapper
(counterpart of ``openviic_tpu/models/attention.py``).

Decode state is an explicit, preallocated KV cache of *projected* K/V per
position: ``{"k": (rows, L, h, d_k), "v": (rows, L, h, d_v)}``.  Where the
JAX package returns an updated copy of the cache, the port writes this
step's K/V into it in place (one (rows, h, d) row per step instead of a
copy of the whole cache).

Scores, softmax and the probability-value product run in float32 whatever
the compute dtype, as the JAX einsums do with
``preferred_element_type=float32``; the result is cast back."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from openviic_tpu_torch.builders import META_ATTENTION, build_attention
from openviic_tpu_torch.models.initializers import XavierLinear

Cache = Dict[str, torch.Tensor]


def _resolve_ancestry(cache_arr: torch.Tensor, ancestry: torch.Tensor) -> torch.Tensor:
    """Per-position beam-slot resolution of an unreordered decode cache.

    ``cache_arr``: (bs*beam, L, h, d), each beam writing its own slot;
    ``ancestry``: (bs, beam, L), the slot holding position t' of each
    current beam's prefix.  out[b, j, t] = cache[b, ancestry[b, j, t], t],
    shaped like ``cache_arr`` (an index gather: ids and values are moved,
    never multiplied)."""
    b_s, n_beams, L = ancestry.shape
    shaped = cache_arr.reshape((b_s, n_beams) + tuple(cache_arr.shape[1:]))
    idx = ancestry.reshape(b_s, n_beams, L, 1, 1).expand(shaped.shape)
    return torch.gather(shaped, 1, idx).reshape(cache_arr.shape)


def _attend(q, k, v, d_k: int, mask: Optional[torch.Tensor]):
    """q (bs, nq, h, d_k), k/v (bs, nk, h, d), mask (bs, 1|h, nq|1, nk)
    True = masked -> (bs, nq, h, d_v) in q's dtype.  A fully masked row
    gives NaN, as in the JAX package's einsum path."""
    att = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d_k)
    if mask is not None:
        att = att.masked_fill(mask, float("-inf"))
    att = torch.softmax(att, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", att, v.float()).to(q.dtype)


@META_ATTENTION.register()
class ScaledDotProductAttention(nn.Module):
    """Plain scaled dot-product multi-head attention kernel."""

    def __init__(self, config):
        super().__init__()
        self.d_model, self.h = config.D_MODEL, config.HEAD
        self.d_k, self.d_v = config.D_KEY, config.D_VALUE
        self.fc_q = XavierLinear(self.d_model, self.h * self.d_k)
        self.fc_k = XavierLinear(self.d_model, self.h * self.d_k)
        self.fc_v = XavierLinear(self.d_model, self.h * self.d_v)
        self.fc_o = XavierLinear(self.h * self.d_v, self.d_model)

    def project_q(self, queries):
        bs, nq = queries.shape[:2]
        return self.fc_q(queries).reshape(bs, nq, self.h, self.d_k)

    def project_kv(self, x):
        bs, n = x.shape[:2]
        k = self.fc_k(x).reshape(bs, n, self.h, self.d_k)
        v = self.fc_v(x).reshape(bs, n, self.h, self.d_v)
        return k, v

    def output(self, out):
        bs, nq = out.shape[:2]
        return self.fc_o(out.reshape(bs, nq, self.h * self.d_v))

    def forward(self, queries, keys, values, attention_mask=None):
        q = self.project_q(queries)
        k = self.fc_k(keys).reshape(keys.shape[0], keys.shape[1], self.h, self.d_k)
        v = self.fc_v(values).reshape(values.shape[0], values.shape[1], self.h, self.d_v)
        return self.output(_attend(q, k, v, self.d_k, attention_mask))

    def attend_cached(self, queries, k, v, attention_mask):
        """Attention over an externally managed (cached) K/V."""
        q = self.project_q(queries)
        return self.output(_attend(q, k, v, self.d_k, attention_mask))

    def project_qkv_fused(self, x):
        """One matmul for q/k/v of the same input (decode hot path)."""
        bs, n = x.shape[:2]
        weight = torch.cat([self.fc_q.weight, self.fc_k.weight, self.fc_v.weight])
        bias = torch.cat([self.fc_q.bias, self.fc_k.bias, self.fc_v.bias])
        qkv = nn.functional.linear(x, weight, bias)
        hk = self.h * self.d_k
        q = qkv[..., :hk].reshape(bs, n, self.h, self.d_k)
        k = qkv[..., hk : 2 * hk].reshape(bs, n, self.h, self.d_k)
        v = qkv[..., 2 * hk :].reshape(bs, n, self.h, self.d_v)
        return q, k, v

    def attend_projected(self, q, k, v, attention_mask):
        return self.output(_attend(q, k, v, self.d_k, attention_mask))

    def attend_projected_beam_select(self, q_t, k, v, ancestry, position_mask,
                                     mask_axis: str = "q"):
        """Beam-resident self-attention step over *all* beams' unreordered
        caches of the same image (einsum form).

        q_t: (bs*beam, 1, h, d_k); k/v: (bs*beam, L, h, d) append-only
        caches; ancestry: (bs, beam, L); position_mask: (bs*beam, 1, 1, L)
        True = masked.  Scores are taken against every slot and the true
        ancestor is kept by an ancestry mask inside the softmax.  With
        ``mask_axis='q'`` the mask is already resolved per current beam;
        with ``'p'`` it is the raw per-slot mask, applied on the slot axis
        (equivalent, since position (q, t') survives only at slot
        p = ancestry[q, t'])."""
        b_s, n_beams, L = ancestry.shape
        h = q_t.shape[2]
        qb = q_t.reshape(b_s, n_beams, h, self.d_k).float()
        kb = k.reshape(b_s, n_beams, L, h, self.d_k).float()
        vb = v.reshape(b_s, n_beams, L, h, self.d_v).float()
        att = torch.einsum("bqhd,bpLhd->bqpLh", qb, kb) / math.sqrt(self.d_k)
        slots = torch.arange(n_beams, device=ancestry.device)
        onehot = ancestry[:, :, None, :] == slots[None, None, :, None]  # (bs, q, p, L)
        if mask_axis == "p":
            not_masked = ~position_mask.reshape(b_s, 1, n_beams, L)
        else:
            not_masked = ~position_mask.reshape(b_s, n_beams, 1, L)
        live = onehot & not_masked
        att = att.masked_fill(~live[..., None], float("-inf"))
        # exactly one live slot per (q, position): softmax over the joint
        # (slot, position) axis equals softmax over the resolved positions
        att = torch.softmax(att.reshape(b_s, n_beams, n_beams * L, h), dim=2)
        att = att.reshape(b_s, n_beams, n_beams, L, h)
        out = torch.einsum("bqpLh,bpLhd->bqhd", att, vb).to(q_t.dtype)
        return self.output(out.reshape(b_s * n_beams, 1, h, self.d_v))

    def attend_cached_grouped(self, queries, k, v, attention_mask, n_beams: int):
        """Cross-attention with K/V kept at image granularity: the beams of
        one image attend to one shared copy of the encoder memory's K/V.

        queries: (bs*beam, 1, d_model); k/v: (bs, M, h, d);
        attention_mask: (bs, 1, 1, M) True = masked."""
        b_s, M = k.shape[0], k.shape[1]
        q = self.project_q(queries).reshape(b_s, n_beams, self.h, self.d_k)
        att = torch.einsum("bqhd,bMhd->bqMh", q.float(), k.float()) / math.sqrt(self.d_k)
        if attention_mask is not None:
            att = att.masked_fill(attention_mask.reshape(b_s, 1, M, 1), float("-inf"))
        att = torch.softmax(att, dim=2)
        out = torch.einsum("bqMh,bMhd->bqhd", att, v.float()).to(queries.dtype)
        return self.output(out.reshape(b_s * n_beams, 1, self.h, self.d_v))


class MultiHeadAttention(nn.Module):
    """Attention kernel + dropout + post-LN residual (AoA gating is not
    ported).  ``forward`` is the cache-free path; ``decode_self`` and
    ``decode_cross`` are the two cached decode paths of the JAX
    ``__call__(cache=...)``."""

    def __init__(self, config):
        super().__init__()
        if config.USE_AOA:
            raise NotImplementedError("AoA gating is not ported yet")
        self.attention = build_attention(config)
        self.dropout = nn.Dropout(config.DROPOUT)
        self.layer_norm = nn.LayerNorm(config.D_MODEL, eps=1e-5)

    def _finish(self, queries, out):
        return self.layer_norm(queries + self.dropout(out))

    def forward(self, queries, keys, values, attention_mask=None):
        out = self.attention(queries, keys, values, attention_mask=attention_mask)
        return self._finish(queries, out)

    def decode_self(self, queries, cache: Cache, decode_index: int,
                    attention_mask, ancestry=None, beam_select=None,
                    mask_axis: str = "q"):
        """Self-attention step: write this step's projected K/V at
        ``decode_index`` (in place), then attend.  With ``beam_select`` and
        ``ancestry`` the cache is never reordered (beam-resident); with
        ``ancestry`` alone each read resolves its slots by gather."""
        q_t, k_t, v_t = self.attention.project_qkv_fused(queries)
        cache["k"][:, decode_index] = k_t[:, 0]
        cache["v"][:, decode_index] = v_t[:, 0]
        k, v = cache["k"], cache["v"]
        if beam_select is not None and ancestry is not None:
            out = self.attention.attend_projected_beam_select(
                q_t, k, v, ancestry, attention_mask, mask_axis=mask_axis
            )
        else:
            if ancestry is not None:
                k = _resolve_ancestry(k, ancestry)
                v = _resolve_ancestry(v, ancestry)
            out = self.attention.attend_projected(q_t, k, v, attention_mask)
        return self._finish(queries, out)

    def decode_cross(self, queries, cache: Cache, attention_mask, beam_select=None):
        """Cross-attention step over K/V precomputed from the encoder memory;
        with ``beam_select`` and image-granularity K/V, beams share it."""
        if beam_select is not None and cache["k"].shape[0] != queries.shape[0]:
            out = self.attention.attend_cached_grouped(
                queries, cache["k"], cache["v"], attention_mask, beam_select
            )
        else:
            out = self.attention.attend_cached(
                queries, cache["k"], cache["v"], attention_mask
            )
        return self._finish(queries, out)

    def precompute_cache(self, memory) -> Cache:
        """Project cross-attention K/V over the encoder memory once."""
        k, v = self.attention.project_kv(memory)
        return {"k": k, "v": v}
