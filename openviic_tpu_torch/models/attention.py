"""Scaled dot-product attention and the MultiHeadAttention wrapper
(counterpart of ``openviic_tpu/models/attention.py``).

Decode state is an explicit, preallocated KV cache of *projected* K/V per
position: ``{"k": (rows, L, h, d_k), "v": (rows, L, h, d_v)}``.  Where the
JAX package returns an updated copy of the cache, the port writes this
step's K/V into it in place (one (rows, h, d) row per step instead of a
copy of the whole cache).

Scores, softmax and the probability-value product run in float32 whatever
the compute dtype, as the JAX einsums do with
``preferred_element_type=float32``; the result is cast back.

With ``OPENVIIC_PALLAS`` set, ``_attend`` runs ``ops.fused_attention``
instead and, as the JAX ``_attend`` does, returns its float32 output
uncast: the output projection then runs in f32 (Flax promotes the bf16
weights; the port promotes them explicitly, ``promoted_linear``), and the
residual and LayerNorm of ``MultiHeadAttention._finish`` too, which rounds
back to the queries' dtype once.

``AugmentedMemoryScaledDotProductAttention`` appends its learnt memory
slots to K and V in float32, as the JAX package does (its f32 scale
factors make the slots, and with them K and V, f32 at bf16); under
``OPENVIIC_PALLAS`` ``_attend`` then hands the kernel q, k and v in their
promoted dtype, as the JAX kernel casts all three to f32 itself.
``MultiHeadAttention`` applies the Attention-on-Attention gate
(``USE_AOA``) after its residual on every path: the cache-free forward
and both decode paths.

``AdaptiveScaledDotProductAttention`` (RSTNet) takes a per-query input
beside q, k and v, its language signals; the adaptive decoder hands them
to every attention of its layers (the others take and ignore them, the
JAX package's ``**kwargs``), and, as there, an attention given such an
input decodes through ``project_kv`` and ``attend_cached``: no fused qkv
projection, no beam-select path, no grouped cross-attention.  It computes
its own softmax and never reaches ``ops.fused_attention``."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from openviic_tpu_torch.builders import META_ATTENTION, build_attention
from openviic_tpu_torch.models.initializers import TorchLinear, XavierLinear, normal_init
from openviic_tpu_torch.ops.beam_select_attention import beam_select_attention
from openviic_tpu_torch.ops.fused_attention import NEG, fused_attention, pallas_enabled
from openviic_tpu_torch.ops.geo_attention import geo_fused_attention

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


def promoted_linear(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``linear(x)`` in the promoted dtype of ``x`` and the weights, as a
    Flax ``Dense`` computes it (an f32 input to bf16 weights gives f32).  A
    tensor-parallel linear (``parallel.tensor_parallel``) promotes itself."""
    if getattr(linear, "promotes", False):
        return linear(x)
    dtype = torch.promote_types(x.dtype, linear.weight.dtype)
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return nn.functional.linear(x.to(dtype), linear.weight.to(dtype), bias)


def residual_layer_norm(layer_norm: nn.LayerNorm, x: torch.Tensor,
                        out: torch.Tensor) -> torch.Tensor:
    """``layer_norm(x + out)`` with the sum and the normalisation in f32,
    rounded to ``x``'s dtype once, as XLA computes the JAX package's fused
    residual + LayerNorm at bf16 (and as Flax promotes the bf16 LayerNorm
    parameters for the f32 attention output under ``OPENVIIC_PALLAS``)."""
    y = nn.functional.layer_norm(
        x.float() + out.float(), layer_norm.normalized_shape, layer_norm.weight.float(),
        layer_norm.bias.float(), layer_norm.eps,
    )
    return y.to(x.dtype)


def _ring_dispatch(q, k, v, d_k: int, mask, bias):
    """The sequence-parallel path (JAX's ``_ring_dispatch``): inside a
    ``parallel.ring_attention`` context, bidirectional self-attention (nq
    == nk, a length that the context's seq axis divides, a mask without a
    query axis and without a head axis) runs as a K/V ring over that axis,
    or, under ``mode="ulysses"``, as Ulysses where the axis divides the
    heads.  Returns None when not eligible (decoder causal or cached
    attention, per-head masks, indivisible lengths) or outside a context.
    The context is read at each call (no trace to cache it)."""
    from openviic_tpu_torch.parallel.ring_attention import (
        current_ring_context,
        ring_self_attention,
    )

    ctx = current_ring_context()
    if ctx is None:
        return None
    nq, nk = q.shape[1], k.shape[1]
    n_shards = ctx.mesh.axis_size(ctx.seq_axis)
    if (nq != nk or nq % n_shards != 0
            or (mask is not None and (mask.shape[2] != 1 or mask.shape[1] != 1))):
        return None
    key_mask = mask[:, 0, 0, :] if mask is not None else None
    attend = ring_self_attention
    if ctx.mode == "ulysses" and q.shape[2] % n_shards == 0:
        from openviic_tpu_torch.parallel.ulysses import ulysses_self_attention

        attend = ulysses_self_attention
    # a row whose every key is masked gives 0 here (NaN on the dense path);
    # such rows are padding queries, which the encoders zero
    out = attend(q, k, v, ctx.mesh, bias=bias, key_mask=key_mask, seq_axis=ctx.seq_axis,
                 batch_axis=ctx.batch_axis, scale=1.0 / math.sqrt(d_k))
    return out.to(q.dtype)


def _attend(q, k, v, d_k: int, mask: Optional[torch.Tensor],
            bias: Optional[torch.Tensor] = None):
    """q (bs, nq, h, d_k), k/v (bs, nk, h, d), mask (bs, 1|h, nq|1, nk)
    True = masked, an optional additive bias (bs, h, nq, nk) -> (bs, nq, h,
    d_v) in q's dtype.  A fully masked row gives NaN, as in the JAX
    package's einsum path.

    With ``OPENVIIC_PALLAS`` (``pallas_enabled``) the mask becomes a -1e30
    bias (in the bias's dtype, as JAX's weakly typed ``jnp.where`` adds to
    it), and ``ops.fused_attention``'s float32 output is returned uncast,
    as in the JAX package; a fully masked row is then uniform.  q, k and v
    of mixed dtypes (the augmented memory's f32 K/V under bf16 queries) go
    to the kernel in their promoted dtype, since it takes one.

    Inside a ``parallel.ring_attention`` context an eligible call takes
    the sequence-parallel layout first (``_ring_dispatch``), as in JAX."""
    ring = _ring_dispatch(q, k, v, d_k, mask, bias)
    if ring is not None:
        return ring
    if pallas_enabled():
        common = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        q, k, v = q.to(common), k.to(common), v.to(common)
        total = bias
        if mask is not None:
            dtype = torch.float32 if bias is None else bias.dtype
            mask_bias = torch.zeros(mask.shape, dtype=dtype, device=mask.device)
            mask_bias = mask_bias.masked_fill(mask, NEG)
            total = mask_bias if total is None else total + mask_bias
        return fused_attention(q, k, v, bias=total, sm_scale=1.0 / math.sqrt(d_k))
    att = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d_k)
    if mask is not None:
        att = att.masked_fill(mask, float("-inf"))
    if bias is not None:
        att = att + bias
    att = torch.softmax(att, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", att, v.float()).to(q.dtype)


class _Projections(nn.Module):
    """The q/k/v/o projections every attention kernel has (xavier kernels,
    zero biases; the JAX ``_ProjectionMixin``).

    Under a ``model`` mesh axis (``parallel.tensor_parallel.shard_model``)
    the projections are column- and row-parallel and one of two layouts
    holds: ``head_parallel`` (mesh, axis), ``h`` being then the rank's h /
    P heads, whose columns of the memory slots and geometry it reads too;
    or ``gathered_heads`` (mesh, axis), where the axis does not divide the
    heads: the rank's columns of q, k and v are all-gathered to whole
    heads (``_whole``), every rank attends all of them, and ``output``
    hands the row-parallel ``fc_o`` the rank's columns of the result."""

    head_parallel = None
    gathered_heads = None

    def __init__(self, config):
        super().__init__()
        self.d_model, self.h = config.D_MODEL, config.HEAD
        self.d_k, self.d_v = config.D_KEY, config.D_VALUE
        self.fc_q = XavierLinear(self.d_model, self.h * self.d_k)
        self.fc_k = XavierLinear(self.d_model, self.h * self.d_k)
        self.fc_v = XavierLinear(self.d_model, self.h * self.d_v)
        self.fc_o = XavierLinear(self.h * self.d_v, self.d_model)

    def _whole(self, x):
        """A projection's (..., columns) output on whole heads: under
        ``gathered_heads`` the ranks' columns all-gathered, else ``x``."""
        if self.gathered_heads is None:
            return x
        from openviic_tpu_torch.parallel import collectives

        return collectives.all_gather(x, *self.gathered_heads, x.dim() - 1)

    def _head_columns(self, x):
        """The rank's heads' columns (last dim) of a replicated (..., h *
        d) tensor under ``head_parallel`` (its gradient all-gathered back),
        else ``x``."""
        if self.head_parallel is None:
            return x
        from openviic_tpu_torch.parallel import collectives

        return collectives.split(x, *self.head_parallel, x.dim() - 1)

    def whole_head_cache(self, x):
        """(rows, n, h, d) K or V on every head: under ``head_parallel`` the
        ranks' heads all-gathered (the layer kernels' cross K/V), else
        ``x``."""
        if self.head_parallel is None:
            return x
        from openviic_tpu_torch.parallel import collectives

        return collectives.all_gather(x, *self.head_parallel, 2)

    def project_q(self, queries):
        bs, nq = queries.shape[:2]
        return self._whole(self.fc_q(queries)).reshape(bs, nq, self.h, self.d_k)

    def project_kv(self, x):
        """K and V of ``x`` in the promoted dtype of ``x`` and the weights
        (DLCT's cross-attentions read an f32 stream at bf16 weights)."""
        bs, n = x.shape[:2]
        k = self._whole(promoted_linear(self.fc_k, x)).reshape(bs, n, self.h, self.d_k)
        v = self._whole(promoted_linear(self.fc_v, x)).reshape(bs, n, self.h, self.d_v)
        return k, v

    def output(self, out):
        bs, nq = out.shape[:2]
        out = out.reshape(bs, nq, self.h * self.d_v)
        if self.gathered_heads is not None:
            from openviic_tpu_torch.parallel import collectives

            out = collectives.split(out, *self.gathered_heads, 2)
        return promoted_linear(self.fc_o, out)


@META_ATTENTION.register()
class ScaledDotProductAttention(_Projections):
    """Plain scaled dot-product multi-head attention kernel."""

    def forward(self, queries, keys, values, attention_mask=None, **inputs):
        """``inputs``: other attentions' per-query inputs (the adaptive
        decoder's ``language_signals``), unused here as in the JAX package."""
        q = self.project_q(queries)
        k = self._whole(self.fc_k(keys)).reshape(keys.shape[0], keys.shape[1], self.h, self.d_k)
        v = self._whole(self.fc_v(values)).reshape(values.shape[0], values.shape[1], self.h,
                                                   self.d_v)
        return self.output(_attend(q, k, v, self.d_k, attention_mask))

    def attend_cached(self, queries, k, v, attention_mask, **inputs):
        """Attention over an externally managed (cached) K/V (``inputs``
        unused, as in ``forward``)."""
        q = self.project_q(queries)
        return self.output(_attend(q, k, v, self.d_k, attention_mask))

    def project_qkv_fused(self, x):
        """One matmul for q/k/v of the same input (decode hot path), over
        their weights concatenated once and kept until a parameter is
        replaced or changed in place (data pointer and version counter)."""
        bs, n = x.shape[:2]
        params = (self.fc_q.weight, self.fc_k.weight, self.fc_v.weight,
                  self.fc_q.bias, self.fc_k.bias, self.fc_v.bias)
        key = tuple((p.data_ptr(), p._version) for p in params)
        cached = getattr(self, "_qkv_pack", None)
        if cached is None or cached[0] != key or torch.is_grad_enabled():
            weight, bias = torch.cat(params[:3]), torch.cat(params[3:])
            if not torch.is_grad_enabled():
                self._qkv_pack = (key, weight, bias)
        else:
            weight, bias = cached[1:]
        qkv = nn.functional.linear(x, weight, bias)
        q, k, v = (self._whole(c) for c in qkv.split([p.shape[0] for p in params[:3]], dim=-1))
        return (q.reshape(bs, n, self.h, self.d_k), k.reshape(bs, n, self.h, self.d_k),
                v.reshape(bs, n, self.h, self.d_v))

    def attend_projected(self, q, k, v, attention_mask):
        return self.output(_attend(q, k, v, self.d_k, attention_mask))

    def attend_projected_beam_select(self, q_t, k, v, ancestry, position_mask,
                                     mask_axis: str = "q", use_kernel: bool = False):
        """Beam-resident self-attention step over *all* beams' unreordered
        caches of the same image (einsum form; ``use_kernel`` runs
        ``ops.beam_select_attention`` instead, the CUDA kernel on a card).

        q_t: (bs*beam, 1, h, d_k); k/v: (bs*beam, L, h, d) append-only
        caches; ancestry: (bs, beam, L); position_mask: (bs*beam, 1, 1, L)
        True = masked.  Scores are taken against every slot and the true
        ancestor is kept by an ancestry mask inside the softmax.  With
        ``mask_axis='q'`` the mask is already resolved per current beam;
        with ``'p'`` it is the raw per-slot mask, applied on the slot axis
        (equivalent, since position (q, t') survives only at slot
        p = ancestry[q, t'])."""
        if use_kernel:
            out = beam_select_attention(q_t, k, v, ancestry, position_mask, mask_axis=mask_axis)
            return self.output(out)
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


@META_ATTENTION.register()
class AugmentedGeometryScaledDotProductAttention(ScaledDotProductAttention):
    """SDPA with the log-ReLU geometric bias of the Object Relation
    Transformer (JAX ``AugmentedGeometryScaledDotProductAttention``): K and
    V are both projected from ``keys``.  ``relative_geometry_weights``
    (bs, h, nq, nk) are non-negative weights whose log(clamp(g, 1e-6)) is
    added to the scores through ``_attend``; ``geometry_fused`` (``boxes``,
    the fc_g ``kernel`` (dim_g, h) and ``bias``) instead runs
    ``ops.geo_fused_attention``, which builds that bias from the boxes."""

    def forward(self, queries, keys, values, attention_mask=None,
                relative_geometry_weights=None, geometry_fused=None):
        q = self.project_q(queries)
        k, v = self.project_kv(keys)
        if geometry_fused is not None:
            out = geo_fused_attention(
                q, k, v, geometry_fused["boxes"], geometry_fused["kernel"],
                geometry_fused["bias"], attention_mask, sm_scale=1.0 / math.sqrt(self.d_k),
            ).to(queries.dtype)
            return self.output(out)
        bias = torch.log(torch.clamp_min(relative_geometry_weights, 1e-6))
        return self.output(_attend(q, k, v, self.d_k, attention_mask, bias=bias))


@META_ATTENTION.register()
class AugmentedMemoryScaledDotProductAttention(_Projections):
    """SDPA with ``MEMORY`` learnt slots appended to K and V (JAX
    ``AugmentedMemoryScaledDotProductAttention``): ``m_k`` scaled by
    sqrt(d_k) and ``m_v`` by sqrt(m), in float32, form an unmasked suffix
    of m keys.  The f32 slots make K and V f32 at any compute dtype (the
    projected rows enter exactly), as in the JAX package.  Like the JAX
    class it has no decode path: the shipped configs use it in encoders."""

    def __init__(self, config):
        super().__init__(config)
        self.m = config.MEMORY
        self.m_k = nn.Parameter(torch.empty(1, self.m, self.h * self.d_k))
        self.m_v = nn.Parameter(torch.empty(1, self.m, self.h * self.d_v))

    def reset_with(self, generator: torch.Generator) -> None:
        normal_init(self.m_k, 1.0 / self.d_k, generator)
        normal_init(self.m_v, 1.0 / self.m, generator)

    def forward(self, queries, keys, values, attention_mask=None):
        bs, nk = keys.shape[:2]

        def scaled(slots, n):  # sqrt(n) * slots, an f32 product as in JAX
            dtype = torch.promote_types(slots.dtype, torch.float32)
            root = torch.sqrt(torch.tensor(float(n), dtype=dtype, device=slots.device))
            return (root * slots.to(dtype)).expand(bs, -1, -1)
        # the rank's heads' columns of the slots, or whole heads gathered
        k = torch.cat([self._whole(self.fc_k(keys)),
                       scaled(self._head_columns(self.m_k), self.d_k)], dim=1)
        v = torch.cat([self._whole(self.fc_v(values)),
                       scaled(self._head_columns(self.m_v), self.m)], dim=1)
        k = k.reshape(bs, nk + self.m, self.h, self.d_k)
        v = v.reshape(bs, nk + self.m, self.h, self.d_v)
        if attention_mask is not None:  # the slots are never masked
            slots = attention_mask.new_zeros(attention_mask.shape[:-1] + (self.m,))
            attention_mask = torch.cat([attention_mask, slots], dim=-1)
        return self.output(_attend(self.project_q(queries), k, v, self.d_k, attention_mask))


@META_ATTENTION.register()
class AdaptiveScaledDotProductAttention(_Projections):
    """RSTNet's adaptive attention (JAX ``AdaptiveScaledDotProductAttention``):
    each query i attends to the keys and to one extra column of its own,
    whose logit is q_i . s_i / sqrt(d_k) and whose value row is s_i, with
    s = fc_s(language signals) split into heads.  K and V are both
    projected from ``keys``, as in the JAX class.  Scores, the softmax over
    nk + 1 columns and both value products run in float32; the extra
    column is never masked, so no row is fully masked."""

    def __init__(self, config):
        super().__init__(config)
        self.fc_s = XavierLinear(self.d_model, self.h * self.d_k)

    def forward(self, queries, keys, values, attention_mask=None, language_signals=None):
        k, v = self.project_kv(keys)
        return self._adaptive(queries, k, v, attention_mask, language_signals)

    def attend_cached(self, queries, k, v, attention_mask, language_signals=None):
        """The cached-K/V form: ``queries`` and ``language_signals`` are the
        current step's."""
        return self._adaptive(queries, k, v, attention_mask, language_signals)

    def _adaptive(self, queries, k, v, attention_mask, language_signals):
        bs, nq = queries.shape[:2]
        nk = k.shape[1]
        q = self.project_q(queries).float()
        s = self._whole(self.fc_s(language_signals)).reshape(bs, nq, self.h, self.d_k).float()
        scale = math.sqrt(self.d_k)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k.float()) / scale
        if attention_mask is not None:
            att = att.masked_fill(attention_mask, float("-inf"))
        lang = torch.einsum("bqhd,bqhd->bhq", q, s) / scale
        weights = torch.softmax(torch.cat([att, lang[..., None]], dim=-1), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights[..., :nk], v.float())
        out = out + weights[..., nk].transpose(1, 2)[..., None] * s
        return self.output(out.to(queries.dtype))


class MultiHeadAttention(nn.Module):
    """Attention kernel + dropout + post-LN residual, then with ``USE_AOA``
    the Attention-on-Attention gate: informative(x) * sigmoid(gated(x)) of
    x = [queries, out], two linears of fan-in 2 d_model.  ``forward`` is
    the cache-free path; ``decode_self`` and ``decode_cross`` are the two
    cached decode paths of the JAX ``__call__(cache=...)``; all three end
    in ``_finish``."""

    def __init__(self, config):
        super().__init__()
        self.use_aoa = bool(config.USE_AOA)
        if self.use_aoa:
            self.informative_attention = TorchLinear(2 * config.D_MODEL, config.D_MODEL)
            self.gated_attention = TorchLinear(2 * config.D_MODEL, config.D_MODEL)
        self.attention = build_attention(config)
        self.dropout = nn.Dropout(config.DROPOUT)
        self.layer_norm = nn.LayerNorm(config.D_MODEL, eps=1e-5)

    def _finish(self, queries, out):
        """Post-LN residual, rounded to the queries' dtype once (JAX
        ``_finish``'s ``.astype``; see ``residual_layer_norm``), then the
        AoA gate."""
        out = residual_layer_norm(self.layer_norm, queries, self.dropout(out))
        if self.use_aoa:
            x = torch.cat([queries, out], dim=-1)
            out = self.informative_attention(x) * torch.sigmoid(self.gated_attention(x))
        return out

    def forward(self, queries, keys, values, attention_mask=None, **kwargs):
        """``kwargs`` go to the attention (the geometry of the Object
        Relation Transformer: ``relative_geometry_weights`` or
        ``geometry_fused``)."""
        out = self.attention(queries, keys, values, attention_mask=attention_mask, **kwargs)
        return self._finish(queries, out)

    def decode_self(self, queries, cache: Cache, decode_index: int,
                    attention_mask, ancestry=None, beam_select=None,
                    mask_axis: str = "q", attn_kernel: bool = False, **inputs):
        """Self-attention step: write this step's projected K/V at
        ``decode_index`` (in place), then attend.  With ``beam_select`` and
        ``ancestry`` the cache is never reordered (beam-resident), and
        ``attn_kernel`` runs that attention through
        ``ops.beam_select_attention`` (SDPA only); with ``ancestry`` alone
        each read resolves its slots by gather.  Per-query ``inputs`` (the
        adaptive decoder's ``language_signals``) take the JAX package's
        general path: K/V through ``project_kv``, the attention through
        ``attend_cached``."""
        q_t = None
        if inputs or not hasattr(self.attention, "project_qkv_fused"):
            k_t, v_t = self.attention.project_kv(queries)
        else:
            q_t, k_t, v_t = self.attention.project_qkv_fused(queries)
        cache["k"][:, decode_index] = k_t[:, 0]
        cache["v"][:, decode_index] = v_t[:, 0]
        k, v = cache["k"], cache["v"]
        if beam_select is not None and ancestry is not None and q_t is not None:
            out = self.attention.attend_projected_beam_select(
                q_t, k, v, ancestry, attention_mask, mask_axis=mask_axis,
                use_kernel=attn_kernel
                and type(self.attention).__name__ == "ScaledDotProductAttention",
            )
        else:
            if ancestry is not None:
                k = _resolve_ancestry(k, ancestry)
                v = _resolve_ancestry(v, ancestry)
            if q_t is None:
                out = self.attention.attend_cached(queries, k, v, attention_mask, **inputs)
            else:
                out = self.attention.attend_projected(q_t, k, v, attention_mask)
        return self._finish(queries, out)

    def decode_cross(self, queries, cache: Cache, attention_mask, beam_select=None, **inputs):
        """Cross-attention step over K/V precomputed from the encoder memory;
        with ``beam_select`` and image-granularity K/V, beams share it
        (never with per-query ``inputs``, as in the JAX package)."""
        if (beam_select is not None and cache["k"].shape[0] != queries.shape[0]
                and not inputs):
            out = self.attention.attend_cached_grouped(
                queries, cache["k"], cache["v"], attention_mask, beam_select
            )
        else:
            out = self.attention.attend_cached(
                queries, cache["k"], cache["v"], attention_mask, **inputs
            )
        return self._finish(queries, out)

    def precompute_cache(self, memory) -> Cache:
        """Project cross-attention K/V over the encoder memory once."""
        k, v = self.attention.project_kv(memory)
        return {"k": k, "v": v}
