"""Ulysses sequence parallelism: all-to-all head-sharded attention (the
port's counterpart of ``openviic_tpu/parallel/ulysses.py``).

Activations arrive sequence-sharded (each of the P ranks of the mesh's
``seq`` axis holds n/P positions of Q, K and V).  One tiled all-to-all
(``collectives.all_to_all``, whose backward is the inverse all-to-all)
re-shards them head-wise, so that every rank holds the full sequence for
h/P of the heads; each rank runs dense attention on its heads, and a
second all-to-all restores the sequence sharding.  The bias enters as the
rank's query-row block (b, h, n/P, n) and is all-to-all'd to its head
block (b, h/P, n, n).  Ulysses needs heads % P == 0 (the ring needs only
n % P == 0); under ``ring_attention(mesh, mode="ulysses")`` calls whose
heads the axis does not divide take the ring."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from openviic_tpu_torch.parallel import collectives
from openviic_tpu_torch.parallel.ring_attention import (
    check_length,
    gather_output,
    ring_attention,
    shard_inputs,
)

#: incremented on each call of ``ulysses_self_attention``
DISPATCH_STATS = {"calls": 0}


@contextlib.contextmanager
def ulysses_attention(mesh, seq_axis: str = "seq", batch_axis: Optional[str] = None):
    """``ring_attention(mesh, seq_axis, batch_axis, mode="ulysses")``."""
    with ring_attention(mesh, seq_axis, batch_axis, mode="ulysses"):
        yield


def _safe_softmax_attend(qh, kh, vh, bias, key_mask, scale):
    """Dense f32 attention on (b, hp, n, d) head blocks; a row whose every
    key is masked gives 0, as the ring's does (JAX's
    ``_safe_softmax_attend``)."""
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if key_mask is not None:
        s = s.masked_fill(key_mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    safe_m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vh.float())
    return out / p.sum(dim=-1).clamp_min(1e-30)[..., None]


def ulysses_attention_local(q, k, v, bias, key_mask, mesh, axis: str, scale: float):
    """The per-rank body: q, k, v this rank's (b, n_local, h, d) rows, bias
    its (b, h, n_local, n) query-row block, key_mask (b, n).  Returns its
    (b, n_local, h, dv) rows in q's dtype."""
    def to_heads(x):  # (b, n_local, h, d) -> (b, h/P, n, d)
        return collectives.all_to_all(x, mesh, axis, 2, 1).transpose(1, 2)

    if bias is not None:  # (b, h, n_local, n) -> (b, h/P, n, n)
        bias = collectives.all_to_all(bias, mesh, axis, 1, 2)
    out = _safe_softmax_attend(to_heads(q), to_heads(k), to_heads(v), bias, key_mask, scale)
    out = out.transpose(1, 2).to(q.dtype)  # (b, n, h/P, dv)
    return collectives.all_to_all(out, mesh, axis, 1, 2)


def ulysses_self_attention(q, k, v, mesh, *, bias=None, key_mask=None, seq_axis: str = "seq",
                           batch_axis: Optional[str] = None, scale: Optional[float] = None):
    """Bidirectional self-attention, sequence-sharded over ``seq_axis`` and
    computed head-sharded through two all-to-alls (the DeepSpeed-Ulysses
    layout).  Arguments and result as ``ring_self_attention``'s; ``n`` and
    the head count must both divide by the ``seq_axis`` size."""
    DISPATCH_STATS["calls"] += 1
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    check_length(q.shape[1], mesh, seq_axis)
    n_shards = mesh.axis_size(seq_axis)
    if q.shape[2] % n_shards != 0:
        raise ValueError(f"head count {q.shape[2]} not divisible by mesh axis '{seq_axis}' of "
                         f"size {n_shards} (use the ring layout)")
    q, k, v, bias, key_mask = shard_inputs(q, k, v, bias, key_mask, mesh, seq_axis,
                                           batch_axis)
    out = ulysses_attention_local(q, k, v, bias, key_mask, mesh, seq_axis, scale)
    return gather_output(out, mesh, seq_axis, batch_axis)
