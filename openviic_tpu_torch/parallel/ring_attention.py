"""Sequence-parallel ring attention over a mesh axis (the port's counterpart
of ``openviic_tpu/parallel/ring_attention.py``).

The sequence axis is sharded over the mesh's ``seq`` axis: every rank keeps
its Q rows and the K/V blocks rotate around the ring (``collectives.
ring_shift``, whose backward is the reverse shift), P steps for P ranks,
each step contracting the local Q block against one visiting K/V block
under an f32 online softmax (running max and sum, JAX's ``-inf`` guards).
A rank holds (n_local x n_local) scores a step, never (n x n).

An additive bias (the ORT/DLCT geometric bias) enters as the rank's query
row block (b, h, n_local, n), and the key columns of the visiting block are
sliced from it each step, as is the key mask, so the quadratic bias never
exists in full on a rank's attention.

``ring_self_attention`` takes and returns full-sequence (and, with a
``batch_axis``, full-batch) tensors, as the JAX call sees global arrays:
it slices the rank's shard (``collectives.split``), runs the per-rank body
and all-gathers the output; its gradient flows through all of it."""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch

from openviic_tpu_torch.parallel import collectives


class RingContext(NamedTuple):
    mesh: object
    seq_axis: str
    batch_axis: Optional[str]
    #: "ring" (the K/V ring) or "ulysses" (all-to-all head sharding,
    #: parallel/ulysses.py): which sequence-parallel layout to dispatch to
    mode: str = "ring"


_RING_CTX: contextvars.ContextVar[Optional[RingContext]] = contextvars.ContextVar(
    "openviic_torch_ring_attention_ctx", default=None
)


def current_ring_context() -> Optional[RingContext]:
    return _RING_CTX.get()


#: incremented on each call of ``ring_self_attention``
DISPATCH_STATS = {"calls": 0}


@contextlib.contextmanager
def ring_attention(mesh, seq_axis: str = "seq", batch_axis: Optional[str] = None,
                   mode: str = "ring"):
    """Route eligible encoder self-attention through a sequence-parallel
    layout.

    Inside this context the models' ``_attend`` (models/attention.py)
    dispatches bidirectional self-attention (nq == nk, a mask without a
    query or head axis, a length that the axis divides) to
    ``ring_self_attention`` (or, with ``mode="ulysses"``, to
    ``parallel.ulysses.ulysses_self_attention`` where the axis divides the
    heads, else the ring) over ``mesh``'s ``seq_axis``, so every encoder
    (the geometric-bias ORT and DLCT ones too) runs sequence-parallel
    without touching model code:

        with ring_attention(mesh, "seq"):
            memory, mask = model.encoder_forward(batch)

    Decoder attention (causal masks, cached K/V) is unaffected.  The
    context is read at each call, so, unlike JAX's (read when a function
    is traced, and not part of the jit cache's key), it holds for every
    call made inside it and for none made outside."""
    if mode not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel mode {mode!r}")
    token = _RING_CTX.set(RingContext(mesh, seq_axis, batch_axis, mode))
    try:
        yield
    finally:
        _RING_CTX.reset(token)


def ring_attention_local(q, k, v, bias, key_mask, mesh, axis: str, scale: float):
    """The per-rank body (JAX's ``_ring_attention_local``).

    q, k, v: this rank's (b, n_local, h, d) rows; bias: its (b, h, n_local,
    n) query-row block or None; key_mask: (b, n) bool, True = masked, or
    None.  It reads no other rank's rows: the other K/V blocks arrive
    through the ring.  Returns (b, n_local, h, dv) in q's dtype; a row whose
    every key is masked gives 0."""
    n_devices, my_index = mesh.axis_size(axis), mesh.index(axis)
    b, n_local, h, d = q.shape
    dv = v.shape[-1]
    qh = q.transpose(1, 2).float()  # (b, h, n_local, d)
    m = torch.full((b, h, n_local), float("-inf"), device=q.device)  # running max
    l = torch.zeros((b, h, n_local), device=q.device)  # running sum
    acc = torch.zeros((b, h, n_local, dv), device=q.device)
    kv = torch.cat([k, v.to(k.dtype)], dim=-1)  # one message a step
    for step in range(n_devices):
        # after `step` rotations this rank holds the block of rank (i - step)
        src = (my_index - step) % n_devices
        kh = kv[..., :d].transpose(1, 2).float()
        vh = kv[..., d:].transpose(1, 2).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        if bias is not None:
            s = s + bias[..., src * n_local:(src + 1) * n_local].float()
        if key_mask is not None:
            cols = key_mask[:, src * n_local:(src + 1) * n_local]
            s = s.masked_fill(cols[:, None, None, :], float("-inf"))
        # the online softmax update (the flash recurrence)
        new_m = torch.maximum(m, s.amax(dim=-1))
        # rows masked so far: keep exp well defined
        safe_m = torch.where(torch.isneginf(new_m), torch.zeros_like(new_m), new_m)
        p = torch.exp(s - safe_m[..., None])
        p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
        correction = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - safe_m))
        l = l * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vh)
        m = new_m
        if step + 1 < n_devices:  # JAX's last rotation returns the blocks home unread
            kv = collectives.ring_shift(kv, mesh, axis)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def check_length(n: int, mesh, seq_axis: str) -> None:
    n_shards = mesh.axis_size(seq_axis)
    if n % n_shards != 0:
        raise ValueError(f"sequence length {n} not divisible by mesh axis '{seq_axis}' of size "
                         f"{n_shards}")


def shard_inputs(q, k, v, bias, key_mask, mesh, seq_axis: str, batch_axis: Optional[str]):
    """This rank's rows of the global q, k, v (its sequence block and, with
    ``batch_axis``, its batch rows), the bias's query-row block and the key
    mask's batch rows."""
    def rows(x, dim):
        x = collectives.split(x, mesh, seq_axis, dim)
        return x if batch_axis is None else collectives.split(x, mesh, batch_axis, 0)

    q, k, v = rows(q, 1), rows(k, 1), rows(v, 1)
    if bias is not None:
        bias = rows(bias, 2)
    if key_mask is not None and batch_axis is not None:
        key_mask = collectives.split(key_mask, mesh, batch_axis, 0)
    return q, k, v, bias, key_mask


def gather_output(out, mesh, seq_axis: str, batch_axis: Optional[str]):
    """The global output from each rank's (b_local, n_local, h, dv) rows."""
    out = collectives.all_gather(out, mesh, seq_axis, 1)
    return out if batch_axis is None else collectives.all_gather(out, mesh, batch_axis, 0)


def ring_self_attention(q, k, v, mesh, *, bias=None, key_mask=None, seq_axis: str = "seq",
                        batch_axis: Optional[str] = None, scale: Optional[float] = None):
    """Bidirectional self-attention, sequence-sharded over ``seq_axis``.

    q, k, v: (batch, n, heads, head_dim), ``n`` divisible by the
    ``seq_axis`` size; ``mesh`` holds ``seq_axis`` (and ``batch_axis`` for
    data and sequence parallelism together); ``bias``: an additive
    (batch, heads, n, n) bias, sharded on the query axis; ``key_mask``:
    (batch, n) bool, True = masked key; ``scale``: 1/sqrt(head_dim) by
    default.  Returns (batch, n, heads, head_dim_v), accumulated in f32,
    in q's dtype."""
    DISPATCH_STATS["calls"] += 1
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    check_length(q.shape[1], mesh, seq_axis)
    q, k, v, bias, key_mask = shard_inputs(q, k, v, bias, key_mask, mesh, seq_axis,
                                           batch_axis)
    out = ring_attention_local(q, k, v, bias, key_mask, mesh, seq_axis, scale)
    return gather_output(out, mesh, seq_axis, batch_axis)
