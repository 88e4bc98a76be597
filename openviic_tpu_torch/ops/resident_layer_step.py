"""Beam-resident decoder-layer decode step as one kernel.

Replaces the Pallas kernel
``openviic_tpu/ops/resident_layer_step.py::resident_layer_step`` with the
hand-written CUDA kernel ``csrc/layer_step.cu`` (beam-resident instance;
the bound and the design are described there).  One call runs a whole
decoder layer for this step: the fused QKV projection, self-attention over
the never-reordered caches resolved through the ancestry table with this
step's K/V as an extra column (the cache's own column t is stale and
masked), cross-attention over K/V kept at image granularity (row n reads
image n // beam), the FFN and the three post-LNs; the output is zeroed
where the input token is <pad>.  It returns (y, k_new, v_new); the caller
appends k_new/v_new to the caches at t.

Numerics are the JAX kernel's: each product rounds both operands to bf16
and accumulates in f32 (``_mm``; that includes the softmax weights before
PV), the q.k element products round through bf16, this step's v_new enters
PV unrounded, and masks are additive -1e30.

``resident_layer_step`` dispatches on the tensors' device: on the CPU it
runs ``resident_layer_step_reference``, the plain PyTorch version; on a
CUDA device it launches the kernel or raises.  ``resident_layer_step
.launches`` counts kernel launches."""

from __future__ import annotations

from typing import Dict

import torch

from openviic_tpu_torch.ops import layer_step, refuse_grad
from openviic_tpu_torch.ops.beam_select_attention import ancestor_rows
from openviic_tpu_torch.ops.layer_step import NEG, head_sums, layer_norm, per_column


def _bf(a: torch.Tensor) -> torch.Tensor:
    """Round through bf16, back to f32."""
    return a.to(torch.bfloat16).float()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The JAX kernel's ``_mm``: bf16 operands, f32 accumulation."""
    return _bf(a) @ _bf(b)


def resident_layer_step_reference(x, k_cache, v_cache, cross_k, cross_v, ancestry, self_mask,
                                  cross_mask, is_pad, t: int, weights: Dict[str, torch.Tensor],
                                  n_heads: int):
    """Plain PyTorch version, with the JAX kernel's rounding points."""
    squeeze = x.dim() == 3
    x2 = x[:, 0, :] if squeeze else x
    N, D = x2.shape
    IMG, beam, L = ancestry.shape
    M = cross_k.shape[1]
    h, w = n_heads, weights
    scale = 1.0 / (D // h) ** 0.5
    pad = is_pad.reshape(N).float()

    def cols(a):  # (..., h) -> (..., D)
        return per_column(a, h, D)

    x32 = x2.float()
    qkv = _mm(x32, w["wqkv"]) + w["bqkv"].float()
    q, k_new, v_new = qkv[:, :D], qkv[:, D : 2 * D], qkv[:, 2 * D :]
    qs = _bf(q * scale)

    # self-attention: this step's column, then the cache resolved by ancestry
    s_new = head_sums(_bf(qs * _bf(k_new)), h) + pad[:, None] * NEG  # (N, h)
    src = ancestor_rows(ancestry)
    pos = torch.arange(L, device=x.device)
    rk = k_cache.reshape(N, L, D)[src, pos].float()  # (N, L, D)
    rv = v_cache.reshape(N, L, D)[src, pos].float()
    s = head_sums(_bf(rk * qs[:, None]), h)  # (N, L, h)
    dead = self_mask.reshape(N, L)[src, pos] | (pos == t)  # column t is stale
    s = s + dead[..., None].float() * NEG
    m = torch.maximum(s_new, s.amax(dim=1))
    e_new = torch.exp(s_new - m)
    e = torch.exp(s - m[:, None])
    denom = e_new + e.sum(dim=1)
    acc = cols(_bf(e_new)) * v_new + (cols(_bf(e)) * rv).sum(dim=1)
    self_out = _mm(acc / cols(denom), w["wo"]) + w["bo"].float()
    x32 = layer_norm(x32 + self_out, w["ln1s"], w["ln1b"])

    # cross-attention, K/V at image granularity
    img = torch.arange(N, device=x.device) // beam
    ck = cross_k.reshape(IMG, M, D)[img].float()
    cv = cross_v.reshape(IMG, M, D)[img].float()
    q2s = _bf((_mm(x32, w["wqc"]) + w["bqc"].float()) * scale)
    s2 = head_sums(_bf(ck * q2s[:, None]), h)  # (N, M, h)
    s2 = s2 + cross_mask.reshape(IMG, M)[img][..., None].float() * NEG
    m2 = torch.clamp_min(s2.amax(dim=1), NEG)
    e2 = torch.exp(s2 - m2[:, None])
    acc2 = (cols(_bf(e2)) * cv).sum(dim=1)
    cross_out = _mm(acc2 / cols(e2.sum(dim=1)), w["woc"]) + w["boc"].float()
    x32 = layer_norm(x32 + cross_out, w["ln2s"], w["ln2b"])

    hid = torch.relu(_mm(x32, w["w1"]) + w["b1"].float())
    x32 = layer_norm(x32 + (_mm(hid, w["w2"]) + w["b2"].float()), w["ln3s"], w["ln3b"])
    y = (x32 * (1.0 - pad[:, None])).to(x.dtype)
    d = D // h
    return (y[:, None] if squeeze else y, k_new.to(x.dtype).reshape(N, h, d),
            v_new.to(x.dtype).reshape(N, h, d))


def resident_layer_step(x, k_cache, v_cache, cross_k, cross_v, ancestry, self_mask,
                        cross_mask, is_pad, t: int, weights: Dict[str, torch.Tensor],
                        n_heads: int):
    """One beam-resident decoder-layer step; see the module docstring.

    x (N, 1, D) or (N, D); k_cache/v_cache (N, L, h, d); cross_k/cross_v
    (IMG, M, h, d); ancestry (IMG, beam, L) local slots; self_mask
    (N, 1, 1, L) the raw per-slot mask (True = masked); cross_mask
    (IMG, 1, 1, M); is_pad (N, 1) bool; t the step.  Returns
    (y shaped like x, k_new (N, h, d), v_new (N, h, d)).  The kernel trusts
    ``0 <= ancestry < beam``, as the decode guarantees."""
    tensors = dict(x=x, k_cache=k_cache, v_cache=v_cache, cross_k=cross_k, cross_v=cross_v,
                   ancestry=ancestry, self_mask=self_mask, cross_mask=cross_mask, is_pad=is_pad)
    refuse_grad("resident_layer_step", tensors, weights)
    if all(v.device.type == "cpu" for v in list(tensors.values()) + list(weights.values())):
        return resident_layer_step_reference(x, k_cache, v_cache, cross_k, cross_v, ancestry,
                                             self_mask, cross_mask, is_pad, t, weights, n_heads)
    squeeze = x.dim() == 3
    x2 = x[:, 0, :] if squeeze else x
    if x2.dim() != 2 or ancestry.dim() != 3 or k_cache.dim() != 4 or cross_k.dim() != 4:
        raise ValueError(f"resident_layer_step: expected x (N,[1,]D), caches (N,L,h,d), cross "
                         f"(IMG,M,h,d), ancestry (IMG,beam,L); got {tuple(x.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(cross_k.shape)}, {tuple(ancestry.shape)}")
    N, D = x2.shape
    IMG, beam, L = ancestry.shape
    M = cross_k.shape[1]
    d = D // n_heads if n_heads > 0 else 0
    shapes = {
        "x": (tuple(x.shape), (N, 1, D) if squeeze else (N, D)),
        "k_cache": (tuple(k_cache.shape), (N, L, n_heads, d)),
        "v_cache": (tuple(v_cache.shape), (N, L, n_heads, d)),
        "cross_k": (tuple(cross_k.shape), (IMG, M, n_heads, d)),
        "cross_v": (tuple(cross_v.shape), (IMG, M, n_heads, d)),
        "self_mask": (tuple(self_mask.shape), (N, 1, 1, L)),
        "cross_mask": (tuple(cross_mask.shape), (IMG, 1, 1, M)),
        "is_pad": (tuple(is_pad.shape), (N, 1)),
    }
    bad = {k: got for k, (got, want) in shapes.items() if got != want}
    if bad or N != IMG * beam:
        raise ValueError(f"resident_layer_step: inconsistent shapes {bad or shapes}")
    F = weights["w1"].shape[1]
    layer_step.check_cuda("resident_layer_step", dict(tensors, x=x2), weights, D, F, n_heads)
    y = torch.empty((N, D), dtype=x.dtype, device=x.device)
    k_new = torch.empty_like(y)
    v_new = torch.empty_like(y)
    ptrs = [x2.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cross_k.data_ptr(),
            cross_v.data_ptr(), ancestry.data_ptr(), self_mask.data_ptr(),
            cross_mask.data_ptr(), is_pad.data_ptr(), *layer_step.weight_ptrs(weights),
            y.data_ptr(), k_new.data_ptr(), v_new.data_ptr()]
    layer_step.launch("resident_layer_step", True, ptrs, N, L, M, D, F, n_heads, beam, int(t),
                      x.device)
    resident_layer_step.launches += 1
    return (y[:, None] if squeeze else y, k_new.reshape(N, n_heads, d),
            v_new.reshape(N, n_heads, d))


resident_layer_step.launches = 0
