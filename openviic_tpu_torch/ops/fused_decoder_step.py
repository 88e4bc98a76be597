"""Non-resident decoder-layer decode step as one kernel.

Replaces the Pallas kernel
``openviic_tpu/ops/fused_decoder_step.py::fused_layer_step`` with the
hand-written CUDA kernel ``csrc/layer_step.cu`` (non-resident instance; the
bound and the design are described there).  One call runs a whole decoder
layer for this step on the default (physically reordered) decode path:
the QKV projection, the write of this step's K/V into row t of the caches,
self-attention over the caches, cross-attention over per-row K/V, the FFN
and the three post-LNs.  The decoder zeroes <pad> rows itself afterwards.

It writes row t of ``k_cache`` and ``v_cache`` IN PLACE (rounded to the
caches' dtype) and returns ``(y, k_cache, v_cache)``, the caches being the
same tensors it was given.  Numerics are the JAX kernel's, in f32: f32
activations times the (bf16-valued, on the card) weights accumulated in
f32, this step's K/V used unrounded at position t, -1e30 additive masks and
a ``max(sum, 1e-30)`` softmax guard, so a fully masked row is uniform and
never NaN.

Enabled with ``OPENVIIC_FUSED_STEP=1`` (read at call time, as in the JAX
package).  ``fused_layer_step`` dispatches on the tensors' device: on the
CPU it runs ``fused_layer_step_reference``, the plain PyTorch version; on a
CUDA device it launches the kernel or raises.  ``fused_layer_step
.launches`` counts kernel launches."""

from __future__ import annotations

import os
from typing import Dict

import torch

from openviic_tpu_torch.ops import layer_step
from openviic_tpu_torch.ops.layer_step import NEG, head_sums, layer_norm, per_column


def fused_step_enabled() -> bool:
    return os.environ.get("OPENVIIC_FUSED_STEP", "") in ("1", "true")


def _attend(q, kv_k, kv_v, mask, n_heads: int, scale: float):
    """The JAX kernel's ``_attend_block``: q (B, D), kv (B, S, D) f32, mask
    (B, S) True = masked -> (B, D)."""
    scores = head_sums(kv_k * q[:, None, :], n_heads) * scale  # (B, S, h)
    scores = scores + mask.float()[:, :, None] * NEG
    p = torch.exp(scores - scores.amax(dim=1, keepdim=True))
    p = p / torch.clamp_min(p.sum(dim=1, keepdim=True), 1e-30)
    return (kv_v * per_column(p, n_heads, q.shape[1])).sum(dim=1)


def fused_layer_step_reference(x, k_cache, v_cache, cross_k, cross_v, self_mask, cross_mask,
                               t: int, weights: Dict[str, torch.Tensor], n_heads: int):
    """Plain PyTorch version, f32 throughout; writes row t of the caches in
    place."""
    D = x.shape[1]
    w = {key: value.float() for key, value in weights.items()}
    scale = 1.0 / (D // n_heads) ** 0.5
    x32 = x.float()
    qkv = x32 @ w["wqkv"] + w["bqkv"]
    q, k_new, v_new = qkv[:, :D], qkv[:, D : 2 * D], qkv[:, 2 * D :]
    kc, vc = k_cache.float(), v_cache.float()
    kc[:, t], vc[:, t] = k_new, v_new  # this step's K/V enter unrounded
    k_cache[:, t] = k_new.to(k_cache.dtype)
    v_cache[:, t] = v_new.to(v_cache.dtype)

    self_out = _attend(q, kc, vc, self_mask, n_heads, scale) @ w["wo"] + w["bo"]
    x1 = layer_norm(x32 + self_out, w["ln1s"], w["ln1b"])
    q2 = x1 @ w["wqc"] + w["bqc"]
    cross = _attend(q2, cross_k.float(), cross_v.float(), cross_mask, n_heads, scale)
    x2 = layer_norm(x1 + (cross @ w["woc"] + w["boc"]), w["ln2s"], w["ln2b"])
    hid = torch.relu(x2 @ w["w1"] + w["b1"])
    x3 = layer_norm(x2 + (hid @ w["w2"] + w["b2"]), w["ln3s"], w["ln3b"])
    return x3.to(x.dtype), k_cache, v_cache


def fused_layer_step(x, k_cache, v_cache, cross_k, cross_v, self_mask, cross_mask, t: int,
                     weights: Dict[str, torch.Tensor], n_heads: int):
    """One non-resident decoder-layer step; see the module docstring.

    x (N, D); k_cache/v_cache (N, L, D), row t written in place;
    cross_k/cross_v (N, M, D); self_mask (N, L) and cross_mask (N, M) bool,
    True = masked.  Returns (y (N, D), k_cache, v_cache)."""
    tensors = dict(x=x, k_cache=k_cache, v_cache=v_cache, cross_k=cross_k, cross_v=cross_v,
                   self_mask=self_mask, cross_mask=cross_mask)
    if all(v.device.type == "cpu" for v in list(tensors.values()) + list(weights.values())):
        return fused_layer_step_reference(x, k_cache, v_cache, cross_k, cross_v, self_mask,
                                          cross_mask, t, weights, n_heads)
    if x.dim() != 2 or k_cache.dim() != 3 or cross_k.dim() != 3:
        raise ValueError(f"fused_layer_step: expected x (N,D), caches (N,L,D), cross (N,M,D); "
                         f"got {tuple(x.shape)}, {tuple(k_cache.shape)}, {tuple(cross_k.shape)}")
    N, D = x.shape
    L, M = k_cache.shape[1], cross_k.shape[1]
    shapes = {
        "k_cache": (tuple(k_cache.shape), (N, L, D)),
        "v_cache": (tuple(v_cache.shape), (N, L, D)),
        "cross_k": (tuple(cross_k.shape), (N, M, D)),
        "cross_v": (tuple(cross_v.shape), (N, M, D)),
        "self_mask": (tuple(self_mask.shape), (N, L)),
        "cross_mask": (tuple(cross_mask.shape), (N, M)),
    }
    bad = {k: got for k, (got, want) in shapes.items() if got != want}
    if bad:
        raise ValueError(f"fused_layer_step: inconsistent shapes {bad}")
    F = weights["w1"].shape[1]
    layer_step.check_cuda("fused_layer_step", tensors, weights, D, F, n_heads)
    y = torch.empty((N, D), dtype=x.dtype, device=x.device)
    ptrs = [x.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cross_k.data_ptr(),
            cross_v.data_ptr(), None, self_mask.data_ptr(), cross_mask.data_ptr(), None,
            *layer_step.weight_ptrs(weights), y.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr()]
    layer_step.launch("fused_layer_step", False, ptrs, N, L, M, D, F, n_heads, 1, int(t),
                      x.device)
    fused_layer_step.launches += 1
    return y, k_cache, v_cache


fused_layer_step.launches = 0
