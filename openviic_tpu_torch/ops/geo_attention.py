"""Object Relation Transformer attention with the geometric bias built in
the kernel from the boxes.

Replaces the Pallas kernel ``openviic_tpu/ops/geo_attention.py::
geo_fused_attention`` with the hand-written CUDA kernel
``csrc/geo_attention.cu`` (the bound and the design are described there).
For q, k, v (bs, n, h, dk), boxes (bs, n, 4) as (x_min, y_min, x_max,
y_max), the ``fc_g`` kernel (dim_g, h) and bias (h,), a padding mask
(bs, 1, 1, n) (True = masked) and ``sm_scale``, it returns the attention
(bs, n, h, dk) in q's dtype with the per-head bias
``log(max(relu(fc_g(box_relational_embedding(boxes))), 1e-6))``, never
materialising the (bs, h, n, n) bias or the (bs, n, n, dim_g) embedding.

Rounding points are the JAX kernel's: the geometry rows (centres, log
sizes) are computed in the boxes' dtype and widened to f32; q/k/v are bf16
operands; geometry and scores are f32; the softmax is normalised in f32,
then rounded to bf16 for the PV product, which accumulates in f32.

``geo_fused_attention`` dispatches on the tensors' device: on the CPU it
runs ``geo_fused_attention_reference``, the plain PyTorch version; on a
CUDA device it launches the kernel or raises.
``geo_fused_attention.launches`` counts kernel launches.
``OPENVIIC_GEO_FUSED`` (read by ``geo_fused_enabled`` at call time, with the
JAX package's values) switches ``GeometricEncoder`` onto it."""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from openviic_tpu_torch.ops import cuda_build

NEG = -1e30  # the JAX kernels' additive mask
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100


def geo_fused_enabled() -> bool:
    """``OPENVIIC_GEO_FUSED`` is 1 or true (the JAX package's test)."""
    return os.environ.get("OPENVIIC_GEO_FUSED", "") in ("1", "true")


def _operands(boxes, fc_g_kernel, fc_g_bias, padding_mask, wave_len: float):
    """The kernel's f32 side inputs: geometry rows (bs, 4, n) (centre x,
    centre y, log(w + 1), log(h + 1), computed in the boxes' dtype), the
    mask (bs, n), the fc_g kernel's sin and cos halves flattened (s, f,
    h)-major, its bias, and the frequencies omega_f = 100 / wave_len**(f /
    (dim_g / 8))."""
    bs, n = boxes.shape[:2]
    dim_g = fc_g_kernel.shape[0]
    n_freq = dim_g // 8
    x_min, y_min, x_max, y_max = boxes.unbind(-1)
    geo = torch.stack([(x_min + x_max) * 0.5, (y_min + y_max) * 0.5,
                       torch.log((x_max - x_min) + 1.0), torch.log((y_max - y_min) + 1.0)],
                      dim=1).float().contiguous()
    mask = padding_mask.reshape(bs, n).float().contiguous()
    wsin = fc_g_kernel[: dim_g // 2].reshape(-1).float().contiguous()
    wcos = fc_g_kernel[dim_g // 2 :].reshape(-1).float().contiguous()
    omega = _frequencies(n_freq, float(wave_len), boxes.device)
    return geo, mask, wsin, wcos, fc_g_bias.float().contiguous(), omega


@functools.lru_cache(maxsize=None)
def _frequencies(n_freq: int, wave_len: float, device: torch.device) -> torch.Tensor:
    """omega_f = 100 / wave_len**(f / n_freq) in f32, made once per device:
    a host-to-device copy on every call would keep the call out of a CUDA
    graph.  Never written to."""
    return torch.tensor([100.0 / (wave_len ** (f / n_freq)) for f in range(n_freq)],
                        dtype=torch.float32, device=device)


def geo_fused_attention_reference(q, k, v, boxes, fc_g_kernel, fc_g_bias, padding_mask,
                                  sm_scale: float, wave_len: float = 1000.0):
    """Plain PyTorch version, with the JAX kernel's rounding points."""
    bs, n, h, dk = q.shape
    dim_g = fc_g_kernel.shape[0]
    n_freq = dim_g // 8
    geo, mask, wsin, wcos, fbias, omega = _operands(
        boxes, fc_g_kernel, fc_g_bias, padding_mask, wave_len)
    cx, cy, lw, lh = geo.unbind(1)  # each (bs, n)
    wq, hq = lw.exp(), lh.exp()
    disp = [
        torch.log(torch.clamp_min(((cx[:, :, None] - cx[:, None, :]) / wq[:, :, None]).abs(), 1e-3)),
        torch.log(torch.clamp_min(((cy[:, :, None] - cy[:, None, :]) / hq[:, :, None]).abs(), 1e-3)),
        lw[:, :, None] - lw[:, None, :],
        lh[:, :, None] - lh[:, None, :],
    ]
    wsin, wcos = wsin.reshape(4, n_freq, h), wcos.reshape(4, n_freq, h)
    acc = torch.zeros((bs, n, n, h), dtype=torch.float32, device=q.device)
    for s in range(4):
        for f in range(n_freq):
            m = (disp[s] * omega[f])[..., None]
            acc = acc + wsin[s, f] * torch.sin(m) + wcos[s, f] * torch.cos(m)
    bias = torch.log(torch.clamp_min(torch.relu(acc + fbias), 1e-6)).permute(0, 3, 1, 2)
    qb, kb, vb = (t.to(torch.bfloat16).float() for t in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * sm_scale
    scores = scores + bias + mask[:, None, None, :] * NEG
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, vb).to(q.dtype)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("geo_attention")
        fn = lib.openviic_geo_attention
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _smem_bytes(n: int, h: int, dk: int, n_freq: int) -> int:
    """Shared memory of one block, as csrc/geo_attention.cu's smem_bytes
    counts it: the bias planes of an 8-query tile for every head, one
    head's K and V, and small rows (a launch that asks for more than the
    card gives is refused and raises too)."""
    return 4 * (h * 8 * n + n * (dk + 1) + n * dk + 8 * dk + 8 * n + 5 * n
                + 8 * n_freq * h + h + n_freq)


def _check(q, k, v, boxes, fc_g_kernel, fc_g_bias, padding_mask) -> None:
    """What the kernel takes: q, k, v (bs, n, h, dk) of one dtype (f32 or
    bf16; they are rounded to bf16) with h <= 16, boxes (bs, n, 4), fc_g
    (dim_g, h) with dim_g % 8 == 0, bias (h,), mask (bs, 1, 1, n), a shared
    memory need within one block's, all on one CUDA device (checked last)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v (bs, n, h, dk) of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bs, n, h, dk = q.shape
    dim_g = fc_g_kernel.shape[0] if fc_g_kernel.dim() == 2 else -1
    if (boxes.shape != (bs, n, 4) or fc_g_kernel.shape != (dim_g, h) or dim_g % 8 or dim_g < 8
            or fc_g_bias.shape != (h,) or padding_mask.shape != (bs, 1, 1, n)):
        raise ValueError(f"inconsistent shapes: q {tuple(q.shape)}, boxes {tuple(boxes.shape)}, "
                         f"fc_g {tuple(fc_g_kernel.shape)}, bias {tuple(fc_g_bias.shape)}, "
                         f"mask {tuple(padding_mask.shape)} (dim_g a multiple of 8)")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"geo_fused_attention kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= h <= 16 or n < 1 or dk < 1:
        raise ValueError(f"geo_fused_attention kernel takes 1 <= h <= 16, got h={h}")
    smem = _smem_bytes(n, h, dk, dim_g // 8)
    if smem > SMEM_LIMIT:
        raise ValueError(f"geo_fused_attention kernel needs {smem} bytes of shared memory at "
                         f"n={n}, h={h}, dk={dk}, more than a block's {SMEM_LIMIT}")
    if -(-n // 8) >= 2**16 or bs >= 2**31:
        raise ValueError(f"geo_fused_attention kernel grid too large for bs={bs}, n={n}")
    tensors = (q, k, v, boxes, fc_g_kernel, fc_g_bias, padding_mask)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("geo_fused_attention takes all-cpu or same-device cuda tensors, got "
                         f"{[str(t.device) for t in tensors]}")


def geo_fused_attention(q, k, v, boxes, fc_g_kernel, fc_g_bias, padding_mask,
                        sm_scale: float, wave_len: float = 1000.0):
    """Geometry-biased attention; see the module docstring."""
    tensors = (q, k, v, boxes, fc_g_kernel, fc_g_bias, padding_mask)
    if all(t.device.type == "cpu" for t in tensors):
        return geo_fused_attention_reference(q, k, v, boxes, fc_g_kernel, fc_g_bias,
                                             padding_mask, sm_scale, wave_len)
    _check(*tensors)
    bs, n, h, dk = q.shape
    geo, mask, wsin, wcos, fbias, omega = _operands(
        boxes, fc_g_kernel, fc_g_bias, padding_mask, wave_len)
    qb, kb, vb = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
    out = torch.empty((bs, n, h, dk), dtype=q.dtype, device=q.device)
    err = _library().openviic_geo_attention(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), geo.data_ptr(), mask.data_ptr(),
        wsin.data_ptr(), wcos.data_ptr(), fbias.data_ptr(), omega.data_ptr(), out.data_ptr(),
        bs, n, h, dk, omega.numel(), float(sm_scale), int(q.dtype == torch.bfloat16),
        cuda_build.current_stream(q.device),
    )
    cuda_build.check_launch("geo_fused_attention", err)
    geo_fused_attention.launches += 1
    return out


geo_fused_attention.launches = 0
