"""Object Relation Transformer attention with the geometric bias built in
the kernel from the boxes.

Replaces the Pallas kernel ``openviic_tpu/ops/geo_attention.py::
geo_fused_attention`` with the hand-written CUDA kernels of
``csrc/geo_attention.cu`` (the bound and the designs are described there):
the MMA kernel (one block per image at caption sizes, Q K^T and P V on the
tensor cores) for d_k = 64 and n up to 128 within one block's shared
memory, and the SIMT kernel for the other shapes (``kernel_route`` says
which).  For q, k, v (bs, n, h, dk), boxes (bs, n, 4) as (x_min, y_min, x_max,
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
CUDA device it launches a kernel or raises.
``geo_fused_attention.launches`` counts kernel launches.
``OPENVIIC_GEO_FUSED`` (read by ``geo_fused_enabled`` at call time, with the
JAX package's values) switches ``GeometricEncoder`` onto it."""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from openviic_tpu_torch.ops import cuda_build, refuse_grad

NEG = -1e30  # the JAX kernels' additive mask
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100
MMA_HEAD_DIM, MMA_MAX_N = 64, 128  # the shapes the MMA kernel takes
# the side inputs' dtypes the kernels read (csrc/geo_attention.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                                     ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.openviic_geo_attention_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.openviic_geo_attention_occupancy.restype = ctypes.c_int
        _lib = lib
    return _lib


def occupancy(bs: int, n: int, h: int, n_freq: int):
    """How the MMA kernel runs on the current card at bs images of n boxes,
    h heads and n_freq frequencies: CTAs per SM, threads per CTA,
    registers and local (spill) bytes per thread, shared bytes per CTA,
    16-row slabs per phase, and the grid (one persistent block per SM)."""
    out = (ctypes.c_int * 7)()
    err = _library().openviic_geo_attention_occupancy(bs, n, h, n_freq, out)
    cuda_build.check_launch("geo_fused_attention occupancy", err)
    keys = ("ctas_per_sm", "threads", "registers", "local_bytes", "smem_bytes",
            "slabs_per_phase", "grid")
    return dict(zip(keys, list(out)))


def _side_floats(n: int, hp: int, n_freq: int) -> int:
    """Floats of the side inputs in shared memory, as csrc/geo_attention.cu's
    side_floats counts them: the sin and cos halves of fc_g and its bias,
    ``hp`` heads to a row, the frequencies, and four geometry rows and the
    mask term per box."""
    return 8 * n_freq * hp + hp + n_freq + 5 * n


def _mma_smem_bytes(n: int, h: int, n_freq: int) -> int:
    """Shared memory of one block of the MMA kernel (csrc/geo_attention.cu
    mma::smem_bytes): K and V of every head for n keys rounded up to 16 and
    one 16-row slab of Q, bf16, each row 16 bytes wider than h * 64; the
    slab's f32 bias planes, rows n floats wide rounded up to 8 mod 16; and
    the side inputs, the weights' rows padded to 8 or 16 heads."""
    pitch, nkp = h * MMA_HEAD_DIM + 8, -(-n // 16) * 16
    nkb = n + (8 - n % 16) % 16
    hp = 8 if h <= 8 else 16
    return 2 * (2 * nkp + 16) * pitch + 4 * (h * 16 * nkb + _side_floats(n, hp, n_freq))


def _smem_bytes(n: int, h: int, dk: int, n_freq: int) -> int:
    """Shared memory of one block of the SIMT kernel, as csrc/geo_attention.cu
    simt::smem_bytes counts it: the bias planes of an 8-query tile for
    every head, one head's K and V in f32, and small rows (a launch that
    asks for more than the card gives is refused and raises too)."""
    return 4 * (h * 8 * n + n * (dk + 1) + n * dk + 8 * dk + 8 * n + _side_floats(n, h, n_freq))


def kernel_route(q, k, v, n_freq: int) -> int:
    """Which CUDA kernel takes these bf16 operands: 1, the MMA kernel (d_k
    = 64, n <= 128, 16-byte aligned q, k, v, within one block's shared
    memory); 0, the SIMT kernel."""
    _, n, h, dk = q.shape
    if (dk == MMA_HEAD_DIM and n <= MMA_MAX_N and _mma_smem_bytes(n, h, n_freq) <= SMEM_LIMIT
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return 1
    return 0


def _check(q, k, v, boxes, fc_g_kernel, fc_g_bias, padding_mask) -> None:
    """What the kernels take: q, k, v (bs, n, h, dk) of one dtype (f32 or
    bf16; they are rounded to bf16) with h <= 16, boxes (bs, n, 4), fc_g
    (dim_g, h) with dim_g % 8 == 0 and bias (h,), the three in f32, bf16 or
    f16, mask (bs, 1, 1, n), a shared memory need within one block's (the
    SIMT kernel's, which takes every shape the MMA kernel does), all on one
    CUDA device (checked last)."""
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
    if any(t.dtype not in DTYPE_CODES for t in (boxes, fc_g_kernel, fc_g_bias)):
        raise TypeError(f"geo_fused_attention kernel takes boxes, fc_g and its bias in float32, "
                        f"bfloat16 or float16, got {boxes.dtype}, {fc_g_kernel.dtype}, "
                        f"{fc_g_bias.dtype}")
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
    """Geometry-biased attention; see the module docstring.  On a card the
    boxes, the mask and fc_g go to the kernel as they are (fc_g at its
    strides, e.g. a transposed view of a Linear's weight): the kernel
    computes the geometry rows itself, rounding each op in the boxes'
    dtype, so a call runs no torch op beyond the output's allocation (and
    the bf16 copies of f32 q, k, v)."""
    tensors = (q, k, v, boxes, fc_g_kernel, fc_g_bias, padding_mask)
    refuse_grad("geo_fused_attention", *tensors)
    if all(t.device.type == "cpu" for t in tensors):
        return geo_fused_attention_reference(q, k, v, boxes, fc_g_kernel, fc_g_bias,
                                             padding_mask, sm_scale, wave_len)
    _check(*tensors)
    bs, n, h, dk = q.shape
    n_freq = fc_g_kernel.shape[0] // 8
    qb, kb, vb = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
    mask = padding_mask if padding_mask.dtype == torch.bool else padding_mask != 0
    mask, boxes = mask.contiguous(), boxes.contiguous()
    omega = _frequencies(n_freq, float(wave_len), q.device)
    out = torch.empty((bs, n, h, dk), dtype=q.dtype, device=q.device)
    err = _library().openviic_geo_attention(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), boxes.data_ptr(), DTYPE_CODES[boxes.dtype],
        mask.data_ptr(), fc_g_kernel.data_ptr(), fc_g_kernel.stride(0), fc_g_kernel.stride(1),
        DTYPE_CODES[fc_g_kernel.dtype], fc_g_bias.data_ptr(), fc_g_bias.stride(0),
        DTYPE_CODES[fc_g_bias.dtype], omega.data_ptr(), out.data_ptr(), bs, n, h, dk, n_freq,
        float(sm_scale), int(q.dtype == torch.bfloat16), kernel_route(qb, kb, vb, n_freq),
        cuda_build.current_stream(q.device),
    )
    cuda_build.check_launch("geo_fused_attention", err)
    geo_fused_attention.launches += 1
    return out


geo_fused_attention.launches = 0
