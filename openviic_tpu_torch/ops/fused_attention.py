"""Multi-head attention with an additive f32 bias.

Replaces the Pallas kernel ``openviic_tpu/ops/pallas_attention.py::
fused_attention`` with the hand-written CUDA kernel
``csrc/fused_attention.cu`` (the bound and the design are described
there).  The host side lives here: ``choose_tile`` picks the kernel's tile
from nq and the dtype, ``_check`` holds the contract.  For q (B, nq, h, d),
k (B, nk, h, d), v (B, nk, h, dv) and an optional additive bias that
broadcasts from (B, h|1, nq|1, nk), it returns
softmax(q . k * sm_scale + bias) @ v as (B, nq, h, dv) **in float32**,
whatever the inputs' dtype, as the JAX kernel does (it casts q/k/v to f32
and its output keeps that dtype).  A mask enters as a -1e30 bias, so a row
whose every key is masked is uniform over its nk keys, not NaN.  (The JAX
kernel pads nk to a multiple of 128 with -1e30 columns of zero values, so
on such a row it averages over the padded width; the port has no padding.
Such rows are padding queries, which the callers zero.)

``fused_attention`` dispatches on the tensors' device: on the CPU it runs
``fused_attention_reference``, the plain PyTorch version; on a CUDA device
it launches the kernel or raises.  ``fused_attention.launches`` counts
kernel launches.  ``OPENVIIC_PALLAS`` (read by ``pallas_enabled`` at call
time, with the JAX package's values) switches the models' ``_attend`` onto
it."""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from openviic_tpu_torch.ops import cuda_build

NEG = -1e30  # the JAX kernels' additive mask
MAX_HEAD_DIM = 128  # the kernel's largest d and dv (csrc/fused_attention.cu)
# the kernel's tiles, numbered as in csrc/fused_attention.cu
SIMT, MMA, DECODE = 0, 1, 2
TILE_NAMES = {SIMT: "simt", MMA: "mma", DECODE: "decode"}
# Up to this many queries the one-query-per-warp DECODE tile is faster than
# the 64-query MMA tile (chip_smoke.py's crossover sweep on one H100, at
# 320 images x 8 heads x 56 keys, bf16).
DECODE_MAX_NQ = 2


def pallas_enabled() -> bool:
    """``OPENVIIC_PALLAS`` is 1, true or interpret (the JAX package's test)."""
    return os.environ.get("OPENVIIC_PALLAS", "").lower() in ("1", "true", "interpret")


def fused_attention_reference(q, k, v, bias=None, sm_scale: Optional[float] = None):
    """Plain PyTorch version: f32 scores, the bias added, softmax, f32 PV."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[3])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def choose_tile(nq: int, dtype: torch.dtype) -> int:
    """The kernel's tile for nq queries of q/k/v in ``dtype``: DECODE up to
    ``DECODE_MAX_NQ`` queries, else MMA (tensor cores) for bf16 and SIMT
    (CUDA cores) for f32."""
    if nq <= DECODE_MAX_NQ:
        return DECODE
    return MMA if dtype == torch.bfloat16 else SIMT


def resolve_tile(nq: int, dtype: torch.dtype, tile: Optional[int] = None) -> int:
    """``tile``, or ``choose_tile``'s when None; raises on a tile that does
    not take ``dtype`` (MMA takes bf16 only, SIMT f32 only)."""
    tile = choose_tile(nq, dtype) if tile is None else tile
    takes = {DECODE: (torch.float32, torch.bfloat16), MMA: (torch.bfloat16,),
             SIMT: (torch.float32,)}
    if dtype not in takes.get(tile, ()):
        raise ValueError(f"fused_attention: tile {tile} does not take {dtype}")
    return tile


def loads_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every 8-element chunk along the last axis of q/k/v can be one
    16-byte load: 16-byte aligned bases, the batch, position and head
    strides and the head widths multiples of 8 elements.  Otherwise the
    kernel loads element by element (same results, slower)."""
    return all(t.data_ptr() % 16 == 0 and t.shape[3] % 8 == 0
               and all(st % 8 == 0 for st in t.stride()[:3]) for t in tensors)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("fused_attention")
        fn = lib.openviic_fused_attention
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        if lib.openviic_fused_attention_max_head_dim() != MAX_HEAD_DIM:
            raise RuntimeError("csrc/fused_attention.cu and ops/fused_attention.py disagree "
                               "on MAX_HEAD_DIM")
        _lib = lib
    return _lib


def _check(q, k, v, bias) -> Optional[torch.Tensor]:
    """What the kernel takes: q, k, v of one dtype (f32 or bf16) with their
    last axis contiguous, d and dv <= 128, and a bias that broadcasts to
    (B, h, nq, nk), all on one CUDA device (checked last, so that shapes and
    dtypes are checked on any device).  Returns the bias as an f32 view
    expanded to (B, h, nq, nk) with its key axis contiguous, or None."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B,nq,h,d), k (B,nk,h,d), v (B,nk,h,dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, nq, h, d = q.shape
    nk, dv = k.shape[1], v.shape[3]
    if k.shape != (B, nk, h, d) or v.shape[:3] != (B, nk, h) or nq < 1 or nk < 1:
        raise ValueError(f"inconsistent shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"fused_attention kernel takes d, dv <= {MAX_HEAD_DIM}, got {d}, {dv}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("fused_attention kernel takes q, k, v with a contiguous last axis")
    if B * h * nq >= 2**31 or -(-nq // 32) >= 2**16:
        raise ValueError(f"fused_attention kernel grid too large for B={B}, h={h}, nq={nq}")
    expanded = None
    if bias is not None:
        if bias.dim() != 4:
            raise ValueError(f"expected a bias (B, h|1, nq|1, nk), got {tuple(bias.shape)}")
        try:
            expanded = bias.float().expand(B, h, nq, nk)
        except RuntimeError as exc:
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                             f"{(B, h, nq, nk)}") from exc
        if expanded.stride(3) != 1 and nk > 1:
            expanded = bias.float().contiguous().expand(B, h, nq, nk)
    tensors = (q, k, v) + (() if bias is None else (bias,))
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("fused_attention takes all-cpu or same-device cuda tensors, got "
                         f"{[str(t.device) for t in tensors]}")
    return expanded


def fused_attention(q, k, v, bias=None, sm_scale: Optional[float] = None,
                    tile: Optional[int] = None):
    """Fused attention with an additive bias; see the module docstring.
    ``tile`` overrides ``choose_tile`` (for measurements); the MMA tile
    takes bf16 only, SIMT f32 only."""
    tensors = (q, k, v) + (() if bias is None else (bias,))
    if all(t.device.type == "cpu" for t in tensors):
        return fused_attention_reference(q, k, v, bias, sm_scale)
    expanded = _check(q, k, v, bias)
    B, nq, h, d = q.shape
    nk, dv = k.shape[1], v.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    tile = resolve_tile(nq, q.dtype, tile)
    out = torch.empty((B, nq, h, dv), dtype=torch.float32, device=q.device)
    if expanded is None:
        bias_ptr, bias_strides = None, (0, 0, 0)
    else:
        bias_ptr, bias_strides = expanded.data_ptr(), expanded.stride()[:3]
    err = _library().openviic_fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        B, h, nq, nk, d, dv,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), *bias_strides,
        int(q.dtype == torch.bfloat16), tile, int(loads_aligned(q, k, v)), float(sm_scale),
        cuda_build.current_stream(q.device),
    )
    cuda_build.check_launch("fused_attention", err)
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
