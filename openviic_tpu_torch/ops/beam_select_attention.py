"""Beam-resident self-attention of one decode step.

Replaces the Pallas kernel
``openviic_tpu/ops/beam_select_attention.py::beam_select_attention`` with
the hand-written CUDA kernels of ``csrc/beam_select_attention.cu`` (the
bound and the designs are described there): a fast kernel (one block per
image, one warp per beam row over every head, the live K and V rows of a
batch of positions loaded at once, an online softmax in registers) for
rows of h * d_k = 256, 512 or 1024 elements with d_k = d_v and 16-byte
aligned pointers, and a general kernel for the other shapes the wrapper
takes (``kernel_route`` says which).

For this step's queries q_t (N, 1, h, d_k) (its rows may lie any even
number of elements apart, as in a slice of a fused qkv projection), the
append-only caches k (N, L, h, d_k) and v (N, L, h, d_v) (N = bs * beam
rows, each beam writing its own slot and never reordered), the ancestry
table (bs, beam, L) (the slot of the same image that holds position l of
each current beam's prefix) and the position mask (N, 1, 1, L) (True =
masked), it returns the pre-output-projection attention (N, 1, h, d_v) in
q_t's dtype.  With ``mask_axis="q"`` the mask is already resolved per
current beam; with ``"p"`` it is the raw per-slot mask and is read at the
ancestor's slot.

Numerics follow the JAX kernel: f32 scores ``(q . k) * d_k**-0.5``, a
-1e30 additive mask (so a fully masked row is uniform, not NaN), an f32
softmax and PV, the result cast to q_t's dtype.

``beam_select_attention`` dispatches on the tensors' device: on the CPU it
runs ``beam_select_attention_reference``, the plain PyTorch version; on a
CUDA device it launches a kernel or raises.  ``beam_select_attention
.launches`` counts kernel launches."""

from __future__ import annotations

import ctypes
import math

import torch

from openviic_tpu_torch.ops import cuda_build, refuse_grad

NEG = -1e30  # the JAX kernels' additive mask
MAX_HEAD_DIM = 512  # the kernels' largest d_k and d_v (csrc/beam_select_attention.cu)
FAST_ROW = 256  # the fast kernel's rows of h * d_k elements are 1, 2 or 4 times this


def ancestor_rows(ancestry: torch.Tensor) -> torch.Tensor:
    """(N, L) int64: the cache row holding position l of row n's prefix,
    ``(n // beam) * beam + ancestry[n // beam, n % beam, l]``."""
    b_s, n_beams, L = ancestry.shape
    first = torch.arange(b_s, device=ancestry.device)[:, None, None] * n_beams
    return (first + ancestry.long()).reshape(b_s * n_beams, L)


def beam_select_attention_reference(q_t, k, v, ancestry, position_mask,
                                    mask_axis: str = "q"):
    """Plain PyTorch version: index the ancestor rows, then f32 scores,
    additive -1e30 mask, softmax and PV."""
    N, _, h, d_k = q_t.shape
    L = k.shape[1]
    src = ancestor_rows(ancestry)
    pos = torch.arange(L, device=k.device)
    ks = k[src, pos].float()  # (N, L, h, d_k)
    vs = v[src, pos].float()
    pm = position_mask.reshape(N, L)
    dead = pm[src, pos] if mask_axis == "p" else pm
    s = (ks * q_t.float()).sum(-1) * (1.0 / math.sqrt(d_k))  # (N, L, h)
    s = s + dead[..., None].float() * NEG
    e = torch.exp(s - s.amax(dim=1, keepdim=True))
    att = e / e.sum(dim=1, keepdim=True)
    out = (vs * att[..., None]).sum(dim=1)  # (N, h, d_v)
    return out.to(q_t.dtype).reshape(N, 1, h, v.shape[3])


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("beam_select_attention")
        fn = lib.openviic_beam_select_attention
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.openviic_beam_select_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.openviic_beam_select_occupancy.restype = ctypes.c_int
        _lib = lib
    return _lib


def occupancy(route: int, beam: int, h: int, L: int):
    """How the kernel of ``route`` (``kernel_route``) runs on the current
    card at beam, h and L: CTAs per SM, threads per CTA, registers and
    local (spill) bytes per thread, shared bytes per CTA."""
    out = (ctypes.c_int * 5)()
    err = _library().openviic_beam_select_occupancy(route, beam, h, L, out)
    cuda_build.check_launch("beam_select_attention occupancy", err)
    keys = ("ctas_per_sm", "threads", "registers", "local_bytes", "smem_bytes")
    return dict(zip(keys, list(out)))


def kernel_route(q_t, k, v) -> int:
    """Which CUDA kernel takes these operands: 1, 2 or 4, the fast kernel
    for rows of h * d_k = 256, 512 or 1024 elements (d_k = d_v, each lane's
    8, 16 or 32 elements within one head, every pointer and q_t's row
    stride 16-byte aligned); 0, the general kernel."""
    h, d_k, d_v = q_t.shape[2], q_t.shape[3], v.shape[3]
    ck = h * d_k // FAST_ROW
    aligned = (all(t.data_ptr() % 16 == 0 for t in (q_t, k, v))
               and q_t.stride(0) % 8 == 0)
    if (not aligned or d_k != d_v or h * d_k != ck * FAST_ROW or ck not in (1, 2, 4)
            or d_k % (8 * ck) or (d_k // (8 * ck)) & (d_k // (8 * ck) - 1)):
        return 0
    return ck


def _check(q_t, k, v, ancestry, position_mask, mask_axis: str) -> None:
    """What the kernels take: q_t, k, v in bf16 with even d_k, d_v <= 512
    and h <= 32, k and v contiguous, q_t's heads contiguous within a row
    (its rows may lie any even number of elements apart, as in a slice of
    a fused qkv projection), int64 ancestry and a bool position_mask, all
    on one CUDA device (checked last, so that shapes and dtypes are checked
    on any device)."""
    tensors = (q_t, k, v, ancestry, position_mask)
    if mask_axis not in ("q", "p"):
        raise ValueError(f"mask_axis must be 'q' or 'p', got {mask_axis!r}")
    if q_t.dim() != 4 or k.dim() != 4 or v.dim() != 4 or ancestry.dim() != 3:
        raise ValueError("expected q_t (N,1,h,d_k), k (N,L,h,d_k), v (N,L,h,d_v), "
                         f"ancestry (bs,beam,L); got {tuple(q_t.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(ancestry.shape)}")
    b_s, n_beams, L = ancestry.shape
    N, one, h, d_k = q_t.shape
    d_v = v.shape[3]
    if (one != 1 or N != b_s * n_beams or k.shape != (N, L, h, d_k)
            or v.shape[:3] != (N, L, h) or position_mask.shape != (N, 1, 1, L)):
        raise ValueError(f"inconsistent shapes: q_t {tuple(q_t.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, ancestry {tuple(ancestry.shape)}, "
                         f"position_mask {tuple(position_mask.shape)}")
    if q_t.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"beam_select_attention kernel takes bfloat16 q/k/v, got "
                        f"{q_t.dtype}, {k.dtype}, {v.dtype}")
    if ancestry.dtype != torch.int64 or position_mask.dtype != torch.bool:
        raise TypeError(f"beam_select_attention kernel takes int64 ancestry and a bool mask, "
                        f"got {ancestry.dtype}, {position_mask.dtype}")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("beam_select_attention kernel takes contiguous k, v, ancestry and "
                         "position_mask")
    if q_t.stride(3) != 1 or (h > 1 and q_t.stride(2) != d_k) or q_t.stride(0) % 2:
        raise ValueError(f"beam_select_attention kernel takes q_t with each row's heads "
                         f"contiguous and an even row stride, got strides {q_t.stride()}")
    if not (1 <= h <= 32 and d_k % 2 == 0 and d_v % 2 == 0
            and 2 <= d_k <= MAX_HEAD_DIM and 2 <= d_v <= MAX_HEAD_DIM and L >= 1):
        raise ValueError(f"beam_select_attention kernel needs h <= 32 and even d_k, d_v <= "
                         f"{MAX_HEAD_DIM}; got h={h}, d_k={d_k}, d_v={d_v}, L={L}")
    if N * L * h * max(d_k, d_v) >= 2**31:
        raise ValueError("beam_select_attention kernel indexes rows with 32-bit ints")
    if any(t.data_ptr() % 4 for t in (q_t, k, v)):
        raise ValueError("beam_select_attention kernel takes 4-byte aligned q_t, k and v")
    if any(t.device != q_t.device for t in tensors) or q_t.device.type != "cuda":
        raise ValueError("beam_select_attention takes all-cpu or same-device cuda tensors, got "
                         f"{[str(t.device) for t in tensors]}")


def beam_select_attention(q_t, k, v, ancestry, position_mask, mask_axis: str = "q"):
    """Beam-resident self-attention step; see the module docstring.  The
    kernel trusts ``0 <= ancestry < beam``, as the decode guarantees."""
    refuse_grad("beam_select_attention", q_t, k, v)
    if all(t.device.type == "cpu" for t in (q_t, k, v, ancestry, position_mask)):
        return beam_select_attention_reference(q_t, k, v, ancestry, position_mask, mask_axis)
    _check(q_t, k, v, ancestry, position_mask, mask_axis)
    N, _, h, d_k = q_t.shape
    L, d_v = k.shape[1], v.shape[3]
    out = torch.empty((N, 1, h, d_v), dtype=q_t.dtype, device=q_t.device)
    err = _library().openviic_beam_select_attention(
        q_t.data_ptr(), q_t.stride(0), k.data_ptr(), v.data_ptr(), ancestry.data_ptr(),
        position_mask.data_ptr(), out.data_ptr(), N, L, h, d_k, d_v,
        ancestry.shape[1], int(mask_axis == "p"), 1.0 / math.sqrt(d_k),
        kernel_route(q_t, k, v), cuda_build.current_stream(q_t.device),
    )
    cuda_build.check_launch("beam_select_attention", err)
    beam_select_attention.launches += 1
    return out


beam_select_attention.launches = 0
