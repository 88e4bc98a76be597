"""What the two whole-layer decode-step kernels share: the weight pack, the
LayerNorm of the JAX kernels, and the launch of ``csrc/layer_step.cu``
(one source, templated on beam-resident or not; the bound and the design
are described there).

The weight pack is the JAX kernels' dict, in their (in, out) layout:
``wqkv`` (D, 3D) and ``bqkv`` (3D,) (q | k | v), ``wo``/``bo``,
``wqc``/``bqc`` and ``woc``/``boc`` (cross-attention query and output),
``w1`` (D, F)/``b1``, ``w2`` (F, D)/``b2``, and the three post-LNs
``ln1s``/``ln1b`` .. ``ln3s``/``ln3b``."""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from openviic_tpu_torch.ops import cuda_build

NEG = -1e30  # the JAX kernels' additive mask
LN_EPS = 1e-5
MAX_D = 512  # the kernels' widest model (csrc/layer_step.cu)
WEIGHT_KEYS = (
    "wqkv", "bqkv", "wo", "bo", "wqc", "bqc", "woc", "boc",
    "w1", "b1", "w2", "b2", "ln1s", "ln1b", "ln2s", "ln2b", "ln3s", "ln3b",
)


def layer_norm(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The JAX kernels' ``_ln``: biased variance, eps 1e-5, f32."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + LN_EPS) * scale.float() + bias.float()


def head_sums(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(..., D) -> (..., h): the sum over each head's d = D / h columns."""
    return x.reshape(x.shape[:-1] + (n_heads, x.shape[-1] // n_heads)).sum(-1)


def per_column(x: torch.Tensor, n_heads: int, width: int) -> torch.Tensor:
    """(..., h) -> (..., D): each head's value repeated over its columns."""
    return x.repeat_interleave(width // n_heads, dim=-1)


@functools.lru_cache(maxsize=None)
def library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """``csrc/layer_step.cu``'s library with its entries typed: the port's
    own, or a measurement build with the ``-D`` flags ``defines``."""
    lib = cuda_build.load("layer_step", defines)
    lib.openviic_layer_step.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.openviic_layer_step.restype = ctypes.c_int
    lib.openviic_layer_step_smem.argtypes = [ctypes.c_int] * 5
    lib.openviic_layer_step_smem.restype = ctypes.c_longlong
    lib.openviic_layer_step_occupancy.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.openviic_layer_step_occupancy.restype = ctypes.c_int
    return lib


def check_cuda(name: str, tensors: Dict[str, torch.Tensor], weights: Dict[str, torch.Tensor],
               D: int, F: int, n_heads: int) -> None:
    """What the kernel takes: contiguous tensors, bf16 activations, caches
    and weights 16-byte aligned, int64 ancestry, bool masks; D <= 512 and a
    multiple of 64, F a multiple of 64, d = D / h with d / 8 a power of two
    up to 32; all on one CUDA device (checked last, so that shapes and
    dtypes are checked on any device)."""
    everything = dict(tensors, **{f"weights[{k}]": weights[k] for k in WEIGHT_KEYS})
    for key, t in everything.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors ({key})")
        if key.endswith("mask") or key == "is_pad":
            want = torch.bool
        else:
            want = torch.int64 if key == "ancestry" else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"{name} kernel takes {want} {key}, got {t.dtype}")
        if want == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes 16-byte aligned bf16 tensors ({key})")
    d = D // n_heads if n_heads > 0 else 0
    if not (D % 64 == 0 and D <= MAX_D and F % 64 == 0 and F > 0 and d * n_heads == D
            and d % 8 == 0 and (d // 8) & (d // 8 - 1) == 0 and d // 8 <= 32):
        raise ValueError(f"{name} kernel needs D <= {MAX_D} and a multiple of 64, F a multiple "
                         f"of 64, and d = D / h with d / 8 a power of two <= 32; got D={D}, "
                         f"F={F}, h={n_heads}")
    expected = {
        "wqkv": (D, 3 * D), "bqkv": (3 * D,), "wo": (D, D), "bo": (D,), "wqc": (D, D),
        "bqc": (D,), "woc": (D, D), "boc": (D,), "w1": (D, F), "b1": (F,), "w2": (F, D),
        "b2": (D,),
    }
    for key in WEIGHT_KEYS:
        shape = expected.get(key, (D,))
        if tuple(weights[key].shape) != shape:
            raise ValueError(f"{name}: weights[{key}] has shape {tuple(weights[key].shape)}, "
                             f"expected {shape}")
    device = next(iter(tensors.values())).device
    if device.type != "cuda" or any(t.device != device for t in everything.values()):
        raise ValueError(f"{name} takes all-cpu or same-device cuda tensors, got "
                         f"{ {k: str(t.device) for k, t in everything.items()} }")


def launch(name: str, resident: bool, ptrs, N: int, L: int, M: int, D: int, F: int,
           n_heads: int, beam: int, t: int, device, lib: Optional[ctypes.CDLL] = None) -> None:
    """Launch ``csrc/layer_step.cu`` (or the measurement build ``lib``) with
    the 30 pointers in the order its C entry lists; raises on a launch error
    or a block that needs more shared memory than the card has."""
    lib = lib or library()
    smem = lib.openviic_layer_step_smem(int(resident), D, F, L, M)
    limit = getattr(torch.cuda.get_device_properties(device), "shared_memory_per_block_optin", None)
    if limit is not None and smem > limit:
        raise ValueError(f"{name} kernel needs {smem} B of shared memory per block, "
                         f"the card offers {limit} (D={D}, F={F}, L={L}, M={M})")
    if N * max(L, M) * D >= 2**31:
        raise ValueError(f"{name} kernel indexes rows with 32-bit ints")
    if not 0 <= t < L:
        raise ValueError(f"{name}: step {t} outside the cache length {L}")
    array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dims = (ctypes.c_int * 8)(N, L, M, D, F, n_heads, beam, t)
    err = lib.openviic_layer_step(int(resident), array, dims, 1.0 / (D // n_heads) ** 0.5,
                                  cuda_build.current_stream(device))
    cuda_build.check_launch(name, err)


def occupancy(resident: bool, N: int, D: int, F: int, L: int, M: int, n_heads: int,
              lib: Optional[ctypes.CDLL] = None) -> Dict[str, int]:
    """How the resident (or fused) kernel of the port's build, or of
    ``lib``, runs at N rows on the current card: CTAs per SM, CTAs resident
    at once, the cluster size it takes, rows per cluster tile, grid,
    registers and local (spill) bytes per thread, shared bytes per CTA."""
    out = (ctypes.c_int * 8)()
    err = (lib or library()).openviic_layer_step_occupancy(int(resident), N, D, F, L, M,
                                                            n_heads, out)
    cuda_build.check_launch("layer step occupancy", err)
    keys = ("ctas_per_sm", "resident_ctas", "cluster", "rows_per_tile", "grid", "registers",
            "local_bytes", "smem_bytes")
    return dict(zip(keys, list(out)))


def weight_ptrs(weights: Dict[str, torch.Tensor]):
    """The weights' pointers in the C entry's order (wqkv .. b2, ln1s .. ln3b)."""
    return [weights[k].data_ptr() for k in WEIGHT_KEYS]
