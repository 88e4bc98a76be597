"""Fused vocab head + logsumexp + per-row exact top-k.

Replaces the Pallas kernel ``openviic_tpu/ops/head_topk.py::head_topk``
with the hand-written CUDA kernel ``csrc/head_topk.cu`` (the bound and the
design are described there).  For x (N, D) and the head weight w (V, D)
(a ``Linear(D, V)`` weight: one contiguous row per vocab id) it returns

  vals (N, k) f32: the k largest logits, raw (no log-softmax), by value,
                   ties to the lowest id;
  idxs (N, k) i32: their vocab ids;
  lse  (N,)   f32: the row's logsumexp,

where logits = (bf16(x) @ bf16(w)^T with f32 accumulation) rounded to bf16,
as the JAX kernel computes them.

``head_topk`` dispatches on the tensors' device: on the CPU it runs
``head_topk_reference``, the plain PyTorch version; on a CUDA device it
launches the kernel or raises.  ``head_topk.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from openviic_tpu_torch.ops import cuda_build

MAX_K = 16  # the kernel's largest k (csrc/head_topk.cu)
_BLOCKS_PER_SM = 4  # vocab splits are chosen to give about this many blocks per SM


def head_topk_reference(x: torch.Tensor, w: torch.Tensor, k: int):
    """Plain PyTorch version: f32 product of the bf16-rounded operands,
    logits rounded through bf16, lse over them, and a top-k that takes the
    lowest id among equal values (a stable descending sort: ``torch.topk``
    promises no tie order)."""
    logits = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T
    logits = logits.to(torch.bfloat16).float()
    lse = torch.logsumexp(logits, dim=1)
    order = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(logits, 1, order), order.to(torch.int32), lse


_lib = None  # the loaded library, with its C signatures declared


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("head_topk")
        fn = lib.openviic_head_topk
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name in ("tile_rows", "tile_cols", "max_k"):
            getattr(lib, f"openviic_head_topk_{name}").restype = ctypes.c_int
        if lib.openviic_head_topk_max_k() != MAX_K:
            raise RuntimeError("csrc/head_topk.cu and ops/head_topk.py disagree on MAX_K")
        _lib = lib
    return _lib


def _check(x: torch.Tensor, w: torch.Tensor, k: int) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"head_topk takes cpu or same-device cuda tensors, got {x.device}, {w.device}")
    _check_operands(x, w, k)


def _check_operands(x: torch.Tensor, w: torch.Tensor, k: int) -> None:
    """What the kernel takes: bf16, contiguous, 16-byte aligned x (N, D) and
    w (V, D) with D % 8 == 0, and 1 <= k <= min(MAX_K, V)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"expected x (N, D) and w (V, D), got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"head_topk kernel takes bfloat16, got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("head_topk kernel takes contiguous x and w")
    N, D = x.shape
    V = w.shape[0]
    if N < 1 or D % 8 or D < 8:
        raise ValueError(f"head_topk kernel needs N >= 1 and D a multiple of 8, got N={N}, D={D}")
    if not 1 <= k <= min(MAX_K, V):
        raise ValueError(f"head_topk kernel takes 1 <= k <= min({MAX_K}, V), got k={k}, V={V}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("head_topk kernel needs 16-byte aligned x and w")
    if max(N * D, V * D) >= 2**31:
        raise ValueError("head_topk kernel indexes with 32-bit ints")


def head_topk(x: torch.Tensor, w: torch.Tensor, k: int):
    """Fused head + lse + top-k; see the module docstring."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return head_topk_reference(x, w, k)
    _check(x, w, k)
    lib = _library()
    N, D = x.shape
    V = w.shape[0]
    n_tiles = -(-V // lib.openviic_head_topk_tile_cols())
    row_blocks = -(-N // lib.openviic_head_topk_tile_rows())
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = min(n_tiles, max(1, -(-_BLOCKS_PER_SM * sms // row_blocks)))
    tiles_per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // tiles_per_split)  # every split non-empty

    dev = x.device
    part_val = torch.empty((N, splits, k), dtype=torch.float32, device=dev)
    part_idx = torch.empty((N, splits, k), dtype=torch.int32, device=dev)
    part_max = torch.empty((N, splits), dtype=torch.float32, device=dev)
    part_sum = torch.empty((N, splits), dtype=torch.float32, device=dev)
    vals = torch.empty((N, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((N, k), dtype=torch.int32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.openviic_head_topk(
            x.data_ptr(), w.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
            part_max.data_ptr(), part_sum.data_ptr(), vals.data_ptr(),
            idxs.data_ptr(), lse.data_ptr(), N, D, V, k, tiles_per_split, splits,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"head_topk kernel launch failed: CUDA error {err}")
    head_topk.launches += 1
    return vals, idxs, lse


head_topk.launches = 0
