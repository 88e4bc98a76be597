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
launches.  k runs from 1 to min(128, V), as in the JAX kernel; up to 16 the
kernel keeps a list per thread and row, above 16 one heap per row, which is
slower.  The kernel's grid is ``split_count`` vocab splits of
``TILE_ROWS``-row blocks; ``split_tiles`` gives each split's vocab tiles.
"""

from __future__ import annotations

import ctypes

import torch

from openviic_tpu_torch.ops import cuda_build, refuse_grad

MAX_K = 128  # the kernel's largest k, as the JAX kernel's (csrc/head_topk.cu)
TILE_ROWS = 64  # rows of x per block (csrc/head_topk.cu's BM)
TILE_COLS = 128  # vocab ids per tile (BN)
MAX_SPLITS = 96  # vocab splits the merge kernel takes


def split_count(N: int, V: int, sms: int) -> int:
    """Vocab splits of the kernel's grid: as many as fill ``sms`` SMs at one
    block per SM beside the ceil(N / TILE_ROWS) row blocks, at most one per
    vocab tile of TILE_COLS ids and MAX_SPLITS, at least one."""
    row_blocks = -(-N // TILE_ROWS)
    tiles = -(-V // TILE_COLS)
    return max(1, min(tiles, MAX_SPLITS, sms // row_blocks))


def split_tiles(V: int, splits: int):
    """The vocab tiles [begin, end) of each split, as the kernel takes them:
    sizes that differ by at most one tile, none empty while splits <= tiles."""
    tiles = -(-V // TILE_COLS)
    return [(s * tiles // splits, (s + 1) * tiles // splits) for s in range(splits)]


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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name in ("tile_rows", "tile_cols", "max_k", "max_splits", "smem"):
            getattr(lib, f"openviic_head_topk_{name}").restype = ctypes.c_int
        lib.openviic_head_topk_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.openviic_head_topk_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        shapes = (lib.openviic_head_topk_max_k(), lib.openviic_head_topk_tile_rows(),
                  lib.openviic_head_topk_tile_cols(), lib.openviic_head_topk_max_splits())
        if shapes != (MAX_K, TILE_ROWS, TILE_COLS, MAX_SPLITS):
            raise RuntimeError("csrc/head_topk.cu and ops/head_topk.py disagree on MAX_K, "
                               "TILE_ROWS, TILE_COLS or MAX_SPLITS")
        _lib = lib
    return _lib


def occupancy(D: int, k: int):
    """How the kernel's partial pass runs on the current card at width D
    and k: CTAs per SM, threads per CTA, registers and local (spill) bytes
    per thread, shared bytes per CTA."""
    out = (ctypes.c_int * 5)()
    err = _library().openviic_head_topk_occupancy(D, k, out)
    cuda_build.check_launch("head_topk occupancy", err)
    keys = ("ctas_per_sm", "threads", "registers", "local_bytes", "smem_bytes")
    return dict(zip(keys, list(out)))


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
    refuse_grad("head_topk", x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return head_topk_reference(x, w, k)
    _check(x, w, k)
    lib = _library()
    N, D = x.shape
    V = w.shape[0]
    props = torch.cuda.get_device_properties(x.device)
    smem = lib.openviic_head_topk_smem(D, k)
    limit = getattr(props, "shared_memory_per_block_optin", None)
    if limit is not None and smem > limit:
        raise ValueError(f"head_topk kernel needs {smem} B of shared memory per block at D={D}, "
                         f"k={k}; the card offers {limit}")
    splits = split_count(N, V, props.multi_processor_count)

    dev = x.device
    part_val = torch.empty((N, splits, k), dtype=torch.float32, device=dev)
    part_idx = torch.empty((N, splits, k), dtype=torch.int32, device=dev)
    part_max = torch.empty((N, splits), dtype=torch.float32, device=dev)
    part_sum = torch.empty((N, splits), dtype=torch.float32, device=dev)
    vals = torch.empty((N, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((N, k), dtype=torch.int32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    err = lib.openviic_head_topk(
        x.data_ptr(), w.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
        part_max.data_ptr(), part_sum.data_ptr(), vals.data_ptr(),
        idxs.data_ptr(), lse.data_ptr(), N, D, V, k, splits,
        cuda_build.current_stream(dev),
    )
    cuda_build.check_launch("head_topk", err)
    head_topk.launches += 1
    return vals, idxs, lse


head_topk.launches = 0
