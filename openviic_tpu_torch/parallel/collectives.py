"""The collectives of the model-parallel layouts, over one mesh axis, each
an autograd function whose backward runs its transpose.

JAX's layouts are differentiable because ``ppermute`` transposes to the
reverse ``ppermute``, ``all_to_all`` to the inverse ``all_to_all`` and
``psum`` over replicated results to a broadcast.  The port writes those
out.  A tensor on an axis is either *replicated* (one value, every rank of
the axis holds it) or *varying* (each rank holds its own: a shard, a
partial sum); every rank computes the same loss from replicated values, so
the gradient of a replicated tensor is itself replicated:

 - ``ring_shift``: rank i's tensor to rank i + 1 (mod the axis size);
   backward: the reverse shift;
 - ``pipeline_shift``: stage s's tensor to stage s + 1, zeros into stage
   0; backward: stage s + 1's gradient to stage s, zeros into the last;
 - ``all_gather``: the ranks' shards concatenated in axis order along a
   dim, replicated; backward: this rank's slice of the gradient;
 - ``split``: this rank's slice of a replicated tensor; backward: the
   slices' gradients all-gathered (the transpose of ``all_gather``);
 - ``all_reduce``: the ranks' partial sums summed, replicated (JAX's
   ``psum``); backward: the replicated gradient to every rank unchanged;
 - ``copy_to``: a replicated tensor entering varying work (a column-
   parallel product, a rank's experts); forward unchanged, backward: the
   ranks' gradients summed (the transpose of ``all_reduce``);
 - ``all_to_all``: JAX's tiled ``all_to_all`` (split one dim into axis-size
   chunks, chunk j to rank j, the received chunks concatenated along
   another dim in rank order); backward: the inverse ``all_to_all``;
 - ``all_reduce_max``: the elementwise maximum, without a gradient.

On an axis of size 1, or without a process group, each is the identity
(a collective still runs on a one-rank group; a point-to-point shift does
not).  Every op adds the bytes that this rank sends to
``mesh.moved[axis][op]`` (forward and backward alike).

This is the one place that stages a CUDA tensor through pinned host memory:
when the axis's group is gloo and the op is one that gloo does not take on
a CUDA tensor (``GLOO_CUDA`` lists those it takes), the tensor goes to
pinned host memory, through the op and back, and the op's name is added to
``mesh.staged``."""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

# the ops that gloo runs on CUDA tensors itself (``parallel/gloo_probe.py``
# on an H100); its send and receive do not (a write from a device pointer
# fails: "writev ...: Bad address"), so the two shifts are staged
GLOO_CUDA = frozenset({"all_reduce", "all_reduce_max", "all_gather", "all_to_all"})


def _size(mesh, axis: str) -> int:
    return mesh.axis_size(axis) if mesh is not None else 1


def _active(mesh, axis: str) -> bool:
    return mesh is not None and mesh.group(axis) is not None


def _count(mesh, axis: str, op: str, tensor: torch.Tensor) -> None:
    moved = mesh.moved.setdefault(axis, {})
    moved[op] = moved.get(op, 0) + tensor.numel() * tensor.element_size()


def _staged(mesh, axis: str, op: str, tensor: torch.Tensor) -> bool:
    group = mesh.group(axis)
    if not tensor.is_cuda or dist.get_backend(group) != "gloo" or op in GLOO_CUDA:
        return False
    mesh.staged.add(op)
    return True


def _host(tensor: torch.Tensor) -> torch.Tensor:
    out = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    out.copy_(tensor)
    return out


def _exchange(mesh, axis: str, op: str, tensor, send_to, recv_from, like):
    """Send ``tensor`` to the axis position ``send_to`` and receive a tensor
    shaped like ``like`` from ``recv_from`` (either may be None: nothing
    sent, or zeros received)."""
    ranks = mesh.axis_ranks[axis]
    group = mesh.group(axis)
    stage = _staged(mesh, axis, op, like)
    ops, inbox = [], None
    if send_to is not None:
        src = tensor.contiguous()
        _count(mesh, axis, op, src)
        ops.append(dist.P2POp(dist.isend, _host(src) if stage else src, ranks[send_to], group))
    if recv_from is not None:
        inbox = torch.empty(like.shape, dtype=like.dtype,
                            device="cpu" if stage else like.device,
                            pin_memory=stage)
        ops.append(dist.P2POp(dist.irecv, inbox, ranks[recv_from], group))
    for work in (dist.batch_isend_irecv(ops) if ops else []):
        work.wait()
    if inbox is None:
        return torch.zeros_like(like)
    return inbox.to(like.device, non_blocking=False) if stage else inbox


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        n, i = mesh.axis_size(axis), mesh.index(axis)
        return _exchange(mesh, axis, "ring_shift", x, (i + step) % n, (i - step) % n, x)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, step = ctx.mesh, ctx.axis, ctx.step
        n, i = mesh.axis_size(axis), mesh.index(axis)
        return (_exchange(mesh, axis, "ring_shift", grad, (i - step) % n, (i + step) % n, grad),
                None, None, None)


def ring_shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Rank i's ``x`` to rank i + 1 of ``axis`` (mod its size): this rank
    returns rank i - 1's."""
    if _size(mesh, axis) == 1 or not _active(mesh, axis):
        return x
    return _RingShift.apply(x, mesh, axis, 1)


class _PipelineShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        n, s = mesh.axis_size(axis), mesh.index(axis)
        return _exchange(mesh, axis, "pipeline_shift", x, s + 1 if s + 1 < n else None,
                         s - 1 if s > 0 else None, x)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis = ctx.mesh, ctx.axis
        n, s = mesh.axis_size(axis), mesh.index(axis)
        return (_exchange(mesh, axis, "pipeline_shift", grad, s - 1 if s > 0 else None,
                          s + 1 if s + 1 < n else None, grad), None, None)


def pipeline_shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Stage s's ``x`` to stage s + 1 of ``axis``: this rank returns stage
    s - 1's, zeros on stage 0 (JAX's ``ppermute`` with the pairs (i, i + 1))."""
    if _size(mesh, axis) == 1 or not _active(mesh, axis):
        return torch.zeros_like(x)
    return _PipelineShift.apply(x, mesh, axis)


def _gather(mesh, axis: str, op: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    group = mesh.group(axis)
    src = x.contiguous()
    _count(mesh, axis, op, src)
    stage = _staged(mesh, axis, op, src)
    if stage:
        src = _host(src)
    parts = [torch.empty_like(src) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if stage else out


def _slice(mesh, axis: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    n, i = mesh.axis_size(axis), mesh.index(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} not divisible by mesh axis "
                         f"'{axis}' of size {n}")
    return x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(mesh, axis, "all_gather", x, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(ctx.mesh, ctx.axis, grad, ctx.dim).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _slice(mesh, axis, x, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(ctx.mesh, ctx.axis, "all_gather", grad, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The axis's shards ``x`` concatenated along ``dim`` in axis order."""
    if not _active(mesh, axis):
        return x
    return _AllGather.apply(x, mesh, axis, dim)


def split(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of a replicated ``x`` (its size must
    divide by the axis's)."""
    if _size(mesh, axis) == 1:
        return x
    return _Split.apply(x, mesh, axis, dim)


def _reduce(mesh, axis: str, op: str, x: torch.Tensor, how) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    _count(mesh, axis, op, out)
    stage = _staged(mesh, axis, op, out)
    buf = _host(out) if stage else out
    dist.all_reduce(buf, op=how, group=mesh.group(axis))
    return buf.to(x.device) if stage else buf


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce(mesh, axis, "all_reduce", x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(ctx.mesh, ctx.axis, "all_reduce", grad, dist.ReduceOp.SUM), None, None


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' ``x`` (partial sums), replicated."""
    if not _active(mesh, axis):
        return x
    return _AllReduce.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``axis`` (a replicated
    tensor entering each rank's own share of the work)."""
    if not _active(mesh, axis):
        return x
    return _CopyTo.apply(x, mesh, axis)


def all_reduce_max(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum over ``axis`` (no gradient)."""
    if not _active(mesh, axis):
        return x.detach()
    return _reduce(mesh, axis, "all_reduce_max", x, dist.ReduceOp.MAX)


def _to_all(mesh, axis: str, x: torch.Tensor, split_dim: int, concat_dim: int):
    n = mesh.axis_size(axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} not divisible by mesh "
                         f"axis '{axis}' of size {n}")
    chunks: List[torch.Tensor] = list(x.chunk(n, dim=split_dim))
    src = torch.stack(chunks).contiguous()  # (n, ...): chunk j for rank j
    _count(mesh, axis, "all_to_all", src)
    stage = _staged(mesh, axis, "all_to_all", src)
    if stage:
        src = _host(src)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axis))
    if stage:
        out = out.to(x.device)
    return torch.cat(list(out.unbind(0)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, (split_dim, concat_dim)
        return _to_all(mesh, axis, x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return _to_all(ctx.mesh, ctx.axis, grad, concat_dim, split_dim), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's ``all_to_all(x, axis, split_dim, concat_dim, tiled=True)``."""
    if not _active(mesh, axis):
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)
