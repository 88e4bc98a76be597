"""GPipe pipeline parallelism over a mesh axis (the port's counterpart of
``openviic_tpu/parallel/pipeline.py``).

A homogeneous layer stack is cut into P stages of L / P consecutive layers,
one a rank of the mesh's ``pipe`` axis, and each rank holds its own layers
only.  The (local) batch is split into M microbatches; at tick t stage s
runs microbatch t - s, and after every tick the activations move one stage
on through ``collectives.pipeline_shift``, whose backward moves the
gradients one stage back, so autograd runs the reverse schedule.  There
are M + P - 1 ticks and the bubble is (P - 1) / (M + P - 1) of them.  As
in JAX, every stage takes its input each tick as ``where(stage == 0,
microbatch, received)`` and writes its output into the output slots, and
the last stage's slots reach every rank through an all-reduce of the
others' zeroed ones (``collectives.all_reduce``): these keep every rank's
shifts in its autograd graph, so every stage takes part in the backward.
Where JAX computes garbage on a stage's idle ticks, a stage here passes
its input through unchanged (same observable output, less work).

It composes with a ``data`` axis (``batch_axis``): the global batch's rows
are split over it, pipelined, and gathered back."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from openviic_tpu_torch.models.positional import sinusoid_positional_embedding
from openviic_tpu_torch.parallel import collectives


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    if first is None:
        return None
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def stack_layer_params(layer_params: Sequence[Any]):
    """Stack per-layer parameter trees (nested dicts, lists or tuples of
    tensors, one structure) onto a leading layer axis."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *layer_params)


def stage_range(n_layers: int, mesh, axis: str = "pipe"):
    """The [first, last) layers of this rank's stage; raises in JAX's words
    when the stages do not divide the layers."""
    n_stages = mesh.axis_size(axis)
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} pipeline stages")
    per = n_layers // n_stages
    first = mesh.index(axis) * per
    return first, first + per


def _stage_layers(stage_layers, mesh, axis: str) -> list:
    """This rank's layers: ``stage_layers`` itself when it is a sequence of
    layers (the rank's own), else the rank's consecutive slices of a tree
    of stacked tensors with a leading (global) layer axis."""
    if isinstance(stage_layers, (list, nn.ModuleList)):
        return list(stage_layers)
    leaves = _leaves(stage_layers)
    if not leaves:
        raise ValueError("stacked_params has no leaves")
    first, last = stage_range(leaves[0].shape[0], mesh, axis)
    return [_tree_map(lambda a, i=i: a[i], stage_layers) for i in range(first, last)]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor], stage_layers,
                   x: torch.Tensor, aux: Any = None, *, mesh, microbatches: int,
                   axis: str = "pipe", batch_axis: Optional[str] = None) -> torch.Tensor:
    """Run ``x`` through a layer stack pipelined over ``mesh``'s ``axis``.

    ``stage_fn(layer, x_mb, aux_mb) -> y_mb`` applies ONE layer and keeps
    the shape and dtype.  ``stage_layers``: this rank's layers (a list or
    ``nn.ModuleList``), or a tree of tensors stacked on a leading layer
    axis of the whole stack's L layers (``stack_layer_params``), of which
    the rank takes its L / P.  ``x``: the global (batch, ...) activations,
    replicated; ``aux``: a tree of per-example side inputs (masks, biases)
    with a leading batch dim, microbatched with ``x``.  The batch (the
    per-rank batch with ``batch_axis``) must divide into ``microbatches``.
    Returns the global (batch, ...) output, replicated on every rank."""
    n_stages = mesh.axis_size(axis)
    layers = _stage_layers(stage_layers, mesh, axis)
    m = int(microbatches)
    if m < 1:
        raise ValueError("microbatches must be >= 1")
    local_batch = x.shape[0]
    if batch_axis is not None:
        if local_batch % mesh.axis_size(batch_axis) != 0:
            raise ValueError(f"batch {local_batch} not divisible by mesh axis '{batch_axis}' of "
                             f"size {mesh.axis_size(batch_axis)}")
        local_batch //= mesh.axis_size(batch_axis)
    if local_batch % m != 0:
        raise ValueError(f"per-device batch {local_batch} not divisible into {m} microbatches")

    # the input enters stage 0's work only: its gradient is summed over the
    # stages so that every rank holds it, as for any replicated tensor
    x = collectives.copy_to(x, mesh, axis)
    if batch_axis is not None:
        x = collectives.split(x, mesh, batch_axis, 0)
        aux = _tree_map(lambda a: collectives.split(a, mesh, batch_axis, 0), aux)
    s = mesh.index(axis)
    first_stage = torch.tensor(s == 0, device=x.device)
    last_stage = torch.tensor(s == n_stages - 1, device=x.device)
    xm = x.chunk(m)
    auxm = [_tree_map(lambda a, j=j: a.chunk(m)[j], aux) for j in range(m)]
    buf = torch.zeros_like(xm[0])
    outs = [None] * m
    for t in range(m + n_stages - 1):
        mb = min(max(t - s, 0), m - 1)
        xin = torch.where(first_stage, xm[mb], buf)
        y = xin
        if 0 <= t - s < m:  # an idle tick passes its input through
            for layer in layers:
                y = stage_fn(layer, y, auxm[mb])
        # the last stage emits microbatch t - (P - 1) at tick t; earlier
        # ticks write slot 0, which tick P - 1 then overwrites
        outs[min(max(t - (n_stages - 1), 0), m - 1)] = y
        if t + 1 < m + n_stages - 1:
            buf = collectives.pipeline_shift(y, mesh, axis)
    out = torch.cat(outs)
    out = collectives.all_reduce(torch.where(last_stage, out, torch.zeros_like(out)), mesh, axis)
    if batch_axis is not None:
        out = collectives.all_gather(out, mesh, batch_axis, 0)
    return out


def shard_stages(encoder: nn.Module, mesh, axis: str = "pipe") -> nn.Module:
    """Keep this rank's consecutive L / P layers of ``encoder.layers`` and
    drop the others (in place); returns ``encoder``."""
    if getattr(encoder, "pipeline_stage", None) is None:
        first, last = stage_range(len(encoder.layers), mesh, axis)
        encoder.layers = nn.ModuleList(list(encoder.layers)[first:last])
        encoder.pipeline_stage = (first, last)
    return encoder


def pipelined_encoder_apply(encoder: nn.Module, features: torch.Tensor,
                            padding_mask: torch.Tensor, *, mesh, microbatches: int,
                            axis: str = "pipe", batch_axis: Optional[str] = None) -> torch.Tensor:
    """The standard ``Encoder``'s forward (models/encoders.py) with its layer
    stack pipelined: the LayerNorm and the sinusoid positions run
    replicated, then the ``EncoderLayer`` stack streams microbatches over
    ``axis``.  ``encoder`` keeps only this rank's stage of layers
    (``shard_stages``, applied here if it was not)."""
    shard_stages(encoder, mesh, axis)
    pos = sinusoid_positional_embedding(features, encoder.d_model)
    out = (encoder.layer_norm(features) + pos).to(features.dtype)

    def stage_fn(layer, x, mask):
        return layer(x, x, x, mask, mask)

    return pipeline_apply(stage_fn, encoder.layers, out, padding_mask, mesh=mesh,
                          microbatches=microbatches, axis=axis, batch_axis=batch_axis)
