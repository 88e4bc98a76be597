"""The data axis of the JAX package's mesh, across processes (the port's
counterpart of the data-parallel part of ``openviic_tpu/parallel/mesh.py``).

The JAX package shards the batch over a ``data`` mesh axis and lets XLA
insert the gradient all-reduce.  Here each rank of the process group
(``parallel/runtime.py``) is one position on that axis, holds a full copy
of the model and trains on its own rows of the global batch:

 - ``shard_state`` broadcasts rank 0's parameters, optimizer state, step
   and dropout generator, so every rank starts bit-equal;
 - ``make_sharded_xe_step`` is JAX's ``make_sharded_xe_step``: ``nll_loss``
   over the global batch, without label smoothing, mixed precision or
   several steps a call.  The loss is the token-weighted global mean (the
   global sum over the global count of non-pad targets): each rank
   all-reduces the count, divides its own sum by it and the gradients are
   all-reduced as a sum;
 - ``make_sharded_scst_step``: the SCST loss is a mean over equal per-rank
   rows, so the summed gradients are divided by the world size;
 - the gradients travel in flat buckets, one all-reduce each, over the
   optimizer's parameters that have a gradient (a frozen backbone's have
   none), then every rank runs the same optimizer step, so the parameters
   stay bit-equal across ranks;
 - each rank folds its rank into the dropout seed, so ranks draw different
   masks.

Without a process group every collective is skipped: the steps are then
the single-process run of the same arithmetic.  The tensor- and
expert-parallel rules of the JAX module are not ported (ROADMAP A.8)."""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.distributed as dist

from openviic_tpu_torch.parallel import runtime
from openviic_tpu_torch.training.steps import Batch, _train_update, scst_loss

BUCKET_BYTES = 25 * 2**20  # gradient bytes per all-reduce


class DataMesh:
    """The ``data`` axis over the process group: ``size`` ranks, this one
    at ``rank``; ``collective`` is False without a group (one process).
    ``allreduced_bytes`` counts the gradient bytes all-reduced."""

    def __init__(self, size: int, rank: int, collective: bool):
        self.size, self.rank, self.collective = size, rank, collective
        self.allreduced_bytes = 0


def make_mesh() -> DataMesh:
    """The data axis over every rank of the group (one rank without one)."""
    return DataMesh(runtime.process_count(), runtime.process_index(), dist.is_initialized())


def batch_shard(batch: Batch, mesh: DataMesh) -> Batch:
    """This rank's contiguous rows of each tensor of a global batch (every
    rank's rows in rank order make the global tensor)."""
    out = {}
    for key, value in batch.items():
        if len(value) % mesh.size:
            raise ValueError(f"global batch {len(value)} must divide the {mesh.size}-device "
                             "mesh")
        n = len(value) // mesh.size
        out[key] = value[mesh.rank * n:(mesh.rank + 1) * n]
    return out


def shard_state(model: torch.nn.Module, state: dict, mesh: DataMesh) -> dict:
    """Rank 0's parameters, optimizer and scheduler state, step and
    generator on every rank, in place; returns ``state``."""
    if not mesh.collective:
        return state
    with torch.no_grad():
        for p in model.parameters():
            dist.broadcast(p.data, 0)
    host = None
    if mesh.rank == 0:
        host = {"optimizer": state["optimizer"].state_dict(),
                "scheduler": (None if state.get("scheduler") is None
                              else state["scheduler"].state_dict()),
                "step": int(state["step"]), "generator": state["generator"].get_state()}
    host = runtime.broadcast_object(host)
    if mesh.rank != 0:
        state["optimizer"].load_state_dict(host["optimizer"])
        if host["scheduler"] is not None:
            state["scheduler"].load_state_dict(host["scheduler"])
        state["step"] = host["step"]
        state["generator"].set_state(host["generator"])
    return state


def _buckets(grads: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive gradients of one device and dtype, up to ``BUCKET_BYTES``
    a bucket (a larger gradient alone)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        last = out[-1] if out else None
        if (last is None or (last[0].device, last[0].dtype) != (g.device, g.dtype)
                or size + nbytes > BUCKET_BYTES):
            out.append([g])
            size = nbytes
        else:
            last.append(g)
            size += nbytes
    return out


def allreduce_gradients(parameters: Iterable[torch.nn.Parameter], mesh: DataMesh,
                        divide: int = 1) -> None:
    """Sum the ``.grad`` of ``parameters`` (those that have one) over the
    ranks, in flat buckets, then divide by ``divide``."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not mesh.collective:
        if divide != 1:
            for g in grads:
                g.div_(divide)
        return
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        if divide != 1:
            flat.div_(divide)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        mesh.allreduced_bytes += flat.numel() * flat.element_size()


def sum_across(tensor: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``tensor`` summed over the ranks (as it is without a group)."""
    if not mesh.collective:
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out)
    return out


def _trained(state: dict) -> List[torch.nn.Parameter]:
    return [p for group in state["optimizer"].param_groups for p in group["params"]]


def nll_sum(log_probs: torch.Tensor, targets: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """The negative log-likelihood summed over the targets that are not
    ``ignore_index`` (``nll_loss``'s numerator)."""
    flat_lp = log_probs.reshape(-1, log_probs.shape[-1])
    flat_t = targets.reshape(-1).long()
    picked = torch.gather(flat_lp, 1, flat_t[:, None])[:, 0]
    return -torch.where(flat_t != ignore_index, picked, torch.zeros_like(picked)).sum()


def make_sharded_xe_step(model, mesh: DataMesh):
    """(state, this rank's rows of the batch) -> (state, the global loss):
    one data-parallel XE update (see the module's docstring).  The state is
    ``steps.init_xe_state``'s."""
    pad = model.vocab.padding_idx

    def update(state: dict, batch: Batch):
        def backward():
            targets = batch["shifted_right_caption_tokens"]
            count = sum_across((targets != pad).sum(), mesh)
            loss = nll_sum(model(batch), targets, pad) / count.clamp_min(1)
            loss.backward()
            allreduce_gradients(_trained(state), mesh)
            return sum_across(loss, mesh)

        return _train_update(model, state, backward, stream=mesh.rank)

    return update


def make_sharded_scst_step(model, beam_size: int, mesh: DataMesh):
    """(state, batch, sampled, reward) -> (state, loss): one data-parallel
    SCST update over this rank's rows (``steps.make_scst_grad_step``'s
    arguments); the loss and gradients are the means over every rank's
    rows."""

    def update(state: dict, batch: Batch, sampled: torch.Tensor, reward: torch.Tensor):
        def backward():
            loss = scst_loss(model, batch, sampled, reward, beam_size)
            loss.backward()
            allreduce_gradients(_trained(state), mesh, divide=mesh.size)
            return sum_across(loss, mesh) / mesh.size

        return _train_update(model, state, backward, stream=mesh.rank)

    return update
