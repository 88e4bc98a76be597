"""Named mesh axes across processes (the port's counterpart of
``openviic_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` of named axes and
expresses each layout as shardings of global arrays; XLA inserts the
collectives.  Here each rank of the process group (``parallel/runtime.py``)
is one position of the mesh, laid out row-major over the named axes as
``np.asarray(devices).reshape(shape)`` lays devices out, and each axis is a
process subgroup: a rank keeps its own shard of every sharded tensor and
the collectives are written out (``parallel/collectives.py``).

 - **data**: the batch is sharded (``batch_shard``), parameters replicated.
   ``shard_state`` broadcasts rank 0's parameters, optimizer state, step
   and dropout generator, so every rank starts bit-equal;
   ``make_sharded_xe_step`` is JAX's ``make_sharded_xe_step``: ``nll_loss``
   over the global batch, without label smoothing, mixed precision or
   several steps a call.  The loss is the token-weighted global mean (the
   global sum over the global count of non-pad targets): each rank
   all-reduces the count over the data axis, divides its own sum by it,
   and the gradients are all-reduced over the data axis as a sum, in flat
   buckets (``allreduce_gradients``), over the optimizer's parameters that
   have a gradient (a frozen backbone's have none); every rank then runs
   the same optimizer step.  ``make_sharded_scst_step``: the SCST loss is a
   mean over equal per-rank rows, so the summed gradients are divided by
   the data axis's size.  Each data position folds its index into the
   dropout seed, so data ranks draw different masks and the ranks of one
   data position draw the same ones.
 - **model** (tensor parallel) and **expert** (expert parallel): the rule
   tables, ``param_shardings`` and ``shard_model`` live in
   ``parallel/tensor_parallel.py``; ``shard_state`` shards the optimizer's
   moments with the parameters and ``make_sharded_xe_step`` takes the
   vocab-parallel loss under a model axis.
 - **seq** and **pipe**: ``parallel/ring_attention.py``,
   ``parallel/ulysses.py`` and ``parallel/pipeline.py``.

``make_mesh()`` with no arguments is the data axis over every rank of the
group (one rank without one).  Without a process group every axis has size
1 and every collective is skipped: the steps are then the single-process
run of the same arithmetic.

The JAX module's ``batch_sharding`` and ``replicate_sharding`` build
``NamedSharding`` specs, which exist only for JAX's global arrays; here
``batch_shard`` takes a rank's slice of the batch and ``shard_state``
replicates what the data axis does not shard."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from openviic_tpu_torch.parallel import runtime
from openviic_tpu_torch.training.steps import Batch, _train_update, scst_loss

BUCKET_BYTES = 25 * 2**20  # gradient bytes per all-reduce
AXES = ("data", "model", "expert", "seq", "pipe")


class Mesh:
    """Named axes over ranks of the process group.

    ``shape`` maps each axis to its size; ``coords`` this rank's index on
    each (None where the rank is outside the mesh); ``group(axis)`` the
    subgroup of the ranks that differ from this one on ``axis`` only, in
    axis order (``axis_ranks``), or None without a process group.  The data
    axis's size and this rank's index on it are ``size`` and ``rank`` (1
    and 0 without a data axis), and ``collective`` says whether the data
    axis has a group.

    ``allreduced_bytes`` counts the gradient bytes all-reduced;
    ``moved[axis][op]`` the bytes that this rank sent through each
    collective of ``parallel/collectives.py`` and ``staged`` the ops that
    went through the host (a CUDA tensor that gloo cannot take).  A deep
    copy of a model (the decode's ``ComputeShadow``) shares its mesh."""

    def __init__(self, axis_sizes: Dict[str, int], ranks: Sequence[int], rank: int,
                 groups: Dict[str, object], axis_ranks: Dict[str, List[int]],
                 whole=None):
        self.shape = dict(axis_sizes)
        self.whole = whole  # the group of every rank of the mesh (None without one)
        self.axis_names = tuple(axis_sizes)
        self.ranks = list(ranks)
        self.process_rank = rank
        grid = np.asarray(self.ranks).reshape(tuple(self.shape.values()))
        where = np.argwhere(grid == rank)
        self.coords = ({a: int(i) for a, i in zip(self.axis_names, where[0])} if len(where)
                       else None)
        self._groups, self.axis_ranks = groups, axis_ranks
        self.allreduced_bytes = 0
        self.moved: Dict[str, Dict[str, int]] = {a: {} for a in self.axis_names}
        self.staged: set = set()

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 on an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        if self.coords is None:
            raise ValueError(f"rank {self.process_rank} is outside the mesh {self.shape}")
        return self.coords[axis]

    def group(self, axis: str):
        """The process subgroup along ``axis`` (None without one)."""
        return self._groups.get(axis)

    @property
    def size(self) -> int:
        return self.axis_size("data")

    @property
    def rank(self) -> int:
        return self.index("data")

    @property
    def collective(self) -> bool:
        return self.group("data") is not None



def make_mesh(axis_sizes: Optional[Dict[str, int]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of ``axis_sizes`` (name -> size, in order) over ``ranks`` (the
    group's ranks by default), row-major; default: one ``data`` axis over
    every rank (one rank without a group).  Every rank of the group must
    call it with the same arguments, since each axis's subgroups are made
    collectively; a rank outside ``ranks`` gets a mesh whose ``coords`` are
    None."""
    world, rank = runtime.process_count(), runtime.process_index()
    collective = dist.is_initialized()
    if axis_sizes is None:
        n = len(ranks) if ranks is not None else world
        axis_sizes = {"data": n}
        if ranks is None and collective:  # the data axis over the whole group
            return Mesh(axis_sizes, range(world), rank, {"data": dist.group.WORLD},
                        {"data": list(range(world))}, dist.group.WORLD)
    ranks = list(range(world) if ranks is None else ranks)
    shape = tuple(int(n) for n in axis_sizes.values())
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"mesh shape {dict(axis_sizes)} needs {int(np.prod(shape))} devices, "
                         f"got {len(ranks)}")
    unknown = [a for a in axis_sizes if a not in AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the port's axes are {AXES}")
    if not collective and len(ranks) > 1:
        raise ValueError(f"a mesh of {len(ranks)} ranks needs a process group "
                         "(parallel.runtime.initialize_distributed)")
    names = list(axis_sizes)
    grid = np.asarray(ranks).reshape(shape)
    groups, axis_ranks = {}, {}
    whole = None
    if collective:
        whole = dist.group.WORLD if ranks == list(range(world)) else dist.new_group(ranks)
    for i, axis in enumerate(names):
        moved = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in moved:  # every rank makes every subgroup, in one order
            members = [int(r) for r in line]
            group = dist.new_group(members) if collective else None
            if rank in members:
                groups[axis], axis_ranks[axis] = group, members
    if not collective:
        groups = {}
    return Mesh(dict(axis_sizes), ranks, rank, groups, axis_ranks,
                whole if rank in ranks else None)


def batch_shard(batch: Batch, mesh: Mesh) -> Batch:
    """This rank's contiguous rows of each tensor of a global batch on the
    data axis (every data position's rows in order make the global
    tensor)."""
    out = {}
    for key, value in batch.items():
        if len(value) % mesh.size:
            raise ValueError(f"global batch {len(value)} must divide the {mesh.size}-device "
                             "mesh")
        n = len(value) // mesh.size
        out[key] = value[mesh.rank * n:(mesh.rank + 1) * n]
    return out


def shard_state(model: torch.nn.Module, state: dict, mesh: Mesh) -> dict:
    """The mesh's first rank's parameters, optimizer and scheduler state,
    step and generator on every rank of the mesh, in place; then, under a
    ``model`` or
    ``expert`` axis, the model sharded (``tensor_parallel.shard_model``)
    and every optimizer tensor shaped like a sharded parameter (Adam's
    moments, a momentum buffer) cut to the same shard, the step count
    replicated.  Returns ``state``."""
    from openviic_tpu_torch.parallel import tensor_parallel

    if mesh.whole is not None:
        first = mesh.ranks[0]
        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p.data, first, group=mesh.whole)
        host = None
        if mesh.process_rank == first:
            host = {"optimizer": state["optimizer"].state_dict(),
                    "scheduler": (None if state.get("scheduler") is None
                                  else state["scheduler"].state_dict()),
                    "step": int(state["step"]), "generator": state["generator"].get_state()}
        host = runtime.broadcast_object(host, src=first, group=mesh.whole)
        if mesh.process_rank != first:
            state["optimizer"].load_state_dict(host["optimizer"])
            if host["scheduler"] is not None:
                state["scheduler"].load_state_dict(host["scheduler"])
            state["step"] = host["step"]
            state["generator"].set_state(host["generator"])
    if mesh.axis_size("model") > 1 or mesh.axis_size("expert") > 1:
        specs = tensor_parallel.shard_model(model, mesh)
        tensor_parallel.shard_optimizer_state(model, state["optimizer"], specs, mesh)
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


def allreduce_gradients(parameters: Iterable[torch.nn.Parameter], mesh: Mesh,
                        divide: int = 1) -> None:
    """Sum the ``.grad`` of ``parameters`` (those that have one) over the
    data axis, in flat buckets, then divide by ``divide``."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not mesh.collective:
        if divide != 1:
            for g in grads:
                g.div_(divide)
        return
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=mesh.group("data"))
        if divide != 1:
            flat.div_(divide)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        mesh.allreduced_bytes += flat.numel() * flat.element_size()


def sum_across(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``tensor`` summed over the data axis (as it is without a group)."""
    if not mesh.collective:
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out, group=mesh.group("data"))
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


def make_sharded_xe_step(model, mesh: Mesh):
    """(state, this rank's rows of the batch) -> (state, the global loss):
    one XE update over the mesh (see the module's docstring).  Under a
    ``model`` axis the loss is ``tensor_parallel.vocab_parallel_nll_sum``
    of the decoder's vocab-sharded logits, so no rank builds the full
    (rows, vocab) logits.  The state is ``steps.init_xe_state``'s."""
    from openviic_tpu_torch.parallel import tensor_parallel

    pad = model.vocab.padding_idx
    vocab_parallel = mesh.axis_size("model") > 1

    def update(state: dict, batch: Batch):
        def backward():
            targets = batch["shifted_right_caption_tokens"]
            count = sum_across((targets != pad).sum(), mesh)
            if vocab_parallel:
                hidden = model(batch, raw_logits="hidden")
                logits = model.decoder.fc.local(hidden).float()
                total = tensor_parallel.vocab_parallel_nll_sum(logits, targets, pad, mesh)
            else:
                total = nll_sum(model(batch), targets, pad)
            loss = total / count.clamp_min(1)
            loss.backward()
            allreduce_gradients(_trained(state), mesh)
            return sum_across(loss, mesh)

        return _train_update(model, state, backward, stream=mesh.rank)

    return update


def make_sharded_scst_step(model, beam_size: int, mesh: Mesh):
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

