"""The process-group runtime (the port's counterpart of
``openviic_tpu/parallel/runtime.py``).

``initialize_distributed(device)`` starts ``torch.distributed`` when the
process was started by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) or is given an ``init_method`` with its
world size and rank, and is a no-op in a single process, so the same entry
points run everywhere.  The backend is NCCL on a card and gloo on the CPU,
unless the caller names one.  The device is the caller's: the runtime makes
it the current card and never derives one from ``LOCAL_RANK``.  Nothing
falls back: a card asked for and absent, or an NCCL group that does not
start or fails its first collective, raises.

A group that ``parallel/launch.py`` starts (``host_local=True``) is one
host's cards driven as the JAX trainer drives one process's devices
(``host_local()``); one started by ``torchrun`` stands for the JAX
package's hosts.

The helpers below are what the trainer and the data axis need from the
group: ``process_index``, ``process_count``, ``barrier`` (the JAX trainer's
``_mh_barrier``), and small collectives over host values
(``broadcast_object``, ``all_gather_object``, ``any_across``) that work on
either backend."""

from __future__ import annotations

import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from openviic_tpu_torch.utils import setup_logger

logger = setup_logger()

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

_host_local = False  # whether parallel/launch.py started the group


def initialize_distributed(device, backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, host_local: bool = False) -> bool:
    """Start the process group for ``device`` and return True, or return
    False in a single process (no ``init_method`` and not all of
    ``TORCHRUN_ENV`` set).  ``backend`` defaults to ``nccl`` for a card and
    ``gloo`` for the CPU; ``init_method`` (``tcp://localhost:<port>``) takes
    ``world_size`` and ``rank``, else torchrun's environment gives them.
    ``host_local`` marks a group of one host's cards (``host_local()``).
    A group already started is kept (True)."""
    global _host_local
    device = torch.device(device)
    if dist.is_initialized():
        return True
    if init_method is None and not all(k in os.environ for k in TORCHRUN_ENV):
        return False
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"initialize_distributed: {device} asked for and no CUDA device "
                               "is available; pass the CPU to train on gloo")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank))
    _host_local = bool(host_local)
    # the first collective: a group that cannot run one fails here, not at
    # the first gradient
    probe = torch.ones(1, device=collective_device())
    dist.all_reduce(probe)
    if int(probe.item()) != dist.get_world_size():
        raise RuntimeError(f"initialize_distributed: the {backend} group's first all-reduce "
                           f"gave {probe.item()} over {dist.get_world_size()} ranks")
    logger.info("torch.distributed started: rank %d of %d on %s over %s", dist.get_rank(),
                dist.get_world_size(), device, backend)
    return True


def host_local() -> bool:
    """Whether the group is one host's cards started by ``parallel/launch.py``
    (the JAX trainer's single-host mesh), not ``torchrun``'s hosts."""
    return _host_local and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The group's size (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def collective_device() -> torch.device:
    """Where the group's tensors must lie: the current card under NCCL,
    else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(tag: str) -> None:
    """Wait until every rank reaches this barrier (a no-op in one process);
    ``tag`` names it at the call site, as the JAX trainer names its
    barriers."""
    if process_count() <= 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """Rank ``src``'s ``obj`` on every rank of ``group`` (the whole group by
    default; picklable host values)."""
    if process_count() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group, device=collective_device())
    return box[0]


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order."""
    if process_count() <= 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def any_across(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (``process_allgather(...).any()``)."""
    if process_count() <= 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def shutdown() -> None:
    """Destroy the process group, if one was started."""
    global _host_local
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_local = False
