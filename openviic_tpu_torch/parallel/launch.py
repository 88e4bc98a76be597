"""One run over a host's cards: the port's counterpart of the JAX trainer's
single-host mesh (``openviic_tpu/training/trainer.py:243-257``).

One JAX process drives every local device, and its trainer goes data
parallel over ``data_axis = gcd(FEATURE_BATCH_SIZE, devices)`` of them
(the first ``data_axis``) when ``TRAINING.DATA_PARALLEL`` is on (the
default); ``GRAD_ACCUM > 1`` is then refused.  In PyTorch's idiom a
process drives one card, so ``spawn`` starts one process a device, as the
ranks of one process group over ``tcp://localhost:<port>`` (NCCL on the
cards, gloo on the CPU), marked ``runtime.host_local()``: the trainer then
reads ``FEATURE_BATCH_SIZE`` as the global batch, each rank drawing its
order with the same seed and reading only its own rows of each batch (the
loader's ``part``), the native loader allowed.  ``python -m openviic_tpu_torch.train`` without
``torchrun`` calls it over ``cuda:0 .. cuda:<data_axis - 1>``.  A rank
that fails ends every rank, and ``spawn`` raises."""

from __future__ import annotations

import math
import socket
from typing import Callable, Optional, Sequence

import torch

from openviic_tpu_torch.parallel import runtime


def data_axis(config, devices: int) -> int:
    """How many of ``devices`` local devices the JAX trainer's single-host
    mesh takes for ``config``: gcd(FEATURE_BATCH_SIZE, devices) with
    ``TRAINING.DATA_PARALLEL`` on, else 1.  Raises JAX's ``ValueError`` for
    ``GRAD_ACCUM > 1`` over more than one."""
    tr = config.TRAINING
    axis = math.gcd(int(config.DATASET.FEATURE_BATCH_SIZE), int(devices)) if devices > 0 else 1
    if axis <= 1 or not tr.get("DATA_PARALLEL", True):
        return 1
    if int(tr.get("GRAD_ACCUM", 1)) > 1:
        raise ValueError("TRAINING.GRAD_ACCUM is for single-device training; with a "
                         "data-parallel mesh, scale the batch across devices instead (or set "
                         "TRAINING.DATA_PARALLEL: false)")
    return axis


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(index: int, fn: Callable, devices: Sequence[str], port: int,
          backend: Optional[str], args: tuple) -> None:
    device = torch.device(devices[index])
    runtime.initialize_distributed(device, backend=backend,
                                   init_method=f"tcp://localhost:{port}",
                                   world_size=len(devices), rank=index, host_local=True)
    try:
        fn(device, *args)
    finally:
        runtime.shutdown()


def spawn(fn: Callable, devices: Sequence[str], args: tuple = (),
          backend: Optional[str] = None, join: bool = True):
    """Run ``fn(device, *args)`` in one new process a device of ``devices``
    (e.g. ``["cuda:0", "cuda:1"]``, or ``["cpu", "cpu"]``), as the ranks of
    one host-local process group (``backend``: NCCL on cards, gloo on the
    CPU, by default).  ``fn`` and ``args`` must pickle (a module-level
    function).  Waits for every rank and raises if one fails (the others
    are then ended); with ``join=False`` returns the
    ``torch.multiprocessing`` context to ``join()``."""
    import torch.multiprocessing as mp

    return mp.start_processes(_rank, args=(fn, list(devices), free_port(), backend, args),
                              nprocs=len(devices), join=join, start_method="spawn")
