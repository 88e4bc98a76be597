"""Parallelism across processes (the port's counterpart of
``openviic_tpu/parallel``): the process-group runtime; the mesh of named
axes over the group's ranks (``mesh.py``: the data axis's batch sharding,
state broadcast and sharded XE and SCST steps); tensor parallelism over a
``model`` axis and expert parallelism over an ``expert`` axis
(``tensor_parallel.py``: the rule tables, ``param_shardings``,
``shard_model``, the vocab-parallel loss and top-k); sequence parallelism
over a ``seq`` axis, the K/V ring (``ring_attention.py``) and Ulysses
(``ulysses.py``); GPipe pipelining over a ``pipe`` axis
(``pipeline.py``); their autograd-aware collectives
(``collectives.py``)."""

from openviic_tpu_torch.parallel.mesh import (
    Mesh,
    allreduce_gradients,
    batch_shard,
    make_mesh,
    make_sharded_scst_step,
    make_sharded_xe_step,
    shard_state,
)
from openviic_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipelined_encoder_apply,
    stack_layer_params,
)
from openviic_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_self_attention,
)
from openviic_tpu_torch.parallel.runtime import (
    barrier,
    initialize_distributed,
    process_count,
    process_index,
)
from openviic_tpu_torch.parallel.tensor_parallel import param_shardings, shard_model
from openviic_tpu_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_self_attention,
)

__all__ = [
    "Mesh",
    "allreduce_gradients",
    "barrier",
    "batch_shard",
    "initialize_distributed",
    "make_mesh",
    "make_sharded_scst_step",
    "make_sharded_xe_step",
    "param_shardings",
    "pipeline_apply",
    "pipelined_encoder_apply",
    "process_count",
    "process_index",
    "ring_attention",
    "ring_self_attention",
    "shard_model",
    "shard_state",
    "stack_layer_params",
    "ulysses_attention",
    "ulysses_self_attention",
]
