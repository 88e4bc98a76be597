"""Data parallel across processes (the port's counterpart of
``openviic_tpu/parallel``'s runtime and the data axis of its mesh)."""

from openviic_tpu_torch.parallel.mesh import (
    DataMesh,
    allreduce_gradients,
    batch_shard,
    make_mesh,
    make_sharded_scst_step,
    make_sharded_xe_step,
    shard_state,
)
from openviic_tpu_torch.parallel.runtime import (
    barrier,
    initialize_distributed,
    process_count,
    process_index,
)

__all__ = [
    "DataMesh",
    "allreduce_gradients",
    "barrier",
    "batch_shard",
    "initialize_distributed",
    "make_mesh",
    "make_sharded_scst_step",
    "make_sharded_xe_step",
    "process_count",
    "process_index",
    "shard_state",
]
