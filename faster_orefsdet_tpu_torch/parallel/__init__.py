"""Data parallelism (counterpart of ``faster_orefsdet_tpu/parallel``):
training as ``torch.distributed`` ranks, serving and evaluation sharded
over a mesh of devices in one process."""

from .mesh import make_mesh
from .serve_dp import make_sharded_serving
from .train_dp import build_dp_train_step, replicate_state, shard_batch

__all__ = [
    "make_mesh",
    "make_sharded_serving",
    "build_dp_train_step",
    "replicate_state",
    "shard_batch",
]
