"""Parallelism over ranks: the (data, fsdp, tensor) mesh, FSDP sharding
and ring attention (port of ``hivae_tpu/parallel``)."""

from .mesh import AXES, Mesh, create_mesh, init_distributed, local_mesh
from .sharding import batch_rows, infer_param_sharding, shard_model
