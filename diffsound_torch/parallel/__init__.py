"""Multi-pair training over a (dp, ep) process mesh: dp over material pairs,
ep over element shards, on torch.distributed (gloo on the CPU, NCCL on
CUDA at one card per rank).  Counterpart of `diffsound_tpu/parallel/`."""

from .mesh import DeviceMesh, init_distributed, make_device_mesh
from .ops import ShardedFEM, pad_element_ops, shard_element_ops

__all__ = ["DeviceMesh", "init_distributed", "make_device_mesh", "ShardedFEM",
           "pad_element_ops", "shard_element_ops"]
