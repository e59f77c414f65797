"""Data and tensor parallelism of the port, one process per device.

Port of ``oaprogressionmmf_tpu/parallel/``: :mod:`.dcn` starts the
process group (NCCL on the GPU, gloo on the CPU) and gives each process
its data shard; :mod:`.mesh` holds the data-parallel group (replicated
parameters, the gradient all-reduce, a BatchNorm over the global batch);
:mod:`.tp` shards the FeaT stacks Megatron-style over a dp×tp grid.
"""

from .dcn import data_shard_for_process, initialize_distributed
from .mesh import DataParallel, GlobalBatchNorm2d, create_group

__all__ = ["DataParallel", "GlobalBatchNorm2d", "create_group",
           "data_shard_for_process", "initialize_distributed"]
