"""Multi-process start: the process group and each process's data shard.

Port of ``oaprogressionmmf_tpu/parallel/dcn.py``. Where JAX stitches one
process per host into one device set (``jax.distributed.initialize``),
the port runs one process per device and joins them in a
``torch.distributed`` process group: NCCL when the process runs on the
GPU, gloo when it runs on the CPU (``device="cpu"``, as the tests do).

Config (``runtime.distributed`` of ``run/conf/prog_fus.yaml``)::

    runtime:
      distributed:
        enable: true
        coordinator_address: "10.0.0.1:29500"   # rank 0's host:port
        num_processes: 8
        process_id: 0

A field left empty is read from torchrun's environment (``MASTER_ADDR``
and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), so ``torchrun
--nproc-per-node N -m oaprogressionmmf_torch.run.train_prog_fus ...``
needs no field at all. Each process binds ``cuda:LOCAL_RANK``.

The loaders' ``batch_size`` stays the batch of one process (the global
batch is ``batch_size × num_processes``), the JAX package's multi-host
semantics: each process reads a contiguous shard of every epoch's order
(``data/pipeline.py``'s ``shard_index``/``shard_count``).
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

logger = logging.getLogger(__name__)


def _field(dist_cfg, key: str, env_keys: tuple):
    value = dist_cfg.get(key)
    if value is not None:
        return value
    if all(k in os.environ for k in env_keys):
        return ":".join(os.environ[k] for k in env_keys)
    raise ValueError(f"runtime.distributed.{key} is not set and the "
                     f"environment has no {'/'.join(env_keys)} (launch with "
                     f"torchrun, or set the field)")


def initialize_distributed(runtime_cfg, device=None) -> tuple[int, int]:
    """Join the process group if ``runtime.distributed.enable`` is set;
    return this process's data shard ``(rank, world)``.

    ``device``: None binds ``cuda:LOCAL_RANK`` (LOCAL_RANK from torchrun,
    else the rank modulo the visible cards) and takes NCCL; ``"cpu"``
    takes gloo; an explicit CUDA device is bound as it is. Without
    ``distributed.enable`` this returns (0, 1) and touches nothing."""
    dist_cfg = (runtime_cfg or {}).get("distributed") or {}
    if not dist_cfg.get("enable", False):
        return 0, 1
    address = str(_field(dist_cfg, "coordinator_address",
                         ("MASTER_ADDR", "MASTER_PORT")))
    world = int(_field(dist_cfg, "num_processes", ("WORLD_SIZE",)))
    rank = int(_field(dist_cfg, "process_id", ("RANK",)))
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(
                f"a process group of rank {dist.get_rank()} in "
                f"{dist.get_world_size()} is already running; the config "
                f"asks for rank {rank} in {world}")
        return data_shard_for_process()
    if device is None:
        resolve_device(None)
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    logger.info(f"init_process_group({backend}, tcp://{address}, rank "
                f"{rank} of {world}) on {dev}")
    kwargs = {}
    if backend == "nccl":
        # NCCL binds its communicator to the card at init
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank, **kwargs)
    return data_shard_for_process()


def data_shard_for_process() -> tuple[int, int]:
    """``(shard_index, shard_count)`` = ``(rank, world)`` of the process
    group, (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()
