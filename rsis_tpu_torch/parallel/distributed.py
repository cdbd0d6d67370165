"""Multi-process launch: one process a device.

Counterpart of ``rsis_tpu/parallel/distributed.py`` (``initialize``,
``global_batch_slice``). JAX runs one process a host over all of its
devices; here one process drives one GPU (``cuda:<local rank>``), so a
host with N cards runs N processes, and every process runs the same
training script. Launch contract:

    python -m rsis_tpu_torch.cli.train ... -num_devices N
        (one host: N ranks spawned on a localhost coordinator)
    python -m rsis_tpu_torch.cli.train ... \\
        -coordinator <host0>:<port> -num_processes N -process_id i
        (one command a rank, on any host)
    torchrun --nproc_per_node N ... -m rsis_tpu_torch.cli.train ... \\
        --multihost
        (the launcher's MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
        LOCAL_RANK: the counterpart of Cloud-TPU auto-discovery)

Omitting all of them is an explicit single-process run. The backend is
NCCL for CUDA devices and gloo for the CPU. Each rank's loader yields the
identically seeded GLOBAL batch and keeps its own contiguous rows
(``parallel/mesh.shard_batch``), as in JAX's multi-host contract.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None, local_rank: Optional[int] = None,
                caller: str = "initialize") -> torch.device:
    """The device this rank drives: ``device`` (default cuda; raises
    without a card), a CUDA device without an index becoming
    ``cuda:<local rank>``."""
    device = resolve_device(device, caller)
    if device.type == "cuda" and device.index is None:
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", process_index()))
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               auto: bool = False, device=None) -> bool:
    """Join the process group. Returns True when more than one process
    takes part, False for the single-process no-op.

    coordinator is ``host:port`` of rank 0 (``tcp://`` rendezvous);
    auto=True (``--multihost``) reads the launcher's environment
    instead. With neither, nothing happens: no auto-detection, since N
    unsynchronised replicas would be worse than requiring a flag.
    ``device`` (default cuda; raises without a card) picks the backend,
    NCCL for CUDA and gloo for the CPU; a CUDA rank is bound to
    ``cuda:<local rank>`` unless the device names its index."""
    local_rank = None
    if auto:
        missing = [k for k in _LAUNCH_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"--multihost needs the launcher's "
                               f"environment; missing {missing}")
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    elif coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs -coordinator, "
                         "-num_processes and -process_id together")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    device = rank_device(device, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)
    return num_processes > 1


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_batch_slice(global_batch: int) -> tuple[int, int]:
    """(rows a rank, offset) of this rank's contiguous shard of a global
    batch."""
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    return per, per * process_index()
