"""Training entry point: ``python -m rsis_tpu_torch.cli.train -model_name ...``

Counterpart of ``rsis_tpu/cli/train.py``: the same flags (those of the
port's ``Config``). The run trains on the CUDA device unless the caller of
``main`` passes another device; without a card it raises. Data
parallelism runs one process a device (``parallel/distributed.py``):

  - by default one process: one GPU (or the CPU), no process group;
  - ``-num_devices N`` (N > 1; 0 = every visible GPU): N ranks on this
    host, spawned on a localhost coordinator, rank i on ``cuda:i`` over
    NCCL, or N CPU ranks over gloo when ``device="cpu"``;
  - ``-coordinator HOST:PORT -num_processes N -process_id I``, or
    ``--multihost`` under a launcher that sets ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (e.g.
    ``torchrun``): this process is one rank.
"""

from __future__ import annotations

import socket

import torch

from ..config import config_from_args
from ..device import resolve_device
from ..parallel.distributed import initialize, shutdown
from ..parallel.mesh import create_mesh
from ..train.loop import train


def _ranks_here(cfg, device) -> int:
    """How many ranks ``-num_devices`` asks for on this host."""
    n = cfg.num_devices
    dev = resolve_device(device, "cli.train")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = n or count
        if n > count:
            raise ValueError(f"-num_devices {n}: {count} GPUs are visible "
                             f"and a process drives one")
    return max(n, 1)


def _run_rank(cfg, device, coordinator, num_processes, process_id,
              auto=False):
    """Join the process group and train as one of its ranks."""
    initialize(coordinator, num_processes, process_id, auto=auto,
               device=device)
    try:
        group = create_mesh(cfg.num_devices if not auto else 0,
                            device=device)
        if group.device.type == "cpu":
            torch.set_num_threads(max(1, torch.get_num_threads()
                                      // group.size))
        return train(cfg, device=group.device, group=group)
    finally:
        shutdown()


def _spawned(rank, cfg, device, coordinator, n):
    _run_rank(cfg, device, coordinator, n, rank)


def main(argv=None, device=None):
    """Parse argv (default: the command line) and train; returns the final
    TrainState (None in the parent of ranks spawned by ``-num_devices``,
    whose rank 0 writes the checkpoints and ``metrics.jsonl``)."""
    cfg = config_from_args(argv)
    if (cfg.multihost or cfg.coordinator is not None
            or cfg.num_processes is not None):
        return _run_rank(cfg, device, cfg.coordinator, cfg.num_processes,
                         cfg.process_id, auto=cfg.multihost)
    n = _ranks_here(cfg, device)
    if n == 1:
        return train(cfg, device=device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.start_processes(
        _spawned, args=(cfg.replace(num_devices=n), device,
                        f"127.0.0.1:{port}", n),
        nprocs=n, start_method="spawn")
    return None


if __name__ == "__main__":
    main()
