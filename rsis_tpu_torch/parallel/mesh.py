"""Data-parallel groups, batch sharding and the collectives the port uses.

Counterpart of ``rsis_tpu/parallel/mesh.py`` (``create_mesh``,
``create_multislice_mesh``, ``batch_sharding``, ``replicated``,
``shard_batch``). JAX shards a batch over a device mesh and XLA inserts
the reductions; here each rank is a process with its own device, a
``Group`` names the ranks, and the reductions are written out:

  - ``shard_batch``: this rank's contiguous rows of the global batch;
  - ``replicate``: rank 0's tensors broadcast to every rank (the
    counterpart of ``replicated``: parameters are the same everywhere);
  - ``all_reduce_tensors_``: a list of tensors (the gradients) summed over
    the ranks in place, flattened into a few buckets;
  - ``Group.all_reduce_`` / ``all_gather`` / ``broadcast_`` /
    ``barrier``, and ``global_batch_stats``, under which BatchNorm
    normalises over the global batch (``models/backbones.py``);
  - ``halo``: a row slab with its neighbours' boundary rows, and
    ``sharded_rows``, under which the backbones' convolutions and max
    pools run on H-sharded slabs (``evals/streaming.py``).

On the gloo backend a CUDA tensor goes through pinned host memory (gloo
does not take every operation on CUDA tensors; two ranks that share one
GPU must use gloo, since NCCL will not place two ranks on one device).
NCCL takes CUDA tensors directly.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.profiling import span
from .distributed import rank_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# gradient buckets: a few flat all-reduces a step, not one per tensor
BUCKET_BYTES = 64 << 20


@dataclass
class Group:
    """The ranks a batch (or an image's rows) is sharded over.

    rank and size are this process's place in the flattened grid and the
    number of ranks; device is the device this rank computes on; pg the
    process group (None: one process, no collective runs); mesh the 2-D
    (dcn, data) ``DeviceMesh`` of ``create_multislice_mesh``, which names
    the grid and this rank's coordinates (every reduction runs over pg:
    NCCL's all-reduce already follows the topology)."""
    rank: int
    size: int
    device: torch.device
    pg: Optional[dist.ProcessGroup] = None
    mesh: Optional[object] = None

    @property
    def active(self) -> bool:
        """Whether collectives run (a process group exists)."""
        return self.pg is not None

    def _staged(self) -> bool:
        return dist.get_backend(self.pg) == "gloo"

    def _run(self, t: torch.Tensor, fn) -> torch.Tensor:
        """fn(tensor) on t, through pinned host memory where gloo meets a
        CUDA tensor; the result lands in t."""
        if t.device.type == "cuda" and self._staged():
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            fn(host)
            t.copy_(host)
        else:
            fn(t)
        return t

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """t reduced over every rank, in place (t must be contiguous)."""
        if self.active:
            self._run(t, lambda x: dist.all_reduce(
                x, op=_OPS[op], group=self.pg))
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's t (the same shape on each), in rank order."""
        if not self.active:
            return [t]
        src = t.contiguous()
        staged = src.device.type == "cuda" and self._staged()
        if staged:
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            src = host.copy_(src)
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.pg)
        if staged:
            out = [o.to(t.device, non_blocking=True) for o in out]
        return out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank src's t on every rank, in place (pg is the world group, so
        the rank is global)."""
        if self.active:
            self._run(t, lambda x: dist.broadcast(
                x, src=src, group=self.pg))
        return t

    def barrier(self) -> None:
        if self.active:
            if dist.get_backend(self.pg) == "nccl":
                dist.barrier(group=self.pg,
                             device_ids=[self.device.index or 0])
            else:
                dist.barrier(group=self.pg)


def create_mesh(num_devices: int = 0, device=None) -> Group:
    """The data-parallel group of this process: every rank of the process
    group (``parallel.distributed.initialize``), or one rank without one.
    num_devices (0: all) must match the ranks there are: a process drives
    one device. device: this rank's (default cuda:<local rank>; raises
    without a card)."""
    device = rank_device(device, caller="create_mesh")
    if not dist.is_initialized():
        if num_devices > 1:
            raise ValueError(f"{num_devices} devices need {num_devices} "
                             f"processes: initialize the process group "
                             f"first (one process a device)")
        return Group(0, 1, device)
    size = dist.get_world_size()
    if num_devices and num_devices != size:
        raise ValueError(f"num_devices {num_devices} != the {size} ranks "
                         f"of the process group (one process a device)")
    return Group(dist.get_rank(), size, device, pg=dist.group.WORLD)


def create_multislice_mesh(num_slices: int, per_slice: int = 0,
                           device=None) -> Group:
    """The 2-D (dcn, data) grid of multi-slice training: the outer axis
    across slices (hosts), the inner one within a slice. The batch is
    sharded over the flattened grid, slice-major; reductions run over
    the whole process group. Needs the process group,
    with num_slices x per_slice ranks."""
    device = rank_device(device, caller="create_multislice_mesh")
    if not dist.is_initialized():
        raise ValueError("create_multislice_mesh needs the process group")
    from torch.distributed.device_mesh import init_device_mesh
    size = dist.get_world_size()
    per_slice = per_slice or size // num_slices
    if num_slices * per_slice != size:
        raise ValueError(f"{num_slices} x {per_slice} grid != the {size} "
                         f"ranks of the process group")
    mesh = init_device_mesh(device.type, (num_slices, per_slice),
                            mesh_dim_names=("dcn", "data"))
    i, j = mesh.get_coordinate()
    return Group(i * per_slice + j, size, device, pg=dist.group.WORLD,
                 mesh=mesh)


def shard_batch(group: Group, batch):
    """This rank's contiguous rows of every array (numpy or torch) of a
    global batch (a tuple, list or dict), the same global batch on every
    rank. An uneven batch is an error, not padding: pad rows would leak
    into the BatchNorm statistics and the stop loss's balance weight (the
    loaders drop the last short batch instead)."""
    leaves = batch.values() if isinstance(batch, dict) else batch
    for leaf in leaves:
        if leaf.shape[0] % group.size != 0:
            raise ValueError(
                f"global batch {leaf.shape[0]} not divisible by data-axis "
                f"size {group.size}; use a divisible batch size (loaders "
                f"drop_last)")

    def rows(x):
        per = x.shape[0] // group.size
        return x[group.rank * per:(group.rank + 1) * per]

    if group.size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return type(batch)(rows(x) for x in batch)


def _buckets(tensors: Sequence[torch.Tensor]):
    """Consecutive runs of one dtype and device, at most BUCKET_BYTES
    each (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != cur[0].dtype or t.device != cur[0].device
                    or size + nbytes > BUCKET_BYTES):
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nbytes
    if cur:
        out.append(cur)
    return out


def _flat(group: Group, tensors: Sequence[torch.Tensor], run) -> None:
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        run(flat)
        offset = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_reduce_tensors_(group: Group, tensors: Sequence[torch.Tensor],
                        op: str = "sum") -> None:
    """Reduce every tensor over the ranks, in place, a bucket at a time."""
    if group.active:
        with span("rsis.allreduce"):
            _flat(group, tensors, lambda f: group.all_reduce_(f, op))


@torch.no_grad()
def replicate(group: Group, tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values of every tensor on every rank, in place."""
    if group.active:
        _flat(group, tensors, group.broadcast_)


_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "rsis_batch_stats_group", default=None)


@contextlib.contextmanager
def global_batch_stats(group: Optional[Group]):
    """Within the block, BatchNorm in train mode normalises with the
    statistics of the global batch over ``group``'s ranks
    (``models/backbones.GlobalBatchNorm``; a one-rank group without a
    process group runs the same arithmetic alone). None: ``F.batch_norm``."""
    token = _STATS_GROUP.set(group)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


def batch_stats_group() -> Optional[Group]:
    """The group of ``global_batch_stats``, if one is set."""
    return _STATS_GROUP.get()


def rows_of(group: Optional[Group], local: int):
    """(offset, global) rows of this rank's shard of ``local`` rows a
    rank, or None at one rank: random draws are made at the global shape
    and each rank keeps its rows."""
    if group is None or group.size == 1:
        return None
    return group.rank * local, group.size * local



_ROW_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "rsis_row_group", default=None)


@contextlib.contextmanager
def sharded_rows(group: Optional[Group]):
    """Within the block, the backbones' convolutions and max pools take
    NCHW slabs of an image whose rows are sharded over ``group``'s ranks
    and read their windows' rows beyond the slab from the neighbours
    (``models/backbones.Conv2d``, ``MaxPool2d``). None: whole images."""
    token = _ROW_GROUP.set(group)
    try:
        yield
    finally:
        _ROW_GROUP.reset(token)


def row_group() -> Optional[Group]:
    """The group of ``sharded_rows``, if one is set."""
    return _ROW_GROUP.get()


def halo(x: torch.Tensor, group: Group, top: int, bottom: int, dim: int,
         fill: float = 0.0) -> torch.Tensor:
    """x (this rank's rows along ``dim``) with ``top`` rows of the rank
    above and ``bottom`` rows of the rank below around it; ``fill`` where
    the image ends. Every rank sends its first ``bottom`` and last ``top``
    rows in one all_gather (the same on NCCL and gloo, and free of the
    deadlocks of mismatched send/recv pairs)."""
    if top == 0 and bottom == 0:
        return x
    n = x.shape[dim]
    if max(top, bottom) > n:
        raise ValueError(f"a halo of {top}/{bottom} rows around a slab of "
                         f"{n}")
    strips = torch.cat([x.narrow(dim, 0, bottom),
                        x.narrow(dim, n - top, top)], dim=dim)
    got = group.all_gather(strips)
    r = group.rank

    def edge(rows):
        shape = list(x.shape)
        shape[dim] = rows
        return x.new_full(shape, fill)

    above = got[r - 1].narrow(dim, bottom, top) if r > 0 else edge(top)
    below = (got[r + 1].narrow(dim, 0, bottom) if r + 1 < group.size
             else edge(bottom))
    return torch.cat([above, x, below], dim=dim)
