"""Batched exact rectangular linear assignment (the train-step matcher).

Counterpart of ``rsis_tpu/ops/pallas_matching.py::solve_lap_batch`` (the
Pallas ``_lap_kernel``). Each (nr, nc) problem, nr <= nc <= 128, is solved
by shortest augmenting paths with dual potentials (Crouse 2016, the
formulation of scipy's linear_sum_assignment): one Dijkstra over the
columns per row, the dual update, the augmentation. The result is
``row4col``: the 0-indexed row assigned to each column, -1 for unassigned
columns. Ties of the reduced cost go to an unassigned column, then to the
lowest index.

On a CUDA tensor ``solve_lap_batch`` launches the hand-written kernel
``csrc/lap.cu`` (one warp a problem, its costs staged once into shared
memory from the caller's strides, its state in registers; the whole batch
in one launch, the result left on the device); on a CPU tensor it runs
``solve_lap_batch_ref``, the plain version: the same algorithm as a Python
loop over numpy float32 vectors, with the same fp32 operations in the same
order, so the two give the same row4col.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

MAX_N = 128
_INF = np.float32(1e9)


def _solve_one(cost: np.ndarray, stats: dict | None = None) -> np.ndarray:
    """row4col of one (nr, nc) float32 cost matrix, nr <= nc. stats, when
    given, counts the Dijkstra steps (each relaxes all nc columns): their
    total in stats["scans"], the most any one problem took in
    stats["max_scans"]."""
    nr, nc = cost.shape
    u = np.zeros(nr, np.float32)
    v = np.zeros(nc, np.float32)
    r4c = np.full(nc, -1, np.int64)
    c4r = np.full(nr, -1, np.int64)
    cols = np.arange(nc)
    scans = 0
    for cur_row in range(nr):
        spc = np.full(nc, _INF, np.float32)
        pred = np.zeros(nc, np.int64)
        sc = np.zeros(nc, bool)
        sr = np.zeros(nr, bool)
        sink, icur, min_val = -1, cur_row, np.float32(0.0)
        while sink == -1:
            scans += 1
            sr[icur] = True
            red = min_val + cost[icur] - u[icur] - v
            upd = ~sc & (red < spc)
            spc[upd] = red[upd]
            pred[upd] = icur
            dm = np.where(sc, _INF, spc)
            lowest = dm.min()
            # tie-break toward an unassigned column, then the lowest index
            ties = (dm == lowest) & (r4c < 0)
            j = int(cols[ties][0] if ties.any() else cols[dm == lowest][0])
            rj = int(r4c[j])
            sc[j] = True
            min_val = lowest
            if rj < 0:
                sink = j
            else:
                icur = rj
        rows = np.flatnonzero(sr)
        others = rows[rows != cur_row]
        u[others] = u[others] + (min_val - spc[c4r[others]])
        u[cur_row] = u[cur_row] + min_val
        reached = sc & (spc < _INF * np.float32(0.5))
        v[reached] = v[reached] - (min_val - spc[reached])
        j = sink
        while j >= 0:
            ipred = int(pred[j])
            jnext = int(c4r[ipred])
            r4c[j] = ipred
            c4r[ipred] = j
            j = -1 if ipred == cur_row else jnext
    if stats is not None:
        stats["scans"] = stats.get("scans", 0) + scans
        stats["max_scans"] = max(stats.get("max_scans", 0), scans)
    return r4c


def solve_lap_batch_ref(costs: torch.Tensor,
                        stats: dict | None = None) -> torch.Tensor:
    """Plain version: costs (B, nr, nc) -> row4col (B, nc) int32 on the
    costs' device (solved on the host). stats as in ``_solve_one``."""
    c = costs.detach().to("cpu", torch.float32).numpy()
    out = np.stack([_solve_one(c[i], stats) for i in range(c.shape[0])])
    return torch.from_numpy(out.astype(np.int32)).to(costs.device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lap")
    lib.rsis_lap.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                             + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    lib.rsis_lap.restype = ctypes.c_int
    return lib


def _check_shape(costs: torch.Tensor) -> tuple:
    if costs.dim() != 3:
        raise ValueError(
            f"costs must be (B, nr, nc), not {tuple(costs.shape)}")
    b, nr, nc = costs.shape
    if not 0 < nr <= nc <= MAX_N:
        raise ValueError(f"need 0 < nr <= nc <= {MAX_N}, got {nr}, {nc}")
    return b, nr, nc


def lap_launch_args(costs: torch.Tensor) -> tuple:
    """(B, nr, nc, batch stride, row stride, column stride) of the kernel's
    launch on costs, strides in elements (a dimension of size 1 counts as
    stride 1). Raises TypeError on a dtype other than float32 and
    ValueError on a shape the kernel does not take or on strides it cannot
    read: neither the rows nor the columns at unit stride (its staging
    reads along a unit stride)."""
    b, nr, nc = _check_shape(costs)
    if costs.dtype != torch.float32:
        raise TypeError(f"LAP kernel takes float32, not {costs.dtype}")
    sb, sr, sc = costs.stride()
    sr = 1 if nr == 1 else sr
    sc = 1 if nc == 1 else sc
    if sr != 1 and sc != 1:
        raise ValueError(f"LAP kernel needs the rows or the columns of the "
                         f"costs at unit stride, got strides {costs.stride()}")
    return b, nr, nc, sb, sr, sc


def solve_lap_batch(costs: torch.Tensor) -> torch.Tensor:
    """Batched exact rectangular LAP.

    Args:
      costs: (B, nr, nc), nr <= nc <= 128 (rows = predictions, columns =
        ground-truth slots).
    Returns:
      (B, nc) int32 row4col: the 0-indexed row assigned to each column, -1
      for the nc - nr unassigned columns.

    CPU tensors take the plain version. CUDA tensors (float32, the rows or
    the columns at unit stride: ``lap_launch_args``; a transposed view is
    read as it lies) launch ``csrc/lap.cu`` and count one launch in
    ``solve_lap_batch.launches``."""
    _check_shape(costs)
    if costs.device.type == "cpu":
        return solve_lap_batch_ref(costs)
    if costs.device.type != "cuda":
        raise ValueError(f"no kernel for device {costs.device}")
    b, nr, nc, sb, sr, sc = lap_launch_args(costs)
    out = torch.empty((b, nc), dtype=torch.int32, device=costs.device)
    with torch.cuda.device(costs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rsis_lap(costs.data_ptr(), out.data_ptr(), b, nr, nc,
                              sb, sr, sc, stream)
    if err != 0:
        raise RuntimeError(f"LAP kernel launch failed: CUDA error {err}")
    solve_lap_batch.launches += 1
    return out


solve_lap_batch.launches = 0
