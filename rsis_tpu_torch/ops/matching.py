"""Batched optimal assignment of ground truth to predictions, on device.

Counterpart of ``rsis_tpu/ops/matching.py`` (``_perm_from_row4col``,
``hungarian_pallas``, ``match_gt_to_predictions``). The (B, N, M) cost
tensor (rows = GT slots, columns = predictions, N >= M) is solved as the
transposed (M, N) rectangle by ``ops/lap.py::solve_lap_batch`` (the CUDA
kernel on the card, reading the transposed view in place; its plain
version on the CPU), and the row4col result
becomes the (B, N) ``perm`` in torch ops on the costs' device: perm[b, j]
is the GT row matched to prediction j for j < M, then the unmatched GT
rows in ascending order (the zero-cost-pad convention of the reference's
Munkres). Any cost-optimal assignment is acceptable to every caller.
"""

from __future__ import annotations

import torch

from .lap import solve_lap_batch, solve_lap_batch_ref


def perm_from_row4col(row4col: torch.Tensor, m: int) -> torch.Tensor:
    """(B, N) row4col (0-indexed prediction per GT slot, -1 = unmatched)
    -> (B, N) int64 perm."""
    b, n = row4col.shape
    taken = row4col >= 0
    gt = torch.arange(n, device=row4col.device).expand(b, n)
    # unmatched slots scatter into a dropped extra column m
    idx = torch.where(taken, row4col.long(), torch.full_like(gt, m))
    head = torch.zeros((b, m + 1), dtype=torch.long, device=row4col.device)
    head.scatter_(1, idx, gt)
    order = torch.argsort(torch.where(taken, n + gt, gt), dim=1)
    return torch.cat([head[:, :m], order[:, :n - m]], dim=1)


def hungarian(costs: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Batched optimal assignment.

    Args:
      costs: (B, N, M), N >= M (rows = GT slots, columns = predictions).
      plain: solve with the plain version on any device.
    Returns:
      (B, N) int64 perm, perm[b, j] = the GT row assigned to prediction j
      (columns >= M get the leftover rows ascending)."""
    b, n, m = costs.shape
    if m > n:
        raise ValueError("more prediction columns than GT rows")
    solve = solve_lap_batch_ref if plain else solve_lap_batch
    # the kernel reads the transposed view as it lies: no copy
    row4col = solve(costs.transpose(1, 2).float())
    return perm_from_row4col(row4col, m)


def match_gt_to_predictions(y_mask: torch.Tensor, y_class: torch.Tensor,
                            costs: torch.Tensor, solver=hungarian):
    """Reorder the ground truth to the prediction order.

    y_mask (B, N, HW), y_class (B, N), costs (B, N, M) -> (y_mask_perm,
    y_class_perm, perm), GT index t matched to prediction step t."""
    perm = solver(costs)
    y_mask_perm = torch.gather(
        y_mask, 1, perm[:, :, None].expand(-1, -1, y_mask.shape[-1]))
    y_class_perm = torch.gather(y_class, 1, perm)
    return y_mask_perm, y_class_perm, perm
