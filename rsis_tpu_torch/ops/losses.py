"""Training objectives.

Counterpart of ``rsis_tpu/ops/losses.py``: the reference losses written as
weighted means instead of ``masked_select``, so every loss keeps a static
shape. ``mean(masked_select(x, sw))`` equals ``sum(x * sw) / sum(sw)``
exactly. Mask logits may arrive in bf16 (the step stacks them in the
compute dtype); the losses upcast them to fp32 before the long sums.

Given a data-parallel ``group`` (``parallel/mesh.py``), each rank holds
its rows of the global batch and the losses keep JAX's global-batch
semantics: the denominators (the sum of the sample weights, the positive
fraction of the stop targets) are summed over the ranks, without
gradient, and each rank divides its own numerator by them. The global
loss is then the SUM of the ranks' losses, and so is its gradient.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def soft_iou_cost(target: torch.Tensor, logits: torch.Tensor,
                  eps: float = _EPS) -> torch.Tensor:
    """1 - soft IoU of binary targets (..., N) and mask logits (..., N)."""
    out = torch.sigmoid(logits.float())
    num = torch.sum(out * target, dim=-1)
    den = torch.sum(out + target - out * target, dim=-1) + eps
    return 1.0 - num / den


def soft_iou_cost_matmul(y_sum: torch.Tensor, y_cost: torch.Tensor,
                         logits: torch.Tensor,
                         eps: float = _EPS) -> torch.Tensor:
    """``soft_iou_cost`` of one prediction against all N GT masks.

    With I = sum(out * y) and S = sum(y), the union is sum(out) + S - I,
    so the (B, N) cost needs one contraction over HW.

    y_sum (B, N) fp32 pixel counts; y_cost (B, N, HW) binary masks in the
    contraction dtype; logits (B, HW). The sigmoid is rounded to y_cost's
    dtype and the contraction accumulates in fp32."""
    out = torch.sigmoid(logits.float())
    inter = torch.einsum("bh,bnh->bn", out.to(y_cost.dtype).float(),
                         y_cost.float())
    den = out.sum(dim=-1)[:, None] + y_sum - inter + eps
    return 1.0 - inter / den


def masked_nll(target_idx: torch.Tensor, probs: torch.Tensor,
               balance_weights: torch.Tensor | None = None,
               eps: float = 1e-12) -> torch.Tensor:
    """Per-element NLL of integer targets (...,) under probs (..., C)."""
    logp = torch.log(probs + eps)
    if balance_weights is not None:
        logp = logp * balance_weights
    return -torch.gather(logp, -1, target_idx.long()[..., None])[..., 0]


def _global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x (a denominator: no gradient) summed over the group's ranks."""
    if group is None or not group.active:
        return x
    return group.all_reduce_(x.detach().clone().contiguous())


def balanced_bce(target: torch.Tensor, logits: torch.Tensor,
                 balance_weight=None, group=None) -> torch.Tensor:
    """Stable class-balanced binary cross-entropy on logits: positive
    terms weighted (1 - bw), negative terms bw; bw None = the positive
    fraction of the target (of the global batch over ``group``)."""
    if balance_weight is None:
        ranks = 1 if group is None or not group.active else group.size
        balance_weight = (_global_sum(target.sum(), group)
                          / (target.numel() * ranks))
    max_val = torch.clamp(-logits, min=0.0)
    raw = (logits - logits * target + max_val
           + torch.log(torch.exp(-max_val) + torch.exp(-logits - max_val)))
    pos = raw * target
    neg = raw * (1.0 - target)
    return (1.0 - balance_weight) * pos + balance_weight * neg


def _weighted_mean(values: torch.Tensor, sw: torch.Tensor,
                   eps: float = 1e-12, group=None) -> torch.Tensor:
    sw = sw.to(values.dtype)
    return torch.sum(values * sw) / (_global_sum(torch.sum(sw), group)
                                     + eps)


def soft_iou_loss(y_true, y_logits, sw, group=None) -> torch.Tensor:
    """Mean soft-IoU cost over positions where sw == 1."""
    costs = soft_iou_cost(y_true, y_logits)
    return _weighted_mean(costs, sw.reshape(costs.shape), group=group)


def masked_nll_loss(y_true_idx, y_probs, sw, balance_weights=None,
                    group=None) -> torch.Tensor:
    """Mean class NLL over positions where sw == 1."""
    costs = masked_nll(y_true_idx, y_probs, balance_weights)
    return _weighted_mean(costs, sw.reshape(costs.shape), group=group)


def masked_bce_loss(y_true, y_logits, sw, balance_weight=None,
                    group=None) -> torch.Tensor:
    """Mean balanced BCE over positions where sw == 1."""
    costs = balanced_bce(y_true, y_logits, balance_weight, group)
    return _weighted_mean(costs, sw.reshape(costs.shape), group=group)
