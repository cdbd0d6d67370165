"""CVPPP leaf segmentation metrics: SymmetricBestDice and |DiC|.

Counterpart of ``rsis_tpu/evals/cvppp.py``: a copy.

Python reimplementation of the third-party MATLAB evaluators the reference
relies on (reference: src/CVPPP/SymmetricBestDice.m:48-53,
src/CVPPP/BestDice.m:49-93, src/CVPPP/AbsDiffFGLabels.m:49-66,
src/CVPPP/evaluation.m:17-31). Operates on integer label images where 0 is
background and each positive label is one leaf instance.
"""

from __future__ import annotations

import numpy as np


def dice_score(a: np.ndarray, b: np.ndarray) -> float:
    """Dice = 2|A n B| / (|A| + |B|) between two binary masks."""
    inter = np.logical_and(a, b).sum()
    denom = a.sum() + b.sum()
    return float(2.0 * inter / denom) if denom > 0 else 0.0


def best_dice(in_label: np.ndarray, gt_label: np.ndarray) -> float:
    """Mean over labels of ``in_label`` of the best Dice vs any gt label."""
    in_ids = np.unique(in_label)
    in_ids = in_ids[in_ids != 0]
    gt_ids = np.unique(gt_label)
    gt_ids = gt_ids[gt_ids != 0]
    if len(in_ids) == 0:
        return 0.0
    total = 0.0
    for i in in_ids:
        a = in_label == i
        best = 0.0
        for j in gt_ids:
            best = max(best, dice_score(a, gt_label == j))
        total += best
    return total / len(in_ids)


def symmetric_best_dice(in_label: np.ndarray, gt_label: np.ndarray) -> float:
    """SBD = min(BestDice(in, gt), BestDice(gt, in))."""
    return min(best_dice(in_label, gt_label), best_dice(gt_label, in_label))


def diff_fg_labels(in_label: np.ndarray, gt_label: np.ndarray) -> int:
    """DiC = (#predicted leaves) - (#GT leaves)."""
    n_in = len(np.unique(in_label)) - (1 if (in_label == 0).any() else 0)
    n_gt = len(np.unique(gt_label)) - (1 if (gt_label == 0).any() else 0)
    return int(n_in - n_gt)


def abs_diff_fg_labels(in_label: np.ndarray, gt_label: np.ndarray) -> int:
    """|DiC|."""
    return abs(diff_fg_labels(in_label, gt_label))


def evaluate_batch(pred_labels, gt_labels):
    """Average SBD and |DiC| over pairs, like evaluation.m."""
    sbds, dics = [], []
    for p, g in zip(pred_labels, gt_labels):
        sbds.append(symmetric_best_dice(p, g))
        dics.append(abs_diff_fg_labels(p, g))
    return {"SBD": float(np.mean(sbds)) if sbds else 0.0,
            "absDiC": float(np.mean(dics)) if dics else 0.0,
            "n": len(sbds)}


def fgbg_dice(in_label: np.ndarray, gt_label: np.ndarray) -> float:
    """Foreground/background Dice (reference: src/CVPPP/FGBGDice.m)."""
    return dice_score(in_label > 0, gt_label > 0)
