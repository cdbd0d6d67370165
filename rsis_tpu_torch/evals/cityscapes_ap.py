"""Built-in Cityscapes instance-level AP evaluation.

Counterpart of ``rsis_tpu/evals/cityscapes_ap.py``: a copy.

The reference exports official-format predictions and defers scoring to the
external cityscapesScripts package (reference: src/eval_cityscapes.py +
README.md:86). This module makes the score self-contained: it consumes
either the exported ``<name>.txt`` + mask-PNG format or in-memory
predictions, and computes instance AP per class following the official
evalInstanceLevelSemanticLabeling protocol:

- GT instances come from ``*_gtFine_instanceIds.png``: pixels with
  ``id >= 1000`` belong to instance ``id`` of class ``id // 1000``; regions
  of an instance class with ``id < 1000`` are *group* regions;
- a prediction matches a GT instance of its class when
  IoU > threshold, thresholds sweep 0.50:0.05:0.95;
- unmatched predictions are excused (not counted FP) when more than the
  threshold fraction of their pixels lies on void or same-class group
  pixels;
- AP is the area under the precision/recall curve per class (greedy
  score-ordered matching), averaged over thresholds and classes.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from ..data.catalogs import CITYSCAPES_LABEL_IDS

THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def gt_instances_from_id_map(ins_map: np.ndarray):
    """Split a gtFine instanceIds map into per-class instances + ignore masks.

    Returns (instances, group_masks) where instances[label_id] is a list of
    boolean masks and group_masks[label_id] is the same-class crowd/group
    region (plus void handled separately by the caller).
    """
    instances: Dict[int, List[np.ndarray]] = defaultdict(list)
    groups: Dict[int, np.ndarray] = {}
    ids = np.unique(ins_map)
    for uid in ids:
        if uid < 1000:
            if uid in CITYSCAPES_LABEL_IDS:
                groups[int(uid)] = ins_map == uid
            continue
        label_id = int(uid) // 1000
        if label_id in CITYSCAPES_LABEL_IDS:
            instances[label_id].append(ins_map == uid)
    return instances, groups


def _void_mask(ins_map: np.ndarray) -> np.ndarray:
    """Pixels not belonging to any instance class (stuff/void/unlabeled)."""
    lab = np.where(ins_map >= 1000, ins_map // 1000, ins_map)
    return ~np.isin(lab, CITYSCAPES_LABEL_IDS)


def evaluate_images(gt_maps: Sequence[np.ndarray],
                    predictions: Sequence[Sequence[Tuple[np.ndarray, int,
                                                         float]]]):
    """Instance AP over a set of images.

    Args:
      gt_maps: per image, the raw gtFine instance-id map.
      predictions: per image, a list of (bool mask, label_id, confidence).
    Returns:
      {"allAp": float, "allAp50%": float, "classes": {label_id: ap}}
    """
    # per class, per threshold: list of (confidence, is_tp), and gt count
    per_class_gt = defaultdict(int)
    per_class_scores: Dict[int, Dict[float, List[Tuple[float, bool]]]] = \
        defaultdict(lambda: defaultdict(list))

    for ins_map, preds in zip(gt_maps, predictions):
        instances, groups = gt_instances_from_id_map(ins_map)
        void = _void_mask(ins_map)
        for label_id, inst_list in instances.items():
            per_class_gt[label_id] += len(inst_list)
        by_class: Dict[int, List[Tuple[np.ndarray, float]]] = \
            defaultdict(list)
        for mask, label_id, conf in preds:
            if mask.sum() == 0:
                continue
            by_class[int(label_id)].append((mask.astype(bool), float(conf)))

        for label_id, plist in by_class.items():
            gts = instances.get(label_id, [])
            ignore_region = void.copy()
            if label_id in groups:
                ignore_region |= groups[label_id]
            plist = sorted(plist, key=lambda x: -x[1])
            # IoU matrix predictions x gts
            ious = np.zeros((len(plist), len(gts)))
            for pi, (pm, _) in enumerate(plist):
                pa = pm.sum()
                for gi, gm in enumerate(gts):
                    inter = np.logical_and(pm, gm).sum()
                    if inter == 0:
                        continue
                    union = pa + gm.sum() - inter
                    ious[pi, gi] = inter / union
            ignore_frac = np.array(
                [np.logical_and(pm, ignore_region).sum() / max(pm.sum(), 1)
                 for pm, _ in plist])
            for th in THRESHOLDS:
                taken = np.zeros(len(gts), dtype=bool)
                for pi, (pm, conf) in enumerate(plist):
                    cand = np.where((ious[pi] > th) & ~taken)[0]
                    if len(cand):
                        gi = cand[np.argmax(ious[pi][cand])]
                        taken[gi] = True
                        per_class_scores[label_id][th].append((conf, True))
                    else:
                        # unmatched: excuse if mostly on void/group pixels
                        if ignore_frac[pi] <= th:
                            per_class_scores[label_id][th].append(
                                (conf, False))

    class_aps = {}
    class_ap50 = {}
    for label_id in CITYSCAPES_LABEL_IDS:
        n_gt = per_class_gt[label_id]
        if n_gt == 0:
            continue
        aps = []
        for th in THRESHOLDS:
            entries = sorted(per_class_scores[label_id][th],
                             key=lambda x: -x[0])
            if not entries:
                aps.append(0.0)
                continue
            tp = np.cumsum([e[1] for e in entries])
            fp = np.cumsum([not e[1] for e in entries])
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1)
            # area under the PR curve (right-continuous step integration
            # with monotone precision envelope)
            for i in range(len(precision) - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            prev_r = 0.0
            ap = 0.0
            for r, p in zip(recall, precision):
                ap += (r - prev_r) * p
                prev_r = r
            aps.append(float(ap))
        class_aps[label_id] = float(np.mean(aps))
        class_ap50[label_id] = float(aps[0])

    all_ap = float(np.mean(list(class_aps.values()))) if class_aps else 0.0
    all_ap50 = (float(np.mean(list(class_ap50.values())))
                if class_ap50 else 0.0)
    return {"allAp": all_ap, "allAp50%": all_ap50, "classes": class_aps}


def load_exported_predictions(results_dir: str, txt_name: str):
    """Load one exported prediction file (<name>.txt + mask PNGs)."""
    preds = []
    with open(os.path.join(results_dir, txt_name)) as fp:
        for line in fp:
            parts = line.split()
            if len(parts) != 3:
                continue
            rel, label_id, conf = parts
            mask = np.array(Image.open(
                os.path.join(results_dir, rel))) > 127
            preds.append((mask, int(label_id), float(conf)))
    return preds


def evaluate_exported(results_dir: str, gt_files: Sequence[str],
                      txt_names: Sequence[str]):
    """Score an export directory against gtFine instance-id PNGs."""
    gts = [np.array(Image.open(f), dtype=np.int64) for f in gt_files]
    preds = [load_exported_predictions(results_dir, t) for t in txt_names]
    return evaluate_images(gts, preds)
