"""Offline Pascal preprocessing: palette PNGs -> (H, W, 2) .npy + COCO GT.

Counterpart of ``rsis_tpu/data/tools/pascal_precompute.py``: a copy on the
port's RLE library.

Re-design of the reference tool (reference:
src/dataloader/pascal_precompute.py): for each image in a split, decode the
SegmentationClass / SegmentationObject palette PNGs into a stacked
(H, W, 2) [seg | ins] array saved under ``ProcMasks/``, and accumulate a
COCO-format GT annotation list (one RLE per instance, plus per-class ignore
annotations for the 255-labelled ignore regions, flagged ``ignore=1``)
pickled as ``VOCGT_<split>.pkl`` — the file the evaluator loads
(reference: src/eval.py:196-213).

Usage: python -m rsis_tpu_torch.data.tools.pascal_precompute \
    --pascal_dir D --split S
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
from PIL import Image

from ...kernels import mask as maskUtils
from ..catalogs import PASCAL_CLASSES
from .palettes import convert_from_color_segmentation


def create_annotation(imname: str, gt_mask: np.ndarray, class_id: int,
                      score: float, crowd: int) -> dict:
    seg = (gt_mask > 0.5).astype(np.uint8)
    rle = maskUtils.encode(np.asfortranarray(seg))
    return {"image_id": imname.rstrip(),
            "category_id": int(class_id),
            "category_name": PASCAL_CLASSES[class_id],
            "segmentation": {"size": rle["size"],
                             "counts": rle["counts"].decode("ascii")},
            "score": score,
            "area": int(seg.sum()),
            "iscrowd": crowd,
            "ignore": crowd}


def precompute(image_name: str, data_dir: str, ignore_id: int = 255):
    idx = image_name.rstrip()
    seg_png = os.path.join(data_dir, "SegmentationClass", idx + ".png")
    ins_png = os.path.join(data_dir, "SegmentationObject", idx + ".png")
    seg = np.asarray(Image.open(seg_png).convert("RGB"))
    ins = np.asarray(Image.open(ins_png).convert("RGB"))
    seg = convert_from_color_segmentation(seg).astype(np.int64)
    ins = convert_from_color_segmentation(ins).astype(np.int64)

    ignore_mask = (seg == ignore_id).astype(np.uint8)
    ins[seg == ignore_id] = 0
    seg[seg == ignore_id] = 0
    masks = np.stack([seg, ins], axis=-1)
    return masks, (ignore_mask if ignore_mask.any() else None)


def make_coco(name: str, masks: np.ndarray, ignore_mask):
    seg, ins = masks[:, :, 0], masks[:, :, 1]
    anns = []
    for inst_id in np.unique(ins):
        if inst_id == 0:
            continue
        class_id = int(np.unique(seg[ins == inst_id])[0])
        gt = (ins == inst_id).astype(np.float32)
        anns.append(create_annotation(name, gt, class_id, 1.0, 0))
    if ignore_mask is not None:
        for cid in range(1, len(PASCAL_CLASSES)):
            anns.append(create_annotation(name, ignore_mask.astype(
                np.float32), cid, 1.0, 1))
    return anns


def run(pascal_dir: str, split: str, force: bool = False) -> str:
    save_dir = os.path.join(pascal_dir, "ProcMasks")
    os.makedirs(save_dir, exist_ok=True)
    split_f = os.path.join(pascal_dir, "ImageSets", "Segmentation",
                           split + ".txt")
    with open(split_f) as fp:
        names = [ln.strip() for ln in fp if ln.strip()]
    gt_annotations = []
    for name in names:
        npy_path = os.path.join(save_dir, name + ".npy")
        if not os.path.isfile(npy_path) or force:
            masks, ignore_mask = precompute(name, pascal_dir)
            np.save(npy_path, masks)
        else:
            masks, ignore_mask = precompute(name, pascal_dir)
        gt_annotations.extend(make_coco(name, masks, ignore_mask))
    out = os.path.join(pascal_dir, f"VOCGT_{split}.pkl")
    with open(out, "wb") as fp:
        pickle.dump(gt_annotations, fp)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pascal_dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--forcegen", action="store_true")
    args = p.parse_args(argv)
    out = run(args.pascal_dir, args.split, args.forcegen)
    print("Saved COCO-like GT:", out)


if __name__ == "__main__":
    main()
