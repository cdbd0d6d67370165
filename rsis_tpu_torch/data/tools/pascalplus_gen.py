"""Offline Pascal+SBD merge: build the VOCAug training dataset.

Counterpart of ``rsis_tpu/data/tools/pascalplus_gen.py``: a copy, whose
PNGs and split files are byte-equal to JAX's (its quirks kept: GTinst read
as ``[0][0]`` with fields 0 and 2, the loop's break at instance 20, and
``random.Random(seed).shuffle`` of the sorted set).

Re-design of the reference tool (reference: src/dataloader/pascalplus_gen.py):
converts Hariharan SBD ("Contours") ``.mat`` instance GT into VOC-style
palette PNGs, merges the image lists with VOC 2012 train while excluding any
sample from the VOC val set (used as test — no leakage; reference:
pascalplus_gen.py:109-114), shuffles with a fixed seed, and writes
train/val/test split files.

Usage: python -m rsis_tpu_torch.data.tools.pascalplus_gen --contours_dir C \
         --voc_dir V --vocplus_dir OUT
"""

from __future__ import annotations

import argparse
import os
import random
import shutil

import numpy as np
from PIL import Image

from .palettes import pascal_palette


def _read_lines(path: str):
    with open(path) as fp:
        return [ln.strip() for ln in fp if ln.strip()]


def _write_lines(path: str, items):
    with open(path, "w") as fp:
        for it in items:
            fp.write(it + "\n")


def convert_mat_gt(contours_dir: str, vocplus_dir: str, split: str,
                   force: bool = False):
    """SBD .mat GT -> SegmentationClass / SegmentationObject palette PNGs."""
    from scipy.io import loadmat

    palette = pascal_palette()
    id_to_rgb = {v: k for k, v in palette.items()}
    names = _read_lines(os.path.join(contours_dir, split + ".txt"))
    for name in names:
        seg_png = os.path.join(vocplus_dir, "SegmentationClass",
                               name + ".png")
        obj_png = os.path.join(vocplus_dir, "SegmentationObject",
                               name + ".png")
        if os.path.isfile(seg_png) and os.path.isfile(obj_png) and not force:
            continue
        m = loadmat(os.path.join(contours_dir, "inst",
                                 name + ".mat"))["GTinst"][0][0]
        seg_object = m[0]
        classes = m[2]
        h, w = seg_object.shape
        sem = np.zeros((h, w, 3), dtype=np.uint8)
        ins = np.zeros((h, w, 3), dtype=np.uint8)
        for i in np.unique(seg_object):
            if i == 0:
                continue
            class_ins = int(classes[i - 1][0])
            sem[seg_object == i] = id_to_rgb[class_ins]
            # instance index doubles as a unique palette id
            ins[seg_object == i] = id_to_rgb[int(i)]
            if i == 20:
                break
        Image.fromarray(sem).save(seg_png)
        Image.fromarray(ins).save(obj_png)
    return names


def run(contours_dir: str, voc_dir: str, vocplus_dir: str,
        val_split: float = 0.10, copy: bool = True, force: bool = False,
        seed: int = 1337):
    for sub in ["SegmentationClass", "SegmentationObject", "ImageSets",
                "JPEGImages", os.path.join("ImageSets", "Segmentation")]:
        os.makedirs(os.path.join(vocplus_dir, sub), exist_ok=True)

    contours_train = convert_mat_gt(contours_dir, vocplus_dir, "train",
                                    force)
    contours_val = convert_mat_gt(contours_dir, vocplus_dir, "val", force)

    voc_train = _read_lines(os.path.join(voc_dir, "ImageSets",
                                         "Segmentation", "train.txt"))
    test_samples = _read_lines(os.path.join(voc_dir, "ImageSets",
                                            "Segmentation", "val.txt"))
    test_set = set(test_samples)

    samples = list(voc_train)
    samples += [s for s in contours_train if s not in test_set]
    samples += [s for s in contours_val if s not in test_set]
    samples = sorted(set(samples))
    random.Random(seed).shuffle(samples)

    sep = int(len(samples) * (1 - val_split))
    out_sets = os.path.join(vocplus_dir, "ImageSets", "Segmentation")
    _write_lines(os.path.join(out_sets, "train.txt"), samples[:sep])
    _write_lines(os.path.join(out_sets, "val.txt"), samples[sep:])
    _write_lines(os.path.join(out_sets, "test.txt"), test_samples)

    if copy:
        for src, dst in [
            (os.path.join(contours_dir, "img"), "JPEGImages"),
            (os.path.join(voc_dir, "SegmentationClass"),
             "SegmentationClass"),
            (os.path.join(voc_dir, "SegmentationObject"),
             "SegmentationObject"),
            (os.path.join(voc_dir, "JPEGImages"), "JPEGImages"),
        ]:
            shutil.copytree(src, os.path.join(vocplus_dir, dst),
                            dirs_exist_ok=True)
    return {"train": len(samples[:sep]), "val": len(samples[sep:]),
            "test": len(test_samples)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--contours_dir", required=True)
    p.add_argument("--voc_dir", required=True)
    p.add_argument("--vocplus_dir", required=True)
    p.add_argument("--val_split", default=0.10, type=float)
    p.add_argument("--force_gen", action="store_true")
    p.add_argument("--nocopy", dest="copy", action="store_false")
    args = p.parse_args(argv)
    counts = run(args.contours_dir, args.voc_dir, args.vocplus_dir,
                 args.val_split, args.copy, args.force_gen)
    print("All done.", counts)


if __name__ == "__main__":
    main()
