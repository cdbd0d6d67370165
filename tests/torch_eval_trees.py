"""Miniature on-disk dataset trees for the port's evaluation tests: CVPPP
A1, Cityscapes gtFine and Pascal VOC (palette PNGs), built from numpy
seeds in the layouts of ``tests/test_cli_integration.py``."""

import os

import numpy as np
from PIL import Image


def blob_image(rng, s=48, n=2, w=None):
    """A random uint8 (s, w, 3) image and a uint8 map of n round blobs."""
    w = w or s
    img = rng.integers(0, 255, (s, w, 3), dtype=np.uint8)
    ins = np.zeros((s, w), dtype=np.uint8)
    yy, xx = np.ogrid[:s, :w]
    for i in range(1, n + 1):
        cy = rng.integers(8, s - 8)
        cx = rng.integers(8, w - 8)
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) <= rng.integers(16, 64)
        ins[blob] = i
    return img, ins


def leaves_tree(root, n=98, s=48, w=None, seed=0):
    """CVPPP A1: n plants; the split takes the first 96 for train."""
    d = os.path.join(root, "A1")
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, ins = blob_image(rng, s=s, w=w)
        Image.fromarray(img).save(os.path.join(d, f"plant{i:03d}_rgb.png"))
        Image.fromarray(ins).save(os.path.join(d, f"plant{i:03d}_label.png"))
    return d


def cityscapes_tree(root, n=2, s=64, w=None, seed=1):
    """Cityscapes gtFine val of one city: label ids person (24), car (26),
    caravan (29) and trailer (30), which the catalog drops, and a crowd
    region (id < 1000)."""
    root = os.path.join(root, "cs")
    w = w or s
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "leftImg8bit", "val", "cityA")
    gt_dir = os.path.join(root, "gtFine", "val", "cityA")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    for i in range(n):
        img, blobs = blob_image(rng, s=s, n=5, w=w)
        ids = np.zeros((s, w), dtype=np.int32)
        for k, iid in enumerate((24000, 26003, 29001, 30000, 24), start=1):
            ids[blobs == k] = iid
        labels = np.where(ids >= 1000, ids // 1000, ids).astype(np.uint8)
        name = f"cityA_{i:06d}_000019"
        Image.fromarray(img).save(
            os.path.join(img_dir, f"{name}_leftImg8bit.png"))
        Image.fromarray(ids.astype(np.uint16)).save(
            os.path.join(gt_dir, f"{name}_gtFine_instanceIds.png"))
        Image.fromarray(labels).save(
            os.path.join(gt_dir, f"{name}_gtFine_labelIds.png"))
    return root


def pascal_tree(root, palette, n=3, s=40, w=None, seed=2):
    """VOC layout: JPEGImages, SegmentationClass/Object palette PNGs (a
    person, a car and a 255 ignore border) and the split lists."""
    w = w or s
    root = os.path.join(root, "voc")
    for sub in ["JPEGImages", "SegmentationClass", "SegmentationObject",
                "ImageSets/Segmentation"]:
        os.makedirs(os.path.join(root, sub))
    inv = {v: k for k, v in palette.items()}
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        name = f"2007_{i:06d}"
        names.append(name)
        img, ins = blob_image(rng, s=s, n=2, w=w)
        Image.fromarray(img).save(
            os.path.join(root, "JPEGImages", f"{name}.jpg"))
        seg_rgb = np.zeros((s, w, 3), dtype=np.uint8)
        obj_rgb = np.zeros((s, w, 3), dtype=np.uint8)
        seg_rgb[ins == 1] = inv[15]   # person
        seg_rgb[ins == 2] = inv[7]    # car
        obj_rgb[ins == 1] = inv[1]
        obj_rgb[ins == 2] = inv[2]
        seg_rgb[:2] = obj_rgb[:2] = inv[255]
        Image.fromarray(seg_rgb).save(
            os.path.join(root, "SegmentationClass", f"{name}.png"))
        Image.fromarray(obj_rgb).save(
            os.path.join(root, "SegmentationObject", f"{name}.png"))
    for split in ["train", "val", "test"]:
        with open(os.path.join(root, "ImageSets/Segmentation",
                               f"{split}.txt"), "w") as fp:
            fp.write("\n".join(names) + "\n")
    return root
