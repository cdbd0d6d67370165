"""Dataset catalogs: Pascal VOC (+SBD), Cityscapes, CVPPP leaves, the
synthetic blobs, and the factory.

Counterpart of ``rsis_tpu/data/catalogs.py`` (``PascalVOC``,
``CityScapes``, ``LeavesDataset``, ``SyntheticBlobs``, the class tables,
``CITYSCAPES_LABEL_IDS``, ``get_dataset``): the same file discovery, class
tables, id remapping, crops, host augmentation and seeds (``cfg.seed``
for every dataset), so each dataset gives the JAX package's raw samples
and network inputs. Raw images are uint8 (H, W, 3)
numpy arrays (the JAX package keeps PIL images); Pillow is imported only
to read image files. ``SyntheticBlobs`` makes the same procedural
instance maps from the same seeds, so its uint8 wire samples are
byte-identical to the JAX package's ``SyntheticBlobs(...,
wire_dtype="uint8")``.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import InstanceDataset

PASCAL_CLASSES = ["<eos>", "airplane", "bicycle", "bird", "boat",
                  "bottle", "bus", "car", "cat", "chair",
                  "cow", "dining table", "dog", "horse",
                  "motorcycle", "person", "potted plant",
                  "sheep", "sofa", "train", "tv"]

CITYSCAPES_CLASSES = ["<eos>", "person", "rider", "car", "truck", "bus",
                      "train", "motorcycle", "bicycle"]

LEAVES_CLASSES = ["<eos>", "leaf"]

# official cityscapes label ids of the 8 trained instance classes
CITYSCAPES_LABEL_IDS = [24, 25, 26, 27, 28, 31, 32, 33]


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _read_array(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im, dtype=np.int64)


class PascalVOC(InstanceDataset):
    """Pascal VOC 2012 (+SBD) with precomputed (H, W, 2) seg/ins .npy masks
    (``data/tools/pascal_precompute.py``); crops when batches hold more
    than one image."""

    classes = PASCAL_CLASSES

    def __init__(self, cfg, split="train", augment=False, imsize=256,
                 resize=False, seed=0):
        super().__init__(cfg, split=split, augment=augment, imsize=imsize,
                         resize=resize, crop=cfg.batch_size > 1, seed=seed)
        self.image_dir = os.path.join(cfg.pascal_dir, "JPEGImages")
        self.masks_dir = os.path.join(cfg.pascal_dir, "ProcMasks")
        split_f = os.path.join(cfg.pascal_dir, "ImageSets", "Segmentation",
                               split + ".txt")
        with open(split_f) as fp:
            self.image_files = [ln.strip() for ln in fp if ln.strip()]

    def get_raw_sample(self, index):
        name = self.image_files[index]
        img = _read_rgb(os.path.join(self.image_dir, name + ".jpg"))
        mask = np.load(os.path.join(self.masks_dir, name + ".npy"))
        return img, mask[:, :, 1], mask[:, :, 0]


class CityScapes(InstanceDataset):
    """Cityscapes gtFine instance segmentation, 8 classes + <eos>: label
    ids 24-28, 31-33 map to 1..8, caravan (29) and trailer (30) are
    dropped, instance ids renumber densely."""

    classes = CITYSCAPES_CLASSES

    def __init__(self, cfg, split="train", augment=False, imsize=256,
                 resize=False, seed=0):
        super().__init__(cfg, split=split, augment=augment, imsize=imsize,
                         resize=resize, crop=cfg.crop, seed=seed)
        self.image_files = sorted(glob.glob(os.path.join(
            cfg.cityscapes_dir, "leftImg8bit", split, "*", "*.png")))
        self.ins_files = [
            f.replace("/leftImg8bit/", "/gtFine/")
            .replace("_leftImg8bit.png", "_gtFine_instanceIds.png")
            for f in self.image_files]

    def get_raw_sample(self, index):
        img = _read_rgb(self.image_files[index])
        ins = _read_array(self.ins_files[index])
        seg = ins // 1000  # label id of instance pixels; 0 for crowd/stuff
        # drop caravan & trailer, then remap 24..28,31..33 -> 1..8
        seg[(seg == 29) | (seg == 30)] = 0
        seg[seg > 0] -= 23
        seg[seg == 8] = 6
        seg[seg == 9] = 7
        seg[seg == 10] = 8
        ins = ins * (seg > 0)
        ins[ins < 24000] = 0
        # dense renumbering of the surviving ids in ascending order (the
        # smallest, background 0, stays 0)
        _, dense = np.unique(ins, return_inverse=True)
        return img, dense.reshape(ins.shape).astype(np.int64), seg


class LeavesDataset(InstanceDataset):
    """CVPPP A1 leaf segmentation: 2 classes, the first 96 images train,
    the rest validate, the test split is a separate directory without
    labels; crops when batches hold more than one image."""

    classes = LEAVES_CLASSES

    def __init__(self, cfg, split="train", augment=False, imsize=256,
                 resize=False, seed=0):
        super().__init__(cfg, split=split, augment=augment, imsize=imsize,
                         resize=resize, crop=cfg.batch_size > 1, seed=seed)
        all_images = sorted(glob.glob(os.path.join(cfg.leaves_dir,
                                                   "*_rgb.png")))
        all_gt = [f.replace("_rgb", "_label") for f in all_images]
        if split == "train":
            self.image_files = all_images[:96]
            self.gt_files = all_gt[:96]
        elif split == "val":
            self.image_files = all_images[96:]
            self.gt_files = all_gt[96:]
        else:  # test: separate dir, no GT
            self.image_files = sorted(glob.glob(os.path.join(
                cfg.leaves_test_dir, "*_rgb.png")))
            self.gt_files = []

    def get_raw_sample(self, index):
        img = _read_rgb(self.image_files[index])
        if self.split == "test":
            fake = np.zeros(img.shape[:2], dtype=np.int64)
            return img, fake, fake
        gt = _read_array(self.gt_files[index])
        return img, gt.copy(), (gt > 0).astype(np.int64)


class SyntheticBlobs(InstanceDataset):
    """Procedural instance maps for tests and benchmarks (no disk needed):
    ``length`` square images of ``imsize`` pixels, each with 1 to
    ``max_instances`` elliptic blobs of random classes."""

    # per-split seed offsets so val/test content differs from train
    _SPLIT_SEED = {"train": 0, "val": 50_000, "test": 100_000}

    def __init__(self, cfg, split="train", augment=False, imsize=64,
                 resize=True, seed=0, length=16, max_instances=4):
        super().__init__(cfg, split=split, augment=augment, imsize=imsize,
                         resize=resize, seed=seed)
        self.classes = ["<eos>"] + [f"class{i}"
                                    for i in range(1, cfg.num_classes)]
        self.image_files = [f"synthetic_{split}_{i:04d}"
                            for i in range(length)]
        self.max_instances = max_instances
        self._cache = {}

    def get_raw_sample(self, index):
        if index in self._cache:
            return self._cache[index]
        rng = np.random.default_rng(
            10_000 + index + self._SPLIT_SEED.get(self.split, 0))
        s = self.imsize
        img = rng.integers(0, 255, (s, s, 3), dtype=np.uint8)
        ins = np.zeros((s, s), dtype=np.int64)
        seg = np.zeros((s, s), dtype=np.int64)
        n = int(rng.integers(1, self.max_instances + 1))
        yy, xx = np.ogrid[:s, :s]
        for i in range(1, n + 1):
            cy, cx = rng.integers(0, s, 2)
            ry, rx = rng.integers(s // 8, s // 3, 2)
            blob = (((yy - cy) / max(ry, 1)) ** 2
                    + ((xx - cx) / max(rx, 1)) ** 2) <= 1
            cls = int(rng.integers(1, len(self.classes)))
            ins[blob] = i
            seg[blob] = cls
            img[blob] = (img[blob] * 0.3
                         + np.array([60 * cls % 255] * 3) * 0.7).astype(
                             np.uint8)
        out = (img, ins, seg)
        self._cache[index] = out
        return out


# the file-backed catalogs, read from cfg.<name>_dir
FILE_DATASETS = {
    "pascal": PascalVOC,
    "cityscapes": CityScapes,
    "leaves": LeavesDataset,
}


def get_dataset(cfg, split: str, augment: bool = False) -> InstanceDataset:
    """The dataset of ``cfg.dataset`` for one split, on the uint8 wire,
    its generator seeded with ``cfg.seed``; ``augment`` flips and warps
    each sample on the host."""
    common = dict(split=split, augment=augment, imsize=cfg.imsize,
                  resize=cfg.resize, seed=cfg.seed)
    if cfg.dataset == "synthetic":
        return SyntheticBlobs(cfg, length=cfg.synthetic_length,
                              max_instances=cfg.synthetic_max_instances,
                              **common)
    return FILE_DATASETS[cfg.dataset](cfg, **common)
