"""Dataset catalogs: the synthetic blobs, and the factory.

Counterpart of ``rsis_tpu/data/catalogs.py`` (``SyntheticBlobs``,
``get_dataset``). ``SyntheticBlobs`` makes the same procedural instance
maps from the same seeds, so its uint8 wire samples are byte-identical to
the JAX package's ``SyntheticBlobs(..., wire_dtype="uint8")``; the image
stays a numpy array (the JAX version wraps it in a PIL image). The
file-backed catalogs (Pascal VOC, Cityscapes, CVPPP leaves) are not in the
port yet: ``get_dataset`` raises for them.
"""

from __future__ import annotations

import numpy as np

from .base import InstanceDataset


class SyntheticBlobs(InstanceDataset):
    """Procedural instance maps for tests and benchmarks (no disk needed):
    ``length`` square images of ``imsize`` pixels, each with 1 to
    ``max_instances`` elliptic blobs of random classes."""

    # per-split seed offsets so val/test content differs from train
    _SPLIT_SEED = {"train": 0, "val": 50_000, "test": 100_000}

    def __init__(self, cfg, split="train", imsize=64, resize=True,
                 length=16, max_instances=4):
        super().__init__(cfg, split=split, imsize=imsize, resize=resize)
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


def get_dataset(cfg, split: str) -> InstanceDataset:
    """The dataset of ``cfg.dataset`` for one split, on the uint8 wire."""
    if cfg.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.dataset!r}: the file-backed catalogs are not in "
            f"the port yet (ROADMAP.md); use -dataset synthetic")
    return SyntheticBlobs(cfg, split=split, imsize=cfg.imsize,
                          resize=cfg.resize, length=cfg.synthetic_length,
                          max_instances=cfg.synthetic_max_instances)
