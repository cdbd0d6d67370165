"""Dataset base: raw sample -> (image, packed target) pairs on the host.

Counterpart of ``rsis_tpu/data/base.py`` (``normalize_image``,
``resize_masks_nearest``, ``sequence_from_masks`` with the uint8 output
of ``rsis_tpu/kernels/_binding.pack_target``, ``unpack_target``,
``InstanceDataset``) for the uint8 wire the train step decodes on the
device: each sample is the resized uint8 image (H, W, 3) and the packed
target (gt_maxseqlen, H*W + 3) uint8 whose rows are [flattened binary
instance mask | class id | mask sample weight | class sample weight].
Instances are sorted by descending area, equal areas by ascending
instance id (the order of the JAX package's native packer), and
truncated or padded to gt_maxseqlen; the first padding slot keeps class
weight 1 so the model learns the <eos> class.

Pillow is imported only where an image must be resized: a sample already
at its size (the synthetic dataset) needs no Pillow. After the resize, in
the JAX package's order and from the dataset's one numpy generator
(seeded as the JAX package seeds it), so that both give the same bytes:
with ``augment`` (``--host_augment``, the train split) a coin flips the
sample horizontally; with ``crop`` (Pascal and CVPPP set it for batches
above 1, in evaluation too) it is cropped to imsize x imsize; with
``augment`` one fused affine (``data/augment.RandomAffine``, nearest, so
the image stays uint8) warps the image and both maps. Without
``augment`` the train step augments on the device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .augment import RandomAffine, horizontal_flip, random_crop

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 normalised with ImageNet statistics."""
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def _target_size(h: int, w: int, imsize: int, square: bool):
    """(height, width) of the resize: square, or the shorter side at
    imsize."""
    if square:
        return imsize, imsize
    if w < h:
        return max(1, round(imsize * h / w)), imsize
    return imsize, max(1, round(imsize * w / h))


def resize_image(img: np.ndarray, imsize: int, square: bool) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W, 3) image with Pillow, as the JAX
    package does; an image already at its size is returned as it is
    (Pillow's resize to the same size is a copy)."""
    h, w = img.shape[:2]
    nh, nw = _target_size(h, w, imsize, square)
    if (nh, nw) == (h, w):
        return img
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR),
                      dtype=np.uint8)


def resize_masks_nearest(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour (H0, W0) -> (h, w), matching scipy order-0 zoom."""
    ri = np.minimum((np.arange(h) * (mask.shape[0] / h)).round(),
                    mask.shape[0] - 1).astype(np.int64)
    ci = np.minimum((np.arange(w) * (mask.shape[1] / w)).round(),
                    mask.shape[1] - 1).astype(np.int64)
    return mask[np.ix_(ri, ci)]


def sequence_from_masks(ins: np.ndarray, seg: np.ndarray,
                        max_seq_len: int) -> np.ndarray:
    """Split an instance map (ids > 0 are instances) into the packed uint8
    target (max_seq_len, H*W + 3), as the JAX package's uint8 wire packs
    it (its native ``pack_target``): one pass for the areas, one compare
    per kept instance. An instance's class is the smallest class id under
    it."""
    flat = ins.reshape(-1)
    segf = seg.reshape(-1)
    hw = flat.size
    areas = np.bincount(flat[flat > 0])
    ids = np.flatnonzero(areas)
    total = len(ids)
    # descending area; the stable sort keeps equal areas in ascending id
    kept = ids[np.argsort(-areas[ids], kind="stable")][:max_seq_len]
    out = np.zeros((max_seq_len, hw + 3), dtype=np.uint8)
    for row, inst_id in enumerate(kept):
        sel = flat == inst_id
        out[row, :hw] = sel
        out[row, hw] = segf[sel].min()
        out[row, hw + 1:] = 1
    if max_seq_len > total:
        out[total, hw + 2] = 1  # <eos> slot trains the class head
    return out


def unpack_target(targets: np.ndarray):
    """(B, N, H*W+3) -> (y_mask, y_class, sw_mask, sw_class)."""
    y_mask = targets[:, :, :-3]
    y_class = targets[:, :, -3].astype(np.int32)
    sw_mask = targets[:, :, -2]
    sw_class = targets[:, :, -1]
    return y_mask, y_class, sw_mask, sw_class


class InstanceDataset:
    """Base class; subclasses implement file discovery and
    ``get_raw_sample`` -> (image uint8 (H, W, 3), instance map, class
    map)."""

    classes: Sequence[str] = ()

    def __init__(self, cfg, split: str = "train", augment: bool = False,
                 imsize: int = 256, resize: bool = False, crop: bool = False,
                 seed: int = 0):
        self.cfg = cfg
        self.split = split
        self.imsize = imsize
        self.resize = resize
        self.crop = crop
        self.flip = augment
        self.max_seq_len = cfg.gt_maxseqlen
        self.rng = np.random.default_rng(seed)
        self.affine = None
        if augment:
            # zoom only where the image is resized, and for Pascal, whose
            # range also zooms in
            zoom = (None if (not resize and cfg.dataset != "pascal")
                    else ((cfg.zoom, max(cfg.zoom * 2, 1.0))
                          if cfg.dataset == "pascal" else (cfg.zoom, 1.0)))
            self.affine = RandomAffine(
                rotation_range=cfg.rotation,
                translation_range=cfg.translation, shear_range=cfg.shear,
                zoom_range=zoom, interp="nearest", rng=self.rng)

    def get_raw_sample(self, index: int):
        raise NotImplementedError

    def get_sample_list(self):
        return self.image_files  # type: ignore[attr-defined]

    def get_classes(self):
        return list(self.classes)

    def __len__(self):
        return len(self.image_files)  # type: ignore[attr-defined]

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(image uint8 (H, W, 3), packed target uint8 (N, H*W + 3))."""
        img, ins, seg = self.get_raw_sample(index)
        img = resize_image(np.asarray(img, dtype=np.uint8), self.imsize,
                           square=self.resize)
        h, w = img.shape[:2]
        ins = resize_masks_nearest(np.asarray(ins), h, w)
        seg = resize_masks_nearest(np.asarray(seg), h, w)
        if self.flip or self.crop:
            img_chw = np.moveaxis(img, -1, 0)
            # the draws' order (coin, crop, affine) is the JAX package's
            if self.flip and self.rng.random() < 0.5:
                img_chw, ins, seg = horizontal_flip([img_chw, ins, seg])
            if self.crop:
                img_chw, ins, seg = random_crop(
                    [img_chw, ins, seg], (self.imsize, self.imsize),
                    self.rng)
            if self.affine is not None:
                img_chw, ins, seg = self.affine(img_chw, ins, seg)
            img = np.ascontiguousarray(np.moveaxis(img_chw, 0, -1))
        if int(np.max(seg, initial=0)) > 255 or int(np.min(seg,
                                                          initial=0)) < 0:
            raise ValueError("a class id does not fit the uint8 wire")
        return img, sequence_from_masks(np.asarray(ins, np.int64), seg,
                                        self.max_seq_len)
