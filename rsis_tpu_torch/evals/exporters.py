"""Official-format exporters: Cityscapes instance PNGs and CVPPP labels.

Counterpart of ``rsis_tpu/evals/exporters.py``
(``largest_connected_component``, ``resize_nearest``,
``CityscapesExporter``, ``LeavesExporter``), with the forward on the
exporter's device (``HostForward``).

Cityscapes: per predicted timestep, threshold the mask, keep the largest
connected component, resize to the native size, and write per-instance
PNGs plus a ``.txt`` index of ``masks/<name> <label_id> <score>`` lines for
the official cityscapesScripts evaluator (train-id -> label-id table
24,25,26,27,28,31,32,33).

CVPPP: paint instances into one indexed label image per plant, gated by
stop score > class_th, saved as ``*_label.png`` for the SBD/|DiC| metrics.
As in the JAX package, instances are painted with label ``t + 1``: the
reference paints label ``t``, which erases the first (largest) instance
into background.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
from PIL import Image

from ..config import Config
from ..data.base import normalize_image
from ..data.catalogs import CITYSCAPES_LABEL_IDS, get_dataset
from ..data.pipeline import DataLoader
from .forward import HostForward


def largest_connected_component(mask: np.ndarray) -> np.ndarray:
    """Binary mask of the largest foreground blob (8-neighbour labelling
    approximated with scipy's default 4-connectivity like skimage default)."""
    from scipy import ndimage
    labeled, n = ndimage.label(mask)
    if n == 0:
        return np.zeros_like(mask, dtype=np.uint8)
    counts = np.bincount(labeled.ravel())
    counts[0] = 0
    return (labeled == counts.argmax()).astype(np.uint8)


def resize_nearest(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    ri = np.minimum((np.arange(h) * (mask.shape[0] / h)).astype(np.int64),
                    mask.shape[0] - 1)
    ci = np.minimum((np.arange(w) * (mask.shape[1] / w)).astype(np.int64),
                    mask.shape[1] - 1)
    return mask[np.ix_(ri, ci)]


class CityscapesExporter:
    def __init__(self, cfg: Config, variables, dataset=None, device=None):
        self.cfg = cfg
        self.variables = variables
        self.dataset = dataset or get_dataset(cfg, cfg.eval_split)
        self.loader = DataLoader(self.dataset, batch_size=cfg.batch_size,
                                 shuffle=False, drop_last=False,
                                 num_workers=cfg.num_workers)
        self.sample_list = self.dataset.get_sample_list()
        self.forward = HostForward(cfg, device=device)

    def export(self, results_dir: str) -> List[str]:
        cfg = self.cfg
        os.makedirs(results_dir, exist_ok=True)
        masks_dirname = cfg.model_name + "_masks"
        masks_dir = os.path.join(results_dir, masks_dirname)
        os.makedirs(masks_dir, exist_ok=True)
        written = []
        acc = 0
        for imgs, _ in self.loader:
            masks, clss, stops = self.forward(self.variables,
                                              normalize_image(imgs))
            for s in range(masks.shape[0]):
                sample_path = self.sample_list[s + acc]
                raw_img = self.dataset.get_raw_sample(s + acc)[0]
                h, w = raw_img.shape[:2]
                name = os.path.basename(sample_path).split(".")[0]
                txt_path = os.path.join(results_dir, name + ".txt")
                instance_id = 0
                with open(txt_path, "w") as fp:
                    for t in range(masks.shape[1]):
                        binary = (masks[s, t] > cfg.mask_th).astype(np.uint8)
                        blob = largest_connected_component(binary)
                        native = resize_nearest(blob, h, w) * 255
                        objectness = float(stops[s, t, 0])
                        for k in range(len(CITYSCAPES_LABEL_IDS)):
                            score = float(clss[s, t, k + 1]) * objectness
                            inst_name = f"{name}_{instance_id}.png"
                            Image.fromarray(
                                native.astype(np.uint8)).save(
                                    os.path.join(masks_dir, inst_name))
                            fp.write(f"{masks_dirname}/{inst_name} "
                                     f"{CITYSCAPES_LABEL_IDS[k]} "
                                     f"{score}\n")
                            instance_id += 1
                written.append(txt_path)
            acc += masks.shape[0]
        return written


class LeavesExporter:
    def __init__(self, cfg: Config, variables, dataset=None, device=None):
        self.cfg = cfg
        self.variables = variables
        self.dataset = dataset or get_dataset(cfg, cfg.eval_split)
        self.loader = DataLoader(self.dataset, batch_size=cfg.batch_size,
                                 shuffle=False, drop_last=False,
                                 num_workers=cfg.num_workers)
        self.sample_list = self.dataset.get_sample_list()
        self.forward = HostForward(cfg, device=device)

    def export(self, results_dir: str) -> List[str]:
        cfg = self.cfg
        out_dir = os.path.join(results_dir, "A1")
        os.makedirs(out_dir, exist_ok=True)
        written = []
        acc = 0
        for imgs, _ in self.loader:
            masks, _, stops = self.forward(self.variables,
                                           normalize_image(imgs))
            for s in range(masks.shape[0]):
                sample_path = self.sample_list[s + acc]
                raw_img = self.dataset.get_raw_sample(s + acc)[0]
                h, w = raw_img.shape[:2]
                label_img = np.zeros((h, w), dtype=np.uint8)
                for t in range(masks.shape[1]):
                    if float(stops[s, t, 0]) <= cfg.class_th:
                        continue
                    native = resize_nearest(masks[s, t], h, w)
                    label_img[native > cfg.mask_th] = t + 1
                name = os.path.basename(sample_path).split(".")[0]
                out_name = name.replace("rgb", "label") + ".png"
                out_path = os.path.join(out_dir, out_name)
                Image.fromarray(label_img, mode="L").save(out_path)
                written.append(out_path)
            acc += masks.shape[0]
        return written

    def predicted_labels(self) -> Dict[str, np.ndarray]:
        """In-memory label images keyed by sample name (for direct SBD)."""
        cfg = self.cfg
        out = {}
        acc = 0
        for imgs, _ in self.loader:
            masks, _, stops = self.forward(self.variables,
                                           normalize_image(imgs))
            for s in range(masks.shape[0]):
                sample_path = self.sample_list[s + acc]
                raw_img = self.dataset.get_raw_sample(s + acc)[0]
                h, w = raw_img.shape[:2]
                label_img = np.zeros((h, w), dtype=np.uint8)
                for t in range(masks.shape[1]):
                    if float(stops[s, t, 0]) <= cfg.class_th:
                        continue
                    native = resize_nearest(masks[s, t], h, w)
                    label_img[native > cfg.mask_th] = t + 1
                out[os.path.basename(sample_path)] = label_img
            acc += masks.shape[0]
        return out
