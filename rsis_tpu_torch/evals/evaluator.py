"""COCO-style evaluator (Pascal path) and shared helpers.

Counterpart of ``rsis_tpu/evals/evaluator.py`` (``resize_mask``,
``create_annotation``, ``create_coco_object``, ``Evaluator``): the forward
(``HostForward`` on the evaluator's device) produces per-timestep masks,
classes and stop scores; each kept mask is resized to the native image
size, thresholded, min-size filtered, ignore-masked, RLE-encoded with the
native library, and fanned out into one annotation per class with
score = class_prob * objectness. COCOeval then runs with
maxDets=[1, max_dets, 100]. The dataset yields uint8 images, normalised
here exactly as the JAX dataset normalises them.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..data.base import normalize_image
from ..data.catalogs import get_dataset
from ..data.pipeline import DataLoader
from ..kernels import mask as maskUtils
from .coco import COCO
from .cocoeval import COCOeval
from .forward import HostForward


def resize_mask(cfg: Config, pred_mask: np.ndarray, height: int, width: int,
                ignore_pixels: Optional[np.ndarray] = None):
    """Resize a sigmoid mask to native size, threshold, filter, RLE-encode.

    Returns (segmentation_rle, is_valid, raw_rle) like the reference.
    """
    from scipy.ndimage import zoom as ndi_zoom
    zoomed = ndi_zoom(pred_mask.astype(np.float64),
                      [height / pred_mask.shape[0],
                       width / pred_mask.shape[1]], order=1)
    seg = (zoomed > cfg.mask_th).astype(np.uint8)
    raw = seg.copy()
    if ignore_pixels is not None:
        seg[ignore_pixels == 1] = 0
    is_valid = seg.sum() >= cfg.min_size * height * width
    seg_rle = maskUtils.encode(np.asfortranarray(seg))
    raw_rle = maskUtils.encode(np.asfortranarray(raw))
    return seg_rle, bool(is_valid), raw_rle


def create_annotation(imname, rle, class_id, score, classes, is_valid=True):
    if not is_valid:
        return None
    counts = rle["counts"]
    if isinstance(counts, bytes):
        rle = {"size": rle["size"], "counts": counts.decode("ascii")}
    return {"image_id": imname, "category_id": int(class_id),
            "category_name": classes[class_id],
            "segmentation": rle, "score": float(score)}


def create_coco_object(cfg: Config, image_names, classes,
                       image_sizes: Optional[Dict] = None) -> COCO:
    """GT-shell COCO object (categories + images, no annotations)."""
    coco = {"categories": [{"id": i + 1, "name": c}
                           for i, c in enumerate(classes[1:])],
            "images": [], "annotations": []}
    for im in image_names:
        h, w = (image_sizes or {}).get(im, (300, 300))
        coco["images"].append({"height": h, "width": w, "id": im})
    ann_file = os.path.join(cfg.pascal_dir,
                            f"pascal_{cfg.eval_split}.json")
    try:
        with open(ann_file, "w") as fp:
            json.dump(coco, fp)
    except OSError:
        pass  # read-only data dir; COCO() accepts the dict directly
    return COCO(coco)


class Evaluator:
    """End-to-end eval: forward -> annotations -> COCOeval.

    variables: (encoder state_dict, decoder state_dict), the weights
    ``make_forward`` takes; device: the forward's (default cuda)."""

    def __init__(self, cfg: Config, variables, dataset=None, device=None):
        self.cfg = cfg
        self.variables = variables
        self.dataset = dataset or get_dataset(cfg, cfg.eval_split)
        self.loader = DataLoader(self.dataset, batch_size=cfg.batch_size,
                                 shuffle=False, drop_last=False,
                                 num_workers=cfg.num_workers)
        self.sample_list = self.dataset.get_sample_list()
        # O(1) name->index lookups and a native-size cache: one raw-image
        # read per sample per eval, instead of list.index() + re-opening in
        # both run_eval and create_annotations
        self._sample_index = {n: i for i, n in enumerate(self.sample_list)}
        self._native_sizes: Dict = {}
        self.class_names = self.dataset.get_classes()
        self.forward = HostForward(cfg, device=device)

        self.ignoremasks: Dict = {}
        self.gt_anns: Optional[List] = None
        if cfg.dataset == "pascal":
            gt_path = os.path.join(cfg.pascal_dir,
                                   f"VOCGT_{cfg.eval_split}.pkl")
            if os.path.exists(gt_path):
                with open(gt_path, "rb") as fp:
                    self.gt_anns = pickle.load(fp)
                for ann in self.gt_anns:
                    if ann.get("ignore") == 1:
                        seg = ann["segmentation"]
                        if isinstance(seg.get("counts"), list):
                            h, w = seg["size"]
                            seg = maskUtils.frPyObjects([seg], h, w)[0]
                        self.ignoremasks[ann["image_id"]] = maskUtils.decode(
                            seg)

    def native_size(self, sample_idx) -> tuple:
        """Native (h, w) of the original image for annotation geometry
        (cached; one raw read per sample per eval)."""
        if sample_idx not in self._native_sizes:
            raw = self.dataset.get_raw_sample(self._sample_index[sample_idx])
            self._native_sizes[sample_idx] = tuple(raw[0].shape[:2])
        return self._native_sizes[sample_idx]

    def create_annotations(self) -> List[dict]:
        cfg = self.cfg
        predictions: List[dict] = []
        acc = 0
        for imgs, _ in self.loader:
            masks, clss, stops = self.forward(self.variables,
                                              normalize_image(imgs))
            out_classes = np.argmax(clss, axis=-1)
            for s in range(masks.shape[0]):
                sample_idx = self.sample_list[s + acc]
                ignore = self.ignoremasks.get(sample_idx)
                h, w = self.native_size(sample_idx)
                this_pred: List[dict] = []
                for t in range(masks.shape[1]):
                    objectness = float(stops[s, t, 0])
                    if objectness < cfg.stop_th:
                        continue
                    rle, is_valid, raw_rle = resize_mask(cfg, masks[s, t],
                                                         h, w, ignore)
                    if not is_valid:
                        continue
                    max_class = (1 if cfg.class_th == 0.0
                                 else int(out_classes[s, t]))
                    for cls_id in range(1, len(self.class_names)):
                        score = float(clss[s, t, cls_id]) * objectness
                        ann = create_annotation(sample_idx, rle, cls_id,
                                                score, self.class_names)
                        if ann is not None:
                            # display keeps only the max-confidence class,
                            # with the raw (un-ignored) mask
                            if (cls_id == max_class
                                    and score >= cfg.class_th):
                                this_pred.append(create_annotation(
                                    sample_idx, raw_rle, cls_id, score,
                                    self.class_names))
                            predictions.append(ann)
                if cfg.display and this_pred:
                    self._render_overlay(sample_idx, this_pred)
            acc += masks.shape[0]
        return predictions

    def _render_overlay(self, sample_idx, anns) -> None:
        from ..train.checkpoint import model_dir
        from .visualize import display_masks
        cfg = self.cfg
        raw = self.dataset.get_raw_sample(self._sample_index[sample_idx])
        figs_dir = os.path.join(
            model_dir(cfg),
            f"{cfg.model_name}_figs_{cfg.eval_split}")
        name = os.path.basename(str(sample_idx)).split(".")[0]
        display_masks(np.asarray(raw[0]), anns,
                      os.path.join(figs_dir, name + ".png"),
                      no_display_text=cfg.no_display_text,
                      display_route=cfg.display_route)

    def run_eval(self):
        cfg = self.cfg
        sizes = {name: self.native_size(name) for name in self.sample_list}
        coco_shell = create_coco_object(cfg, self.sample_list,
                                        self.class_names, sizes)
        if self.gt_anns is None:
            raise RuntimeError("no ground-truth annotations available")
        cocoGt = coco_shell.loadRes(self.gt_anns)
        predictions = self.create_annotations()
        cocoDt = coco_shell.loadRes(predictions)
        E = COCOeval(cocoGt, cocoDt, "segm")
        E.params.maxDets = [1, cfg.max_dets, 100]
        E.params.useCats = cfg.use_cats
        E.params.imgIds = sorted(self.sample_list)
        E.params.catIds = (list(range(1, len(self.class_names)))
                           if cfg.cat_id == -1 else [cfg.cat_id])
        print("Results for all the classes together")
        E.evaluate()
        E.accumulate()
        E.summarize()
        results = {"stats": E.stats.tolist()}
        if cfg.all_classes:
            per_class = {}
            all_cats = list(E.params.catIds)
            for cat in all_cats:
                print("Testing class dataset_id: " + str(cat))
                print("Which corresponds to name: " + self.class_names[cat])
                E.params.catIds = [cat]
                E.evaluate()
                E.accumulate()
                E.summarize()
                per_class[self.class_names[cat]] = E.stats.tolist()
            # the per-class loop mutates shared COCOeval params; restore
            # so a later summarize() on E doesn't silently report only the
            # last class
            E.params.catIds = all_cats
            results["per_class"] = per_class
        return results
