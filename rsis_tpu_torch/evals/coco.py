"""COCO-format annotation index.

Counterpart of ``rsis_tpu/evals/coco.py``: a copy on the port's RLE library
(``kernels/mask.py``), without ``download`` (the port fetches nothing).

A clean reimplementation of the vendored COCO API's Python side (reference:
src/coco/PythonAPI/pycocotools/coco.py:65-426) on top of the native
RLE kernels: index construction, id queries, ``loadRes`` for building a
result COCO from annotation dicts / result files / Nx7 arrays, ann ->
RLE/mask conversion, plus the utility surface (``info``, ``showAnns``,
``loadNumpyAnnotations``) so the full vendored API contract
is covered.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict

import numpy as np

from ..kernels import mask as maskUtils


class COCO:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        self.imgs = {}
        self.cats = {}
        if annotation_file is not None:
            if isinstance(annotation_file, dict):
                self.dataset = annotation_file
            else:
                with open(annotation_file) as fp:
                    self.dataset = json.load(fp)
            assert isinstance(self.dataset, dict)
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns = defaultdict(list)
        catToImgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            catToImgs[ann["category_id"]].append(ann["image_id"])
        self.anns = anns
        self.imgToAnns = imgToAnns
        self.catToImgs = catToImgs
        self.imgs = imgs
        self.cats = cats

    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None):
        imgIds = imgIds if isinstance(imgIds, list) else [imgIds]
        catIds = catIds if isinstance(catIds, list) else [catIds]
        if len(imgIds) == len(catIds) == len(areaRng) == 0:
            anns = self.dataset.get("annotations", [])
        else:
            if len(imgIds) > 0:
                lists = [self.imgToAnns[i] for i in imgIds
                         if i in self.imgToAnns]
                anns = [a for lst in lists for a in lst]
            else:
                anns = self.dataset.get("annotations", [])
            if len(catIds) > 0:
                anns = [a for a in anns if a["category_id"] in catIds]
            if len(areaRng) > 0:
                anns = [a for a in anns
                        if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=[], supNms=[], catIds=[]):
        cats = self.dataset.get("categories", [])
        if catNms:
            cats = [c for c in cats if c.get("name") in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=[], catIds=[]):
        imgIds = imgIds if isinstance(imgIds, list) else [imgIds]
        catIds = catIds if isinstance(catIds, list) else [catIds]
        if len(imgIds) == len(catIds) == 0:
            ids = set(self.imgs.keys())
        else:
            ids = set(imgIds) if imgIds else set(self.imgs.keys())
            for i, cid in enumerate(catIds):
                cat_imgs = set(self.catToImgs[cid])
                ids = cat_imgs if (i == 0 and not imgIds) else ids & cat_imgs
        return list(ids)

    def loadAnns(self, ids=[]):
        ids = ids if isinstance(ids, list) else [ids]
        return [self.anns[i] for i in ids]

    def loadCats(self, ids=[]):
        ids = ids if isinstance(ids, list) else [ids]
        return [self.cats[i] for i in ids]

    def loadImgs(self, ids=[]):
        ids = ids if isinstance(ids, list) else [ids]
        return [self.imgs[i] for i in ids]

    def loadRes(self, resFile):
        """Build a result COCO object from a result file / list of dicts
        (reference: coco.py:292-356)."""
        res = COCO()
        res.dataset["images"] = [img for img in
                                 self.dataset.get("images", [])]
        if isinstance(resFile, str):
            with open(resFile) as fp:
                anns = json.load(fp)
        elif isinstance(resFile, np.ndarray):
            anns = self.loadNumpyAnnotations(resFile)
        else:
            anns = resFile
        assert isinstance(anns, list), "results must be a list"
        if len(anns) == 0:
            res.dataset["categories"] = copy.deepcopy(
                self.dataset.get("categories", []))
            res.dataset["annotations"] = []
            res.createIndex()
            return res
        annsImgIds = [ann["image_id"] for ann in anns]
        assert set(annsImgIds) == (set(annsImgIds) & set(self.getImgIds())), \
            "Results do not correspond to current coco set"
        # branch order and side effects mirror the reference exactly
        # (reference coco.py:313-348): bbox results take the bbox branch
        # even when a segmentation is also present (area from the box,
        # polygon fill), and bbox/segm results force iscrowd=0.
        if "caption" in anns[0]:
            img_ids = ({img["id"] for img in res.dataset["images"]}
                       & {ann["image_id"] for ann in anns})
            res.dataset["images"] = [img for img in res.dataset["images"]
                                     if img["id"] in img_ids]
            for aid, ann in enumerate(anns):
                ann["id"] = aid + 1
            res.dataset["annotations"] = anns
            res.createIndex()
            return res
        res.dataset["categories"] = copy.deepcopy(
            self.dataset.get("categories", []))
        if "bbox" in anns[0] and anns[0]["bbox"] != []:
            for aid, ann in enumerate(anns):
                bb = ann["bbox"]
                x1, x2, y1, y2 = bb[0], bb[0] + bb[2], bb[1], bb[1] + bb[3]
                if "segmentation" not in ann:
                    ann["segmentation"] = [[x1, y1, x1, y2, x2, y2, x2, y1]]
                ann["area"] = bb[2] * bb[3]
                ann["id"] = aid + 1
                ann["iscrowd"] = 0
        elif "segmentation" in anns[0]:
            for aid, ann in enumerate(anns):
                ann["area"] = float(maskUtils.area(ann["segmentation"]))
                if "bbox" not in ann:
                    ann["bbox"] = maskUtils.toBbox(
                        ann["segmentation"]).tolist()
                ann["id"] = aid + 1
                ann["iscrowd"] = 0
        elif "keypoints" in anns[0]:
            for aid, ann in enumerate(anns):
                s = ann["keypoints"]
                x, y = s[0::3], s[1::3]
                x0, x1 = min(x), max(x)
                y0, y1 = min(y), max(y)
                ann["area"] = (x1 - x0) * (y1 - y0)
                ann["id"] = aid + 1
                ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]
        res.dataset["annotations"] = anns
        res.createIndex()
        return res

    def info(self):
        for k, v in self.dataset.get("info", {}).items():
            print(f"{k}: {v}")

    def showAnns(self, anns):
        """Render annotations onto the current matplotlib axes
        (reference: coco.py:240-290). Polygons draw as translucent filled
        patches with outlines; RLE masks as alpha overlays (crowd regions
        in the fixed crowd color); keypoint annotations as skeleton lines
        plus visibility-coded joints. Caption annotations print."""
        if len(anns) == 0:
            return 0
        if "segmentation" in anns[0] or "keypoints" in anns[0]:
            import matplotlib.pyplot as plt
            from matplotlib.collections import PatchCollection
            from matplotlib.patches import Polygon

            ax = plt.gca()
            ax.set_autoscale_on(False)
            polygons, colors = [], []
            for ann in anns:
                c = (np.random.random(3) * 0.6 + 0.4).tolist()
                segm = ann.get("segmentation")
                if isinstance(segm, list):
                    for seg in segm:
                        pts = np.asarray(seg).reshape(-1, 2)
                        polygons.append(Polygon(pts))
                        colors.append(c)
                elif segm is not None:
                    img = self.imgs[ann["image_id"]]
                    if isinstance(segm["counts"], list):
                        rle = maskUtils.frPyObjects(
                            [segm], img["height"], img["width"])
                    else:
                        rle = [segm]
                    m = maskUtils.decode(rle)
                    if m.ndim == 3:
                        m = m[:, :, 0]
                    cm = (np.array([2.0, 166.0, 101.0]) / 255
                          if ann.get("iscrowd") == 1
                          else np.random.random(3))
                    overlay = np.empty((m.shape[0], m.shape[1], 4))
                    overlay[:, :, :3] = cm
                    overlay[:, :, 3] = m * 0.5
                    ax.imshow(overlay)
                kp = ann.get("keypoints")
                if isinstance(kp, list):
                    cat = self.loadCats(ann["category_id"])[0]
                    sks = np.asarray(cat.get("skeleton", [])) - 1
                    kp = np.asarray(kp)
                    x, y, v = kp[0::3], kp[1::3], kp[2::3]
                    for sk in sks:
                        if np.all(v[sk] > 0):
                            plt.plot(x[sk], y[sk], linewidth=3, color=c)
                    plt.plot(x[v > 0], y[v > 0], "o", markersize=8,
                             markerfacecolor=c, markeredgecolor="k",
                             markeredgewidth=2)
                    plt.plot(x[v > 1], y[v > 1], "o", markersize=8,
                             markerfacecolor=c, markeredgecolor=c,
                             markeredgewidth=2)
            ax.add_collection(PatchCollection(
                polygons, facecolor=colors, linewidths=0, alpha=0.4))
            ax.add_collection(PatchCollection(
                polygons, facecolor="none", edgecolors=colors, linewidths=2))
        elif "caption" in anns[0]:
            for ann in anns:
                print(ann["caption"])
        else:
            raise TypeError("annotation type not supported")

    def loadNumpyAnnotations(self, data):
        """Nx7 ndarray -> list of result dicts (bbox format)."""
        assert data.shape[1] == 7
        out = []
        for row in data:
            out.append({"image_id": int(row[0]),
                        "bbox": [row[1], row[2], row[3], row[4]],
                        "score": float(row[5]),
                        "category_id": int(row[6])})
        return out

    def annToRLE(self, ann):
        """Convert polygon / uncompressed RLE / RLE annotation to RLE."""
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            rles = maskUtils.frPyObjects(segm, h, w)
            return maskUtils.merge(rles)
        if isinstance(segm.get("counts"), list):
            return maskUtils.frPyObjects(segm, h, w)
        return segm

    def annToMask(self, ann):
        return maskUtils.decode(self.annToRLE(ann))
