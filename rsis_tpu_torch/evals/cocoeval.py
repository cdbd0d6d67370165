"""COCO-style AP/AR evaluation.

Counterpart of ``rsis_tpu/evals/cocoeval.py``: a copy on the port's RLE
library (``kernels/mask.py``).

Reimplementation of the vendored COCOeval (reference:
src/coco/PythonAPI/pycocotools/cocoeval.py:122-521) on numpy + the native
mask library: per-(image, category) IoU via the C++ ``rleIou`` with
crowd semantics, greedy matching per IoU threshold in ``evaluateImg``,
PR-curve accumulation over T x R x K x A x M, and the 12-line summary.
The RSIS evaluator overrides maxDets / useCats / catIds
(reference: src/eval.py:377-390).
"""

from __future__ import annotations

import copy
import datetime
import time
from collections import defaultdict

import numpy as np

from ..kernels import mask as maskUtils


class Params:
    def setDetParams(self):
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(0.5, 0.95,
                                   int(np.round((0.95 - 0.5) / 0.05)) + 1)
        self.recThrs = np.linspace(0.0, 1.00,
                                   int(np.round((1.00 - 0.0) / 0.01)) + 1)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0, 1e10], [0, 32 ** 2], [32 ** 2, 96 ** 2],
                        [96 ** 2, 1e10]]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1

    def setKpParams(self):
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(0.5, 0.95,
                                   int(np.round((0.95 - 0.5) / 0.05)) + 1)
        self.recThrs = np.linspace(0.0, 1.00,
                                   int(np.round((1.00 - 0.0) / 0.01)) + 1)
        self.maxDets = [20]
        self.areaRng = [[0, 1e10], [32 ** 2, 96 ** 2], [96 ** 2, 1e10]]
        self.areaRngLbl = ["all", "medium", "large"]
        self.useCats = 1

    def __init__(self, iouType="segm"):
        if iouType in ("segm", "bbox"):
            self.setDetParams()
        elif iouType == "keypoints":
            self.setKpParams()
        else:
            raise ValueError(f"iouType {iouType!r} not supported")
        self.iouType = iouType
        # deprecated upstream escape hatch, kept for API parity
        # (reference cocoeval.py:527-528, handled in evaluate:142-145)
        self.useSegm = None


class COCOeval:
    def __init__(self, cocoGt=None, cocoDt=None, iouType="segm"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType=iouType)
        self.evalImgs = defaultdict(list)
        self.eval = {}
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        self.stats = []
        self.ious = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    def _prepare(self):
        p = self.params
        if p.useCats:
            gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(
                imgIds=p.imgIds, catIds=p.catIds))
            dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(
                imgIds=p.imgIds, catIds=p.catIds))
        else:
            gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(imgIds=p.imgIds))
            dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(imgIds=p.imgIds))
        if p.iouType == "segm":
            for ann in gts:
                ann["_rle"] = self.cocoGt.annToRLE(ann)
            for ann in dts:
                ann["_rle"] = self.cocoDt.annToRLE(ann)
        for gt in gts:
            # reference deviation from stock pycocotools: iscrowd does NOT
            # imply ignore — only an explicit 'ignore' field does (the
            # reference deliberately commented out the iscrowd line,
            # src/coco/PythonAPI/pycocotools/cocoeval.py:94-95; its Pascal
            # GT pkls carry explicit ignore annotations instead). Crowd GTs
            # still get crowd *matching* semantics via computeIoU.
            gt["ignore"] = gt.get("ignore", 0)
            if p.iouType == "keypoints":
                gt["ignore"] = (gt.get("num_keypoints") == 0) or gt["ignore"]
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)
        self.evalImgs = defaultdict(list)
        self.eval = {}

    def evaluate(self):
        tic = time.time()
        print("Running per image evaluation...")
        p = self.params
        if getattr(p, "useSegm", None) is not None:
            p.iouType = "segm" if p.useSegm == 1 else "bbox"
            print(f"useSegm (deprecated) is not None. "
                  f"Running {p.iouType} evaluation")
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)
        self.params = p
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        compute = (self.computeOks if p.iouType == "keypoints"
                   else self.computeIoU)
        self.ious = {(imgId, catId): compute(imgId, catId)
                     for imgId in p.imgIds for catId in catIds}
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds]
        self._paramsEval = copy.deepcopy(self.params)
        toc = time.time()
        print(f"DONE (t={toc - tic:0.2f}s).")

    def computeIoU(self, imgId, catId):
        p = self.params
        if p.useCats:
            gt = self._gts[imgId, catId]
            dt = self._dts[imgId, catId]
        else:
            gt = [a for cId in p.catIds for a in self._gts[imgId, cId]]
            dt = [a for cId in p.catIds for a in self._dts[imgId, cId]]
        if len(gt) == 0 and len(dt) == 0:
            return []
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds]
        if len(dt) > p.maxDets[-1]:
            dt = dt[:p.maxDets[-1]]
        if p.iouType == "segm":
            g = [g["_rle"] for g in gt]
            d = [d["_rle"] for d in dt]
        else:
            g = np.array([g["bbox"] for g in gt], dtype=np.float64)
            d = np.array([d["bbox"] for d in dt], dtype=np.float64)
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        if len(d) == 0 or len(g) == 0:
            return np.zeros((len(d), len(g)))
        return maskUtils.iou(d, g, iscrowd)

    # COCO person-keypoint OKS falloff constants (the vendored reference
    # hardcodes them inside computeOks, cocoeval.py:225)
    KPT_SIGMAS = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72,
                           .62, .62, 1.07, 1.07, .87, .87, .89, .89]) / 10.0

    def computeOks(self, imgId, catId):
        """Object-keypoint-similarity matrix (dts x gts); math matches the
        reference computeOks loop (cocoeval.py:210-250), vectorized over
        detections per GT."""
        p = self.params
        gts = self._gts[imgId, catId]
        dts = self._dts[imgId, catId]
        inds = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in inds]
        if len(dts) > p.maxDets[-1]:
            dts = dts[:p.maxDets[-1]]
        if len(gts) == 0 or len(dts) == 0:
            return []
        var = (self.KPT_SIGMAS * 2) ** 2
        k = len(self.KPT_SIGMAS)
        d_kp = np.array([d["keypoints"] for d in dts], dtype=np.float64)
        xd, yd = d_kp[:, 0::3], d_kp[:, 1::3]          # (D, k)
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.array(gt["keypoints"], dtype=np.float64)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            k1 = np.count_nonzero(vg > 0)
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                # no labelled keypoints: distance to the doubled gt box
                bb = gt["bbox"]
                x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
                y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
                dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
                dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
            e = ((dx ** 2 + dy ** 2) / var
                 / (gt["area"] + np.spacing(1)) / 2)   # (D, k)
            if k1 > 0:
                e = e[:, vg > 0]
            ious[:, j] = np.exp(-e).sum(axis=1) / e.shape[1]
        return ious

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        """Greedy per-image matching. This follows the COCO matching
        PROTOCOL step-for-step (descending-score detections, crowd GTs
        matchable repeatedly, ignored GTs sorted last and only reachable
        once no real match exists, out-of-area dts ignored post hoc) —
        any structural deviation changes reported AP, so the loop shape
        is the specification, pinned tensor-exactly against the
        reference's vendored pycocotools by tests/test_coco_golden.py."""
        p = self.params
        if p.useCats:
            gt = self._gts[imgId, catId]
            dt = self._dts[imgId, catId]
        else:
            gt = [a for cId in p.catIds for a in self._gts[imgId, cId]]
            dt = [a for cId in p.catIds for a in self._dts[imgId, cId]]
        if len(gt) == 0 and len(dt) == 0:
            return None

        for g in gt:
            if g["ignore"] or (g["area"] < aRng[0] or g["area"] > aRng[1]):
                g["_ignore"] = 1
            else:
                g["_ignore"] = 0

        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[0:maxDet]]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        ious = (self.ious[imgId, catId][:, gtind]
                if len(self.ious[imgId, catId]) > 0
                else self.ious[imgId, catId])

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) != 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min([t, 1 - 1e-10])
                    m = -1
                    for gind, g in enumerate(gt):
                        # already matched, and not a crowd
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # stop at ignored gt once a real match exists
                        if (m > -1 and gtIg[m] == 0 and gtIg[gind] == 1):
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        # out-of-area detections count as ignored
        a = np.array([d["area"] < aRng[0] or d["area"] > aRng[1]
                      for d in dt]).reshape((1, len(dt)))
        dtIg = np.logical_or(dtIg, np.logical_and(
            dtm == 0, np.repeat(a, T, 0)))
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    def accumulate(self, p=None):
        print("Accumulating evaluation results...")
        tic = time.time()
        if not self.evalImgs:
            print("Please run evaluate() first")
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds)
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        _pe = self._paramsEval
        catIds = _pe.catIds if _pe.useCats else [-1]
        setK = set(catIds)
        setA = set(map(tuple, _pe.areaRng))
        setM = set(_pe.maxDets)
        setI = set(_pe.imgIds)
        k_list = [n for n, k in enumerate(p.catIds) if k in setK]
        m_list = [m for n, m in enumerate(p.maxDets) if m in setM]
        a_list = [n for n, a in enumerate(map(lambda x: tuple(x), p.areaRng))
                  if a in setA]
        i_list = [n for n, i in enumerate(p.imgIds) if i in setI]
        I0 = len(_pe.imgIds)
        A0 = len(_pe.areaRng)
        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, maxDet in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate(
                        [e["dtScores"][0:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, 0:maxDet] for e in E],
                        axis=1)[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, 0:maxDet] for e in E],
                        axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    # vectorized PR-curve computation over all T IoU
                    # thresholds at once (the reference's per-threshold
                    # Python list loops, src/coco/PythonAPI/pycocotools/
                    # cocoeval.py:372-407, computed the same quantities;
                    # equality is pinned tensor-exactly by
                    # tests/test_coco_golden.py)
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)  # (T, nd)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    nd = tp_sum.shape[1]
                    rc = tp_sum / npig
                    pr = tp_sum / (fp_sum + tp_sum + np.spacing(1))
                    recall[:, k, a, m] = rc[:, -1] if nd else 0
                    # precision envelope: right-to-left running max
                    pr_env = np.maximum.accumulate(
                        pr[:, ::-1], axis=1)[:, ::-1]
                    for t in range(T):
                        # first index whose recall reaches each threshold;
                        # rc is nondecreasing so out-of-range indices are a
                        # suffix (matches upstream's stop-at-IndexError)
                        idx = np.searchsorted(rc[t], p.recThrs, side="left")
                        valid = idx < nd
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        q[valid] = pr_env[t, idx[valid]]
                        ss[valid] = dtScoresSorted[idx[valid]]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }
        toc = time.time()
        print(f"DONE (t={toc - tic:0.2f}s).")

    def summarize(self, style="coco12"):
        """Compute summary stats. style="coco12" is the standard pycocotools
        12-number table (the published val2014_fake_eval_res.txt contract);
        style="rsis13" reproduces the reference's customized 13-stat layout
        (reference src/coco/PythonAPI/pycocotools/cocoeval.py:453-468)."""
        def _summarize(ap=1, iouThr=None, areaRng="all", maxDets=100):
            p = self.params
            iStr = (" {:<18} {} @[ IoU={:<9} | area={:>6s} | "
                    "maxDets={:>3d} ] = {:0.3f}")
            titleStr = "Average Precision" if ap == 1 else "Average Recall"
            typeStr = "(AP)" if ap == 1 else "(AR)"
            iouStr = ("{:0.2f}:{:0.2f}".format(p.iouThrs[0], p.iouThrs[-1])
                      if iouThr is None else "{:0.2f}".format(iouThr))
            aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
            mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
            if ap == 1:
                s = self.eval["precision"]
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, :, aind, mind]
            else:
                s = self.eval["recall"]
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, aind, mind]
            if len(s[s > -1]) == 0:
                mean_s = -1
            else:
                mean_s = np.mean(s[s > -1])
            print(iStr.format(titleStr, typeStr, iouStr, areaRng, maxDets,
                              mean_s))
            return mean_s

        if not self.eval:
            raise RuntimeError("Please run accumulate() first")
        p = self.params
        if p.iouType == "keypoints":
            # the vendored reference's _summarizeKps table
            # (cocoeval.py:469-481)
            stats = np.zeros((10,))
            stats[0] = _summarize(1, maxDets=20)
            stats[1] = _summarize(1, maxDets=20, iouThr=0.5)
            stats[2] = _summarize(1, maxDets=20, iouThr=0.75)
            stats[3] = _summarize(1, maxDets=20, areaRng="medium")
            stats[4] = _summarize(1, maxDets=20, areaRng="large")
            stats[5] = _summarize(0, maxDets=20)
            stats[6] = _summarize(0, maxDets=20, iouThr=0.5)
            stats[7] = _summarize(0, maxDets=20, iouThr=0.75)
            stats[8] = _summarize(0, maxDets=20, areaRng="medium")
            stats[9] = _summarize(0, maxDets=20, areaRng="large")
            self.stats = stats
            return
        if style == "rsis13":
            # the reference's vendored cocoeval customizes _summarizeDets to
            # a 13-stat layout (AP at IoU .5/.6/.7/.75/.8, AR at .5/.7/.85;
            # reference src/coco/PythonAPI/pycocotools/cocoeval.py:453-468)
            stats = np.zeros((13,))
            stats[0] = _summarize(1)
            stats[1] = _summarize(1, iouThr=0.5, maxDets=p.maxDets[2])
            stats[2] = _summarize(1, iouThr=0.6, maxDets=p.maxDets[2])
            stats[3] = _summarize(1, iouThr=0.7, maxDets=p.maxDets[2])
            stats[4] = _summarize(1, iouThr=0.75, maxDets=p.maxDets[2])
            stats[5] = _summarize(1, iouThr=0.8, maxDets=p.maxDets[2])
            stats[6] = _summarize(1, maxDets=p.maxDets[1])
            stats[7] = _summarize(0, maxDets=p.maxDets[1])
            stats[8] = _summarize(1, iouThr=0.5, maxDets=p.maxDets[0])
            stats[9] = _summarize(1, iouThr=0.5, maxDets=p.maxDets[1])
            stats[10] = _summarize(0, iouThr=0.5, maxDets=p.maxDets[1])
            stats[11] = _summarize(0, iouThr=0.7, maxDets=p.maxDets[1])
            stats[12] = _summarize(0, iouThr=0.85, maxDets=p.maxDets[1])
            self.stats = stats
            return
        stats = np.zeros((12,))
        stats[0] = _summarize(1, maxDets=p.maxDets[2])
        stats[1] = _summarize(1, iouThr=0.5, maxDets=p.maxDets[2])
        stats[2] = _summarize(1, iouThr=0.75, maxDets=p.maxDets[2])
        stats[3] = _summarize(1, areaRng="small", maxDets=p.maxDets[2])
        stats[4] = _summarize(1, areaRng="medium", maxDets=p.maxDets[2])
        stats[5] = _summarize(1, areaRng="large", maxDets=p.maxDets[2])
        stats[6] = _summarize(0, maxDets=p.maxDets[0])
        stats[7] = _summarize(0, maxDets=p.maxDets[1])
        stats[8] = _summarize(0, maxDets=p.maxDets[2])
        stats[9] = _summarize(0, areaRng="small", maxDets=p.maxDets[2])
        stats[10] = _summarize(0, areaRng="medium", maxDets=p.maxDets[2])
        stats[11] = _summarize(0, areaRng="large", maxDets=p.maxDets[2])
        self.stats = stats

    def __str__(self):
        self.summarize()
        return ""
