"""The port's ``COCO`` and ``COCOeval`` (``rsis_tpu_torch/evals``) against
the JAX package's on the same ground truth and detections: the 12
summary stats equal (atol 1e-12) with categories on and off, with the
RSIS evaluator's maxDets and with a crowd region; ``loadRes`` gives the same
areas and boxes."""

import numpy as np
import pytest

from rsis_tpu.evals.coco import COCO as JaxCOCO
from rsis_tpu.evals.cocoeval import COCOeval as JaxCOCOeval
from rsis_tpu_torch.evals.coco import COCO
from rsis_tpu_torch.evals.cocoeval import COCOeval
from rsis_tpu_torch.kernels import mask as pmask
from torch_threads import one_torch_thread  # noqa: F401


def _rle(m):
    r = pmask.encode(np.asfortranarray(m.astype(np.uint8)))
    return {"size": r["size"], "counts": r["counts"].decode("ascii")}


def _blob(rng, h, w):
    yy, xx = np.ogrid[:h, :w]
    cy, cx = rng.integers(5, h - 5), rng.integers(5, w - 5)
    ry, rx = rng.integers(3, h // 3, 2)
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1


def _case(seed, n_img=4, h=60, w=80, n_cls=3):
    """GT (a crowd region on image 0) and noisy detections: jittered GT
    blobs and false positives with random scores and classes."""
    rng = np.random.default_rng(seed)
    imgs = [{"id": f"im{i}", "height": h, "width": w} for i in range(n_img)]
    cats = [{"id": c, "name": f"c{c}"} for c in range(1, n_cls + 1)]
    anns, dets = [], []
    for im in imgs:
        for k in range(rng.integers(1, 4)):
            m = _blob(rng, h, w)
            cat = int(rng.integers(1, n_cls + 1))
            crowd = int(im["id"] == "im0" and k == 0)
            anns.append({"id": len(anns) + 1, "image_id": im["id"],
                         "category_id": cat, "segmentation": _rle(m),
                         "iscrowd": crowd, "area": float(m.sum()),
                         "ignore": crowd})
            shifted = np.roll(m, tuple(rng.integers(-3, 4, 2)), axis=(0, 1))
            dets.append({"image_id": im["id"], "category_id": cat,
                         "segmentation": _rle(shifted),
                         "score": float(rng.random())})
        for _ in range(rng.integers(0, 3)):
            dets.append({"image_id": im["id"],
                         "category_id": int(rng.integers(1, n_cls + 1)),
                         "segmentation": _rle(_blob(rng, h, w)),
                         "score": float(rng.random())})
    return {"images": imgs, "categories": cats, "annotations": anns}, dets


def _stats(coco_cls, eval_cls, gt, dets, use_cats, max_dets, cat_ids):
    coco_gt = coco_cls(gt)
    coco_dt = coco_gt.loadRes([dict(d) for d in dets])
    E = eval_cls(coco_gt, coco_dt, "segm")
    E.params.maxDets = list(max_dets)
    E.params.useCats = use_cats
    E.params.imgIds = sorted(img["id"] for img in gt["images"])
    if cat_ids is not None:
        E.params.catIds = cat_ids
    E.evaluate()
    E.accumulate()
    E.summarize()
    return np.asarray(E.stats), coco_dt


@pytest.mark.parametrize("use_cats", [True, False])
@pytest.mark.parametrize("seed,max_dets,cat_ids", [
    (0, (1, 10, 100), None),
    (1, (1, 2, 100), [1, 2, 3]),    # the evaluator's maxDets, all categories
    (2, (1, 100, 100), [2]),        # one category (-cat_id)
])
def test_stats_equal_jax(use_cats, seed, max_dets, cat_ids):
    gt, dets = _case(seed)
    got, coco_dt = _stats(COCO, COCOeval, gt, dets, use_cats, max_dets,
                          cat_ids)
    want, jax_dt = _stats(JaxCOCO, JaxCOCOeval, gt, dets, use_cats,
                          max_dets, cat_ids)
    assert got.shape == (12,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for a in coco_dt.dataset["annotations"]:
        b = jax_dt.anns[a["id"]]
        assert a["area"] == b["area"]
        assert list(a["bbox"]) == list(b["bbox"])
