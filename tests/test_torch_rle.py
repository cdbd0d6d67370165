"""The port's RLE library (``rsis_tpu_torch/kernels``) against the JAX
package's (``rsis_tpu/kernels/mask.py``), exactly: the compressed
``counts`` bytes, the decoded masks, areas, merges, IoUs (crowd and not,
masks and boxes), boxes, the ``frPyObjects`` conversions (polygons, boxes,
uncompressed RLE) and NMS, on random masks that include empty and full
ones. Also: the library builds under build/, keyed by its source."""

import numpy as np
import pytest

from rsis_tpu.kernels import mask as jmask
from rsis_tpu_torch.kernels import _binding
from rsis_tpu_torch.kernels import mask as pmask
from torch_threads import one_torch_thread  # noqa: F401


def _masks(seed, h, w, n):
    """(h, w, n) uint8 Fortran masks: random blobs, one empty, one full."""
    rng = np.random.default_rng(seed)
    out = np.zeros((h, w, n), dtype=np.uint8, order="F")
    yy, xx = np.ogrid[:h, :w]
    for i in range(2, n):
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            ry, rx = rng.integers(1, max(2, h // 3)), rng.integers(
                1, max(2, w // 3))
            out[:, :, i] |= (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
                             <= 1).astype(np.uint8)
    out[:, :, 1] = 1
    return out


SHAPES = [(1, 1, 3), (7, 5, 4), (31, 97, 5), (64, 48, 6)]


def _same_rles(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["size"] == y["size"]
        assert isinstance(x["counts"], bytes)
        assert x["counts"] == y["counts"]


@pytest.mark.parametrize("h,w,n", SHAPES)
def test_encode_decode_area_bbox(h, w, n):
    m = _masks(h * w, h, w, n)
    got, want = pmask.encode(m), jmask.encode(m)
    _same_rles(got, want)
    np.testing.assert_array_equal(pmask.decode(got), jmask.decode(want))
    np.testing.assert_array_equal(pmask.decode(got), m)
    np.testing.assert_array_equal(pmask.area(got), jmask.area(want))
    np.testing.assert_array_equal(pmask.toBbox(got), jmask.toBbox(want))
    one = np.asfortranarray(m[:, :, -1])
    assert pmask.encode(one) == jmask.encode(one)
    assert pmask.area(pmask.encode(one)) == jmask.area(jmask.encode(one))


@pytest.mark.parametrize("h,w,n", SHAPES)
def test_merge_and_iou(h, w, n):
    m = _masks(h + w, h, w, n)
    rles = pmask.encode(m)
    for intersect in (False, True):
        assert (pmask.merge(rles, intersect=intersect)
                == jmask.merge(rles, intersect=intersect))
    dt = pmask.encode(_masks(h * w + 1, h, w, n))
    for crowd in ([0] * n, [i % 2 for i in range(n)]):
        got = pmask.iou(dt, rles, crowd)
        np.testing.assert_array_equal(got, jmask.iou(dt, rles, crowd))
        assert got.shape == (n, n)
    boxes = pmask.toBbox(rles)
    np.testing.assert_array_equal(pmask.iou(boxes, boxes[::-1], [0] * n),
                                  jmask.iou(boxes, boxes[::-1], [0] * n))
    np.testing.assert_array_equal(pmask.nms(rles, 0.3),
                                  jmask.nms(rles, 0.3))
    np.testing.assert_array_equal(pmask.bbNms(boxes, 0.3),
                                  jmask.bbNms(boxes, 0.3))


def test_fr_py_objects():
    h, w = 40, 52
    rng = np.random.default_rng(7)
    polys = [[float(v) for v in rng.uniform(0, 40, 2 * k)]
             for k in (3, 5, 8)]
    _same_rles(pmask.frPyObjects(polys, h, w),
               jmask.frPyObjects(polys, h, w))
    assert (pmask.frPyObjects(polys[0], h, w)
            == jmask.frPyObjects(polys[0], h, w))
    boxes = np.array([[2.0, 3.5, 10.2, 7.0], [0, 0, w, h], [40, 30, 30, 30]])
    _same_rles(pmask.frPyObjects(boxes, h, w),
               jmask.frPyObjects(boxes, h, w))
    _same_rles(pmask.frPyObjects(boxes.tolist(), h, w),
               jmask.frPyObjects(boxes.tolist(), h, w))
    m = _masks(3, h, w, 3)
    counts = [pmask._decompress(r)[0].tolist() for r in pmask.encode(m)]
    uncompressed = [{"size": [h, w], "counts": c} for c in counts]
    _same_rles(pmask.frPyObjects(uncompressed, h, w),
               jmask.frPyObjects(uncompressed, h, w))
    assert (pmask.frPyObjects(uncompressed[0], h, w)
            == jmask.frPyObjects(uncompressed[0], h, w))
    # string counts (the JSON form) decode like bytes
    rle = pmask.encode(np.asfortranarray(m[:, :, 2]))
    as_str = {"size": rle["size"], "counts": rle["counts"].decode("ascii")}
    np.testing.assert_array_equal(pmask.decode(as_str), m[:, :, 2])


def test_library_builds_under_build_keyed_by_source():
    path = _binding.build()
    assert path == _binding.library_path()
    assert path.parent == _binding.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "rsis_tpu_torch")
    assert path.exists()
