"""pycocotools.mask-compatible facade over the native RLE library.

Counterpart of ``rsis_tpu/kernels/mask.py``, a copy over the port's own
build of ``rle/rle.cpp`` (``_binding.py``). RLE objects are dicts
``{"size": [h, w], "counts": bytes}`` exactly like the compressed
pycocotools interchange format, so annotations produced here are valid
COCO-format JSON payloads.
"""

from __future__ import annotations

import numpy as np

from . import _binding as _b


def _compress(cnts: np.ndarray, h: int, w: int) -> dict:
    return {"size": [int(h), int(w)], "counts": _b.to_string(cnts)}


def _decompress(rle: dict) -> tuple[np.ndarray, int, int]:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode("utf-8")
    if isinstance(counts, (list, tuple, np.ndarray)):
        return np.asarray(counts, dtype=np.uint32), h, w
    return _b.from_string(counts, h, w), h, w


def encode(bimask: np.ndarray):
    """Encode binary mask(s). (h, w, n) Fortran array -> list of RLEs;
    (h, w) -> single RLE."""
    if bimask.ndim == 3:
        h, w, n = bimask.shape
        cnts = _b.encode(bimask)
        return [_compress(c, h, w) for c in cnts]
    if bimask.ndim == 2:
        h, w = bimask.shape
        cnts = _b.encode(bimask[:, :, None])
        return _compress(cnts[0], h, w)
    raise ValueError("encode expects a 2D or 3D uint8 mask")


def decode(rle_objs) -> np.ndarray:
    """Decode RLE(s) to binary mask(s): list -> (h, w, n); single -> (h, w)."""
    if isinstance(rle_objs, dict):
        cnts, h, w = _decompress(rle_objs)
        return _b.decode([cnts], h, w)[:, :, 0]
    parts = [_decompress(r) for r in rle_objs]
    if not parts:
        return np.zeros((0, 0, 0), dtype=np.uint8)
    h, w = parts[0][1], parts[0][2]
    return _b.decode([p[0] for p in parts], h, w)


def area(rle_objs):
    if isinstance(rle_objs, dict):
        return int(_b.area([_decompress(rle_objs)[0]])[0])
    return _b.area([_decompress(r)[0] for r in rle_objs])


def merge(rle_objs, intersect=False) -> dict:
    parts = [_decompress(r) for r in rle_objs]
    if not parts:
        return {"size": [0, 0], "counts": b""}
    h, w = parts[0][1], parts[0][2]
    out = _b.merge([p[0] for p in parts], h, w, intersect)
    return _compress(out, h, w)


def iou(dt, gt, pyiscrowd) -> np.ndarray:
    """IoU between detection and GT masks or bboxes.

    Shapes follow pycocotools: result is (len(dt), len(gt)).
    dt/gt may each be a list of RLE dicts or an (n, 4) bbox ndarray.
    """
    crowd = np.asarray(pyiscrowd, dtype=np.uint8)

    def is_bb(x):
        # empty lists carry no type evidence: defer to the other operand
        # (pycocotools semantics — dt and gt are always the same kind)
        return isinstance(x, np.ndarray) or (
            len(x) > 0 and not isinstance(x[0], dict))

    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), dtype=np.float64)
    if is_bb(dt) and is_bb(gt):
        return _b.bb_iou(np.asarray(dt, dtype=np.float64),
                         np.asarray(gt, dtype=np.float64), crowd)
    dparts = [_decompress(r) for r in dt]
    gparts = [_decompress(r) for r in gt]
    return _b.iou([p[0] for p in dparts], [(p[1], p[2]) for p in dparts],
                  [p[0] for p in gparts], [(p[1], p[2]) for p in gparts],
                  crowd)


def toBbox(rle_objs) -> np.ndarray:
    single = isinstance(rle_objs, dict)
    objs = [rle_objs] if single else rle_objs
    parts = [_decompress(r) for r in objs]
    out = _b.to_bbox([p[0] for p in parts], [(p[1], p[2]) for p in parts])
    return out[0] if single else out


def frBbox(bb: np.ndarray, h: int, w: int):
    cnts = _b.from_bbox(np.asarray(bb, dtype=np.float64).reshape(-1, 4), h, w)
    return [_compress(c, h, w) for c in cnts]


def frPoly(polys, h: int, w: int):
    return [_compress(_b.from_poly(p, h, w), h, w) for p in polys]


def frUncompressedRLE(ucRles, h: int, w: int):
    out = []
    for uc in ucRles:
        cnts = np.asarray(uc["counts"], dtype=np.uint32)
        out.append(_compress(cnts, h, w))
    return out


def frPyObjects(pyobj, h: int, w: int):
    """Convert polygon(s), bbox(es), or uncompressed RLE(s) to RLE(s)."""
    if isinstance(pyobj, np.ndarray):
        return frBbox(pyobj, h, w)
    if isinstance(pyobj, list):
        if len(pyobj) == 0:
            return []
        first = pyobj[0]
        if isinstance(first, dict) and "counts" in first:
            return frUncompressedRLE(pyobj, h, w)
        if isinstance(first, (list, tuple, np.ndarray)):
            if len(first) == 4 and not isinstance(first[0], (list, tuple)):
                return frBbox(np.asarray(pyobj, dtype=np.float64), h, w)
            return frPoly(pyobj, h, w)
        # flat polygon coordinate list
        return frPoly([pyobj], h, w)[0]
    if isinstance(pyobj, dict) and "counts" in pyobj:
        return frUncompressedRLE([pyobj], h, w)[0]
    raise ValueError("unsupported object type for frPyObjects")


def nms(dt, thr: float) -> np.ndarray:
    parts = [_decompress(r) for r in dt]
    return _b.nms([p[0] for p in parts], [(p[1], p[2]) for p in parts], thr)


def bbNms(bb: np.ndarray, thr: float) -> np.ndarray:
    return _b.bb_nms(np.asarray(bb, dtype=np.float64), thr)
