"""Host-side geometry for the datasets: crop, flip and the fused affine.

Counterpart of ``rsis_tpu/data/augment.py``, numpy on the host, run in
the loader's threads (``--host_augment``): rotation, translation, shear
and zoom compose into one 3x3 matrix (R @ T @ Sh @ Z) applied in one
interpolation pass about the image centre (size/2 - 0.5), as an inverse
map (output pixel <- input at M @ coord), edges replicated by clamping.
The same draws from the same numpy generator give the JAX package's bytes.
``random_crop`` draws its offset over the full range (the reference's
one-argument ``random.randint`` fixed). The device path
(``data/device_aug.py``, the warp kernel K7) has the same geometry.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def rotation_matrix(degrees: float) -> np.ndarray:
    t = math.pi / 180.0 * degrees
    return np.array([[math.cos(t), -math.sin(t), 0.0],
                     [math.sin(t), math.cos(t), 0.0],
                     [0.0, 0.0, 1.0]], dtype=np.float64)


def translation_matrix(tx: float, ty: float) -> np.ndarray:
    """tx shifts rows (height), ty shifts cols (width) — in pixels."""
    return np.array([[1.0, 0.0, tx],
                     [0.0, 1.0, ty],
                     [0.0, 0.0, 1.0]], dtype=np.float64)


def shear_matrix(degrees: float) -> np.ndarray:
    t = math.pi * degrees / 180.0
    return np.array([[1.0, -math.sin(t), 0.0],
                     [0.0, math.cos(t), 0.0],
                     [0.0, 0.0, 1.0]], dtype=np.float64)


def zoom_matrix(zx: float, zy: float) -> np.ndarray:
    return np.array([[zx, 0.0, 0.0],
                     [0.0, zy, 0.0],
                     [0.0, 0.0, 1.0]], dtype=np.float64)


def affine_warp(x: np.ndarray, matrix: np.ndarray,
                mode: str = "bilinear") -> np.ndarray:
    """Warp (C, H, W) or (H, W) array by a 3x3 (or 2x3) matrix, center origin."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    c, h, w = x.shape
    m = np.asarray(matrix, dtype=np.float64)[:2, :]
    a, b = m[:, :2], m[:, 2]

    rows, cols = np.meshgrid(np.arange(h, dtype=np.float64),
                             np.arange(w, dtype=np.float64), indexing="ij")
    coords = np.stack([rows.ravel() - (h / 2.0 - 0.5),
                       cols.ravel() - (w / 2.0 - 0.5)], axis=-1)
    new = coords @ a.T + b
    new[:, 0] += h / 2.0 - 0.5
    new[:, 1] += w / 2.0 - 0.5

    if mode == "nearest":
        ri = np.clip(new[:, 0], 0, h - 1).round().astype(np.int64)
        ci = np.clip(new[:, 1], 0, w - 1).round().astype(np.int64)
        out = x.reshape(c, -1)[:, ri * w + ci]
    elif mode == "bilinear":
        r = np.clip(new[:, 0], 0, h - 2)
        cc = np.clip(new[:, 1], 0, w - 2)
        r0 = np.floor(r)
        c0 = np.floor(cc)
        rd, cd = r - r0, cc - c0
        r0 = r0.astype(np.int64)
        c0 = c0.astype(np.int64)
        flat = x.reshape(c, -1)
        v00 = flat[:, r0 * w + c0]
        v10 = flat[:, (r0 + 1) * w + c0]
        v01 = flat[:, r0 * w + c0 + 1]
        v11 = flat[:, (r0 + 1) * w + c0 + 1]
        out = (v00 * (1 - rd) * (1 - cd) + v10 * rd * (1 - cd)
               + v01 * (1 - rd) * cd + v11 * rd * cd)
    else:
        raise ValueError(f"unknown interpolation mode {mode!r}")
    out = out.reshape(c, h, w).astype(x.dtype if mode == "nearest"
                                      else np.result_type(x.dtype, np.float32))
    return out[0] if squeeze else out


@dataclass
class RandomAffineParams:
    rotation_range: float | None = None
    translation_range: float | tuple | None = None
    shear_range: float | None = None
    zoom_range: tuple | None = None

    def sample_matrix(self, rng: np.random.Generator, h: int,
                      w: int) -> np.ndarray:
        """Draw one fused transform matrix like the reference RandomAffine."""
        m = np.eye(3)
        if self.rotation_range is not None:
            deg = rng.uniform(-self.rotation_range, self.rotation_range)
            m = m @ rotation_matrix(deg)
        if self.translation_range is not None:
            tr = self.translation_range
            if not isinstance(tr, (tuple, list)):
                tr = (tr, tr)
            tx = rng.uniform(-tr[0], tr[0]) * h
            ty = rng.uniform(-tr[1], tr[1]) * w
            m = m @ translation_matrix(tx, ty)
        if self.shear_range is not None:
            deg = rng.uniform(-self.shear_range, self.shear_range)
            m = m @ shear_matrix(deg)
        if self.zoom_range is not None:
            zx = rng.uniform(self.zoom_range[0], self.zoom_range[1])
            zy = rng.uniform(self.zoom_range[0], self.zoom_range[1])
            m = m @ zoom_matrix(zx, zy)
        return m


class RandomAffine:
    """Samples one fused matrix and warps image + masks with one interp pass."""

    def __init__(self, rotation_range=None, translation_range=None,
                 shear_range=None, zoom_range=None, interp="nearest",
                 rng: np.random.Generator | None = None):
        self.params = RandomAffineParams(rotation_range, translation_range,
                                         shear_range, zoom_range)
        self.interp = interp
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray, ins: np.ndarray, seg: np.ndarray):
        """img: (C, H, W) float; ins/seg: (H, W) integer maps."""
        h, w = img.shape[-2:]
        m = self.params.sample_matrix(self.rng, h, w)
        interp = self.interp
        img = affine_warp(img, m, interp)
        ins = affine_warp(ins, m, "nearest")
        seg = affine_warp(seg, m, "nearest")
        return img, ins, seg


def horizontal_flip(arrays):
    """Flip a list of (..., H, W) arrays along W."""
    return [np.ascontiguousarray(np.flip(a, axis=-1)) for a in arrays]


class _FixedAffine:
    """Base for single-transform wrappers (reference transforms.py API)."""

    def __init__(self, matrix: np.ndarray, interp: str = "bilinear"):
        self.matrix = matrix
        self.interp = interp

    def __call__(self, *arrays):
        outs = [affine_warp(a, self.matrix, self.interp) for a in arrays]
        return outs[0] if len(outs) == 1 else tuple(outs)


class Rotate(_FixedAffine):
    def __init__(self, degrees: float, interp: str = "bilinear"):
        super().__init__(rotation_matrix(degrees), interp)


class Translate(_FixedAffine):
    def __init__(self, height_frac: float, width_frac: float,
                 interp: str = "bilinear"):
        # fractions resolve against the first input's size at call time
        self.fracs = (height_frac, width_frac)
        self.interp = interp

    def __call__(self, *arrays):
        h, w = arrays[0].shape[-2:]
        self.matrix = translation_matrix(self.fracs[0] * h,
                                         self.fracs[1] * w)
        return super().__call__(*arrays)


class Shear(_FixedAffine):
    def __init__(self, degrees: float, interp: str = "bilinear"):
        super().__init__(shear_matrix(degrees), interp)


class Zoom(_FixedAffine):
    def __init__(self, zx: float, zy: float | None = None,
                 interp: str = "bilinear"):
        super().__init__(zoom_matrix(zx, zy if zy is not None else zx),
                         interp)


class _RandomChoice:
    """Apply a fixed transform with a parameter drawn from a list — the
    reference's RandomChoice{Rotate,Translate,Shear,Zoom} family
    (src/dataloader/transforms/transforms.py; th_random_choice in
    transforms/utils.py:357). Unused by the training pipeline but part of
    the transforms surface."""

    transform = None  # subclass hook

    def __init__(self, values, interp: str = "bilinear",
                 rng: np.random.Generator | None = None):
        self.values = list(values)
        self.interp = interp
        self.rng = rng or np.random.default_rng()

    def _pick(self):
        return self.values[int(self.rng.integers(len(self.values)))]

    def __call__(self, *arrays):
        v = self._pick()
        args = v if isinstance(v, (tuple, list)) else (v,)
        return type(self).transform(*args, interp=self.interp)(*arrays)


class RandomChoiceRotate(_RandomChoice):
    transform = Rotate


class RandomChoiceTranslate(_RandomChoice):
    """values: (height_frac, width_frac) pairs or scalars used for both."""

    def __call__(self, *arrays):
        v = self._pick()
        hf, wf = (v if isinstance(v, (tuple, list)) else (v, v))
        return Translate(hf, wf, interp=self.interp)(*arrays)


class RandomChoiceShear(_RandomChoice):
    transform = Shear


class RandomChoiceZoom(_RandomChoice):
    transform = Zoom


def random_crop(arrays, crop_hw, rng: np.random.Generator):
    """Random crop of a list of (..., H, W) arrays to crop_hw.

    Offsets are drawn in [0, (size - crop) // 2] along each axis, the
    reference's range."""
    ch, cw = crop_hw
    h, w = arrays[0].shape[-2:]
    range_h = max((h - ch) // 2, 0)
    range_w = max((w - cw) // 2, 0)
    off_h = 0 if range_h == 0 else int(rng.integers(0, range_h + 1))
    off_w = 0 if range_w == 0 else int(rng.integers(0, range_w + 1))
    return [a[..., off_h:off_h + ch, off_w:off_w + cw] for a in arrays]
