"""On-device train-batch augmentation: a per-sample 50% horizontal flip and
one fused affine, applied alike to the images and the packed masks.

Counterpart of ``rsis_tpu/data/device_aug.py`` (``sample_affine_matrices``,
``zoom_range_for``, ``augment_wire_batch``). Random numbers come from an
explicit ``torch.Generator`` (on the batch's device), drawn in a fixed
order: the flips, then the rotation, the two translations, the shear and
the zooms. ``affine_from_draws`` composes R @ T @ Sh @ Z from the drawn
values and ``augment_wire_batch_with`` takes the flips and matrices
ready-made, so a test can feed both the JAX package's own draws. Under
data parallelism (``rows``) the draws are made at the global batch's
shape on every rank and each rank keeps its rows, so a sharded step
augments each image as one process would.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops.warp import affine_warp


def _stack3(*rows) -> torch.Tensor:
    """Nine (B,) tensors, row-major -> (B, 3, 3)."""
    return torch.stack(rows, -1).reshape(-1, 3, 3)


def affine_from_draws(deg: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
                      sdeg: torch.Tensor,
                      zoom: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 3, 3) float32 matrices R @ T @ Sh (@ Z) from the drawn values:
    rotation and shear in degrees, translations in pixels (rows, columns),
    zoom (B, 2) or None."""
    t = deg * (math.pi / 180.0)
    cos, sin = torch.cos(t), torch.sin(t)
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    rot = _stack3(cos, -sin, zero, sin, cos, zero, zero, zero, one)
    trans = _stack3(one, zero, tx, zero, one, ty, zero, zero, one)
    st = sdeg * (math.pi / 180.0)
    sh = _stack3(one, -torch.sin(st), zero, zero, torch.cos(st), zero,
                 zero, zero, one)
    m = rot @ trans @ sh
    if zoom is not None:
        zm = _stack3(zoom[:, 0], zero, zero, zero, zoom[:, 1], zero,
                     zero, zero, one)
        m = m @ zm
    return m


def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def sample_affine_matrices(gen: torch.Generator, batch: int, h: int, w: int,
                           rotation: float = 0.0, translation: float = 0.0,
                           shear: float = 0.0,
                           zoom_range: Tuple[float, float] | None = None
                           ) -> torch.Tensor:
    """(B, 3, 3) fused matrices with the reference composition order, on
    the generator's device."""
    deg = _uniform(gen, (batch,), -rotation, rotation)
    tx = _uniform(gen, (batch,), -translation, translation) * h
    ty = _uniform(gen, (batch,), -translation, translation) * w
    sdeg = _uniform(gen, (batch,), -shear, shear)
    zoom = (None if zoom_range is None
            else _uniform(gen, (batch, 2), zoom_range[0], zoom_range[1]))
    return affine_from_draws(deg, tx, ty, sdeg, zoom)


def zoom_range_for(cfg) -> Tuple[float, float] | None:
    """The dataset-dependent zoom range of the host pipeline, shared by
    the device path."""
    if not cfg.resize and cfg.dataset != "pascal":
        return None
    if cfg.dataset == "pascal":
        return (cfg.zoom, max(cfg.zoom * 2, 1.0))
    return (cfg.zoom, 1.0)


def augment_wire_batch_with(x: torch.Tensor, y_mask: torch.Tensor,
                            matrices: torch.Tensor, flip: torch.Tensor,
                            plain: bool = False):
    """Flip and warp images x (B, H, W, 3) and packed instance masks
    y_mask (B, N, H*W) uint8 by given flips (B,) bool and matrices
    (B, 3, 3). Returns (x, y_mask) of the same shapes and dtypes.

    The N masks are disjoint, so they collapse into one uint8 id plane
    (the mask index + 1, 0 for background) as a multiply and a max, which
    the warp kernel (K7) moves together with the image; an equality
    compare expands the ids back into N masks. Ids up to N must fit a
    byte, so N >= 256 raises. plain=True warps with the plain version on
    any device."""
    b, h, w = x.shape[:3]
    n = y_mask.shape[1]
    if n >= 256:
        raise ValueError(f"{n} instance slots: the uint8 id plane holds at "
                         f"most 255")
    lbl = torch.arange(1, n + 1, dtype=torch.uint8, device=y_mask.device)
    ids = torch.amax(y_mask.reshape(b, n, h, w) * lbl[None, :, None, None],
                     dim=1)
    x, ids = affine_warp(x.contiguous(), ids, matrices, flip, plain=plain)
    masks = ids.reshape(b, 1, h * w) == lbl[None, :, None]
    return x, masks.to(y_mask.dtype)


def augment_wire_batch(gen: torch.Generator, x: torch.Tensor,
                       y_mask: torch.Tensor, rotation: float,
                       translation: float, shear: float,
                       zoom_range: Tuple[float, float] | None,
                       plain: bool = False,
                       rows: Tuple[int, int] | None = None):
    """On-device train-batch augmentation: draws a 50% flip per sample,
    then one fused R @ T @ Sh @ Z matrix per sample, from ``gen``, and
    applies both as ``augment_wire_batch_with`` does. rows = (offset,
    global batch): x holds rows offset.. of a global batch, the draws are
    made for the global batch and these rows kept (K7 warps only them).

    Geometric twin of the host path: flip first, then the inverse warp
    with nearest interpolation. Nearest sampling is a gather, so it
    commutes with the binarisation of the packed masks and with the
    normalisation of the image; instances warped fully out of frame keep
    their (now empty) slot."""
    b, h, w = x.shape[:3]
    off, total = rows or (0, b)
    flip = torch.rand((total,), generator=gen, device=gen.device) < 0.5
    matrices = sample_affine_matrices(gen, total, h, w, rotation,
                                      translation, shear, zoom_range)
    return augment_wire_batch_with(x, y_mask, matrices[off:off + b],
                                   flip[off:off + b], plain=plain)
