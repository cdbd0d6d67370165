"""Pascal / display color palettes and palette-PNG decoding

Counterpart of ``rsis_tpu/data/tools/palettes.py``: a copy.
(reference: src/dataloader/dataset_utils.py:60-131)."""

from __future__ import annotations

import numpy as np


def pascal_palette() -> dict:
    """RGB triplet -> Pascal class id (255 = ignore)."""
    return {(0, 0, 0): 0, (128, 0, 0): 1, (0, 128, 0): 2, (128, 128, 0): 3,
            (0, 0, 128): 4, (128, 0, 128): 5, (0, 128, 128): 6,
            (128, 128, 128): 7, (64, 0, 0): 8, (192, 0, 0): 9,
            (64, 128, 0): 10, (192, 128, 0): 11, (64, 0, 128): 12,
            (192, 0, 128): 13, (64, 128, 128): 14, (192, 128, 128): 15,
            (0, 64, 0): 16, (128, 64, 0): 17, (0, 192, 0): 18,
            (128, 192, 0): 19, (0, 64, 128): 20, (224, 224, 192): 255}


def sequence_palette() -> dict:
    """RGB triplet -> instance display id."""
    return {(0, 0, 0): 0, (0, 255, 0): 1, (255, 0, 0): 2, (0, 0, 255): 3,
            (255, 0, 255): 4, (0, 255, 255): 5, (255, 128, 0): 6,
            (102, 0, 102): 7, (51, 153, 255): 8, (153, 153, 255): 9,
            (153, 153, 0): 10, (178, 102, 255): 11, (204, 0, 204): 12,
            (0, 102, 0): 13, (102, 0, 0): 14, (51, 0, 0): 15,
            (0, 64, 0): 16, (128, 64, 0): 17, (0, 192, 0): 18,
            (128, 192, 0): 19, (0, 64, 128): 20, (224, 224, 192): 21}


def convert_from_color_segmentation(arr_3d: np.ndarray) -> np.ndarray:
    """RGB palette image (H, W, 3) -> 2D class-id map, vectorized (the
    reference's per-pixel dict loop was its own noted bottleneck)."""
    palette = pascal_palette()
    key = (arr_3d[..., 0].astype(np.int64) << 16 \
           | arr_3d[..., 1].astype(np.int64) << 8
           | arr_3d[..., 2].astype(np.int64))
    lut = np.zeros(1 << 24, dtype=np.uint8)
    for (r, g, b), cid in palette.items():
        lut[(r << 16) | (g << 8) | b] = cid
    return lut[key]
