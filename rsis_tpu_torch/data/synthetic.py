"""Seeded synthetic uint8 wire batches (numpy only).

Counterpart of ``bench.py::_synthetic_wire_batch``: the train step's wire
format, an image (B, H, W, 3) uint8 and a packed target (B, N, H*W + 3)
uint8 whose rows are instance masks followed by class id, mask sample
weight and class sample weight. Each image holds 2 to 5 round blobs
(fewer when N is small), sorted by area, largest first, as the reference
orders instances, and the slot after the last blob is the end-of-sequence
slot (class weight 1, mask weight 0).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_wire_batch(rng: np.random.Generator, batch: int, h: int,
                         w: int, n_inst: int, num_classes: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(image uint8 (B, H, W, 3), packed target uint8 (B, N, H*W + 3))."""
    imgs = rng.integers(0, 255, (batch, h, w, 3), dtype=np.uint8)
    tgt = np.zeros((batch, n_inst, h * w + 3), dtype=np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for b in range(batch):
        k = int(rng.integers(2, min(6, n_inst)))
        sizes = []
        for i in range(k):
            cy = rng.integers(h // 8, h - h // 8)
            cx = rng.integers(w // 8, w - w // 8)
            r = int(rng.integers(h // 16, h // 6))
            m = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r
            tgt[b, i, :h * w] = m.reshape(-1)
            tgt[b, i, -3] = int(rng.integers(1, num_classes))
            tgt[b, i, -2] = 1
            tgt[b, i, -1] = 1
            sizes.append(m.sum())
        order = np.argsort(sizes)[::-1]
        tgt[b, :k] = tgt[b, order]
        if k < n_inst:
            tgt[b, k, -1] = 1  # end-of-sequence slot
    return imgs, tgt
