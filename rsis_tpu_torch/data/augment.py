"""Host-side geometry for the datasets: the random crop.

Counterpart of ``rsis_tpu/data/augment.py::random_crop`` (the reference's
one-argument ``random.randint`` fixed: the offset is drawn over the full
range). The crop draws from the dataset's seeded numpy generator, as the
JAX package's does, so both packages crop the same sample alike. The rest
of that module (the host affine and flip, ``--host_augment``) is not in
the port yet; the train step augments on the device.
"""

from __future__ import annotations

import numpy as np


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
