"""Training monitor: one JSON line of metrics per logged step, and mask
snapshots.

Counterpart of ``rsis_tpu/utils/monitor.py::Monitor``:

- ``metrics.jsonl`` in the model directory, appended to, one object per
  train or val batch with the same keys (``t`` seconds since the monitor
  opened, ``split``, ``epoch``, ``batch``, ``total``, ``iou``, ``stop``,
  ``class`` and any extra keyword such as ``T``);
- with ``enable_snapshots`` (``--visdom``), ``snapshot`` writes
  ``masks_epoch{epoch:04d}.png``: predicted masks above the ground truth,
  one column a decode step, each panel titled with its step and class
  name. The JAX package draws it with matplotlib; here numpy colours the
  masks (viridis over [0, 1]) and Pillow lays out the grid and writes the
  titles in its default font, so nothing needs matplotlib.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

PAD = 4          # pixels around and between panels
TITLE_H = 14     # the title band above each panel
MIN_SIDE = 96    # small masks are enlarged by a whole factor to this side

# viridis at 0, 0.25, 0.5, 0.75 and 1, interpolated linearly between
_VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                     [94, 201, 98], [253, 231, 37]], dtype=np.float64)


def colorize(mask: np.ndarray) -> np.ndarray:
    """(H, W) values in [0, 1] (clipped) -> (H, W, 3) uint8 viridis."""
    v = np.clip(np.nan_to_num(np.asarray(mask, np.float64)), 0.0, 1.0)
    pos = v * (len(_VIRIDIS) - 1)
    lo = np.minimum(pos.astype(np.int64), len(_VIRIDIS) - 2)
    frac = (pos - lo)[..., None]
    rgb = _VIRIDIS[lo] * (1.0 - frac) + _VIRIDIS[lo + 1] * frac
    return np.round(rgb).astype(np.uint8)


def panel_scale(h: int, w: int) -> int:
    """The whole factor a (h, w) mask is enlarged by in a snapshot."""
    return max(1, -(-MIN_SIDE // max(1, min(h, w))))


def snapshot_size(t_steps: int, h: int, w: int) -> tuple:
    """(width, height) in pixels of the snapshot of T masks of (h, w)."""
    s = panel_scale(h, w)
    cols = max(t_steps, 1)
    return (PAD + cols * (w * s + PAD), PAD + 2 * (TITLE_H + h * s + PAD))


class Monitor:
    def __init__(self, model_dir: str, enable_snapshots: bool = False):
        self.model_dir = model_dir
        self.enable_snapshots = enable_snapshots
        os.makedirs(model_dir, exist_ok=True)
        self._fp = open(os.path.join(model_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, split: str, epoch: int, batch: int, total: float,
            iou: float, stop: float, cls: float, **extra) -> None:
        rec = {"t": round(time.time() - self._t0, 3), "split": split,
               "epoch": epoch, "batch": batch,
               "total": float(total), "iou": float(iou),
               "stop": float(stop), "class": float(cls)}
        rec.update(extra)
        self._fp.write(json.dumps(rec) + "\n")
        self._fp.flush()

    def snapshot(self, epoch: int, pred_masks: np.ndarray,
                 true_masks: np.ndarray,
                 pred_classes: Optional[np.ndarray] = None,
                 true_classes: Optional[np.ndarray] = None,
                 class_names=None) -> Optional[str]:
        """Save the grid of predicted (top row) and ground-truth (bottom
        row) masks of one sample; returns its path, or None when
        snapshots are off.

        pred_masks, true_masks: (T, H, W) arrays; pred_classes,
        true_classes: T class ids, titled by ``class_names``."""
        if not self.enable_snapshots:
            return None
        from PIL import Image, ImageDraw

        t_steps, h, w = pred_masks.shape
        s = panel_scale(h, w)
        grid = Image.new("RGB", snapshot_size(t_steps, h, w), "white")
        draw = ImageDraw.Draw(grid)
        for row, (label, masks, classes) in enumerate(
                (("pred", pred_masks, pred_classes),
                 ("true", true_masks, true_classes))):
            y = PAD + row * (TITLE_H + h * s + PAD)
            for t in range(t_steps):
                x = PAD + t * (w * s + PAD)
                title = f"{label} t={t}"
                if classes is not None and class_names is not None:
                    title += f" {class_names[int(classes[t])]}"
                draw.text((x, y), title, fill="black")
                rgb = colorize(masks[t]).repeat(s, 0).repeat(s, 1)
                grid.paste(Image.fromarray(rgb), (x, y + TITLE_H))
        out = os.path.join(self.model_dir, f"masks_epoch{epoch:04d}.png")
        grid.save(out)
        return out

    def close(self) -> None:
        self._fp.close()
