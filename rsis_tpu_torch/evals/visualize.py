"""Prediction overlay rendering (the reference --display path).

Counterpart of ``rsis_tpu/evals/visualize.py``: a copy; matplotlib is
imported only when a figure is drawn.

Re-design of ``display_masks`` (reference: src/eval.py:30-95): decode each
annotation's RLE, tint it with the sequence palette, and overlay onto the
source image with optional class/score captions; figures land in
``<model_dir>/<model>_figs_<split>/``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..data.tools.palettes import sequence_palette
from ..kernels import mask as maskUtils

_ABBREV = {"motorbike": "motor", "bicycle": "bike",
           "dining table": "table", "potted plant": "plant",
           "airplane": "plane"}


def palette_colors() -> List[tuple]:
    inv = {v: k for k, v in sequence_palette().items()}
    return [inv[i] for i in sorted(inv) if i not in (0, 21)]


def display_masks(image: np.ndarray, anns: List[dict], out_path: str,
                  no_display_text: bool = False,
                  display_route: bool = False) -> Optional[str]:
    """Render annotation overlays for one image and save a figure."""
    if len(anns) == 0:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.ndimage import center_of_mass

    colors = palette_colors()
    fig, ax = plt.subplots()
    ax.axis("off")
    ax.imshow(image)
    xs, ys = [], []
    for i, ann in enumerate(anns):
        if ann.get("ignore") == 1:
            continue
        m = maskUtils.decode(ann["segmentation"])
        if m.sum() == 0:
            continue
        color = np.array(colors[i % len(colors)]) / 255.0
        overlay = np.ones(m.shape + (3,)) * color
        ax.imshow(np.dstack((overlay, m * 0.5)))
        y, x = center_of_mass(m)
        x = float(np.clip(x - 30, 0, m.shape[1] - 30))
        y = float(np.clip(y - 10, 0, m.shape[0] - 10))
        xs.append(x)
        ys.append(y)
        if not no_display_text:
            name = ann.get("category_name", str(ann.get("category_id")))
            name = _ABBREV.get(name, name)
            txt = (f"{i}" if display_route
                   else f"{i}: {name}. {ann.get('score', 0):.2f}")
            ax.text(x, y, txt, bbox={"facecolor": color, "alpha": 0.6})
    if display_route and len(xs) > 1:
        ax.add_line(matplotlib.lines.Line2D(xs, ys, color="r", linewidth=1))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path
