"""Loss-curve parsing and plotting from train.log.

Counterpart of ``rsis_tpu/utils/plot_curves.py``. The epoch-line format
is the API, shared with the reference and the JAX package: lines look
like ``Epoch N:<tab>total:X<tab>class:X<tab>iou:X<tab>stop:X<tab>(split)``.
``plot_curves`` needs matplotlib, imported only when it draws; parsing
needs nothing.
"""

from __future__ import annotations

import os
import re
from collections import defaultdict

_EPOCH_RE = re.compile(
    r"Epoch\s+(\d+):\s*total:([\d.eE+-]+)\s*class:([\d.eE+-]+)\s*"
    r"iou:([\d.eE+-]+)\s*stop:([\d.eE+-]+)\s*\((\w+)\)")


def parse_train_log(path: str):
    """-> {split: {metric: [values by epoch]}} for total/class/iou/stop."""
    curves: dict = {"train": defaultdict(list), "val": defaultdict(list)}
    with open(path) as fp:
        for line in fp:
            m = _EPOCH_RE.search(line)
            if not m:
                continue
            _, total, cls, iou, stop, split = m.groups()
            if split not in curves:
                continue
            curves[split]["total"].append(float(total))
            curves[split]["class"].append(float(cls))
            curves[split]["iou"].append(float(iou))
            curves[split]["stop"].append(float(stop))
    return curves


def plot_curves(model_name: str, models_root: str = "../models",
                log_file: str = "train.log", out_name: str = "curves.png"):
    """Save a 1x4 loss-curve figure beside the log
    (reference: src/plot_curves.py:25-119)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    log_path = os.path.join(models_root, model_name, log_file)
    curves = parse_train_log(log_path)
    fig, axes = plt.subplots(1, 4, figsize=(20, 4))
    for ax, metric in zip(axes, ["total", "iou", "stop", "class"]):
        for split in ["train", "val"]:
            ys = curves[split][metric]
            if ys:
                ax.plot(range(len(ys)), ys, label=split)
        ax.set_title(metric)
        ax.set_xlabel("epoch")
        ax.legend()
    out = os.path.join(models_root, model_name, out_name)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None):
    """CLI mirroring the reference plot_curves.py."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("-model_name", dest="model_name", default="model")
    p.add_argument("-models_root", dest="models_root", default="../models")
    p.add_argument("-log_file", dest="log_file", default="train.log")
    args = p.parse_args(argv)
    out = plot_curves(args.model_name, args.models_root, args.log_file)
    print("Saved:", out)


if __name__ == "__main__":
    main()
