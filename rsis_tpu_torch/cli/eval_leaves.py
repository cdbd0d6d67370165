"""CVPPP label-image export and SBD/|DiC| scoring
(``python -m rsis_tpu_torch.cli.eval_leaves -model_name ...``).

Counterpart of ``rsis_tpu/cli/eval_leaves.py``. The run is on the CUDA
device unless the caller of ``main`` passes another device; without a
card it raises.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from ..config import config_from_args
from ..device import resolve_device
from ..evals.cvppp import evaluate_batch
from ..evals.exporters import LeavesExporter
from ..train.checkpoint import model_dir
from .eval import exact_fp32, load_eval_variables


def main(argv=None, device=None):
    """Returns {"images", "forward_s", "written" (the label PNGs),
    "scores" (evaluate_batch's result, None for a split without
    labels)}."""
    device = resolve_device(device, "cli.eval_leaves")
    exact_fp32()
    cfg = config_from_args(argv)
    # the architecture comes from the saved train config, the rest from
    # this invocation
    model_cfg, variables = load_eval_variables(cfg)
    results_dir = os.path.join(model_dir(cfg), cfg.model_name + "_results")
    print("Creating annotations for leaves validation...")
    exporter = LeavesExporter(model_cfg, variables, device=device)
    written = exporter.export(results_dir)
    print(f"wrote {len(written)} label images to {results_dir}")

    # score against GT when the split has labels (val); test has none
    res = None
    ds = exporter.dataset
    if ds.gt_files:
        preds = [np.array(Image.open(p)) for p in written]
        gts = [np.array(Image.open(f)) for f in ds.gt_files]
        res = evaluate_batch(preds, gts)
        print("SBD: %.4f  |DiC|: %.4f  (n=%d)"
              % (res["SBD"], res["absDiC"], res["n"]))
    return {"images": exporter.forward.images,
            "forward_s": exporter.forward.seconds, "written": written,
            "scores": res}


if __name__ == "__main__":
    main()
