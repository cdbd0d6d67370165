"""Cityscapes official-format export and built-in instance AP
(``python -m rsis_tpu_torch.cli.eval_cityscapes -model_name ...``).

Counterpart of ``rsis_tpu/cli/eval_cityscapes.py``. The run is on the
CUDA device unless the caller of ``main`` passes another device; without
a card it raises.
"""

from __future__ import annotations

import os

from ..config import config_from_args
from ..device import resolve_device
from ..evals.cityscapes_ap import evaluate_exported
from ..evals.exporters import CityscapesExporter
from ..train.checkpoint import model_dir
from .eval import exact_fp32, load_eval_variables


def main(argv=None, device=None):
    """Returns {"images", "forward_s", "written" (the .txt indexes), "ap"
    (evaluate_exported's result, None without ground truth)}."""
    device = resolve_device(device, "cli.eval_cityscapes")
    exact_fp32()
    cfg = config_from_args(argv)
    # the architecture comes from the saved train config, the rest from
    # this invocation
    model_cfg, variables = load_eval_variables(cfg)
    results_dir = os.path.join(model_dir(cfg), cfg.model_name + "_results")
    print("Creating annotations for cityscapes validation...")
    exporter = CityscapesExporter(model_cfg, variables, device=device)
    written = exporter.export(results_dir)
    print(f"wrote {len(written)} result files to {results_dir}")

    # built-in instance AP (the reference defers to the external
    # cityscapesScripts; this scores the export directly)
    res = None
    gt_files = exporter.dataset.ins_files
    if gt_files and all(os.path.exists(f) for f in gt_files[:1]):
        txt_names = [os.path.basename(p) for p in written]
        res = evaluate_exported(results_dir, gt_files[:len(txt_names)],
                                txt_names)
        print("allAp: %.4f  allAp50%%: %.4f" % (res["allAp"],
                                                res["allAp50%"]))
    return {"images": exporter.forward.images,
            "forward_s": exporter.forward.seconds, "written": written,
            "ap": res}


if __name__ == "__main__":
    main()
