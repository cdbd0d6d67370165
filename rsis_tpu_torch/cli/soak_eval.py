"""Score a trained checkpoint on its dataset's val split through the
CVPPP exporter and the SBD / |DiC| metric
(``python -m rsis_tpu_torch.cli.soak_eval -model_name ...``).

Counterpart of ``scripts/soak_eval.py``, the closer of the train -> eval
arc: the checkpoint ``cli.train`` wrote (its architecture from
``args.json``, the rest from this invocation, as the other eval CLIs
read it), the val split of ``-dataset``, the label images of
``evals/exporters.LeavesExporter.predicted_labels`` (in memory, no PNG),
and ``evals/cvppp.evaluate_batch`` against each sample's raw instance
map. Prints one JSON line ``{"SBD", "absDiC", "n", "forward_s",
"n_images"}``; ``forward_s`` is the host wall time of the exporter's
forward loop, not a speed of the model. The run is on the CUDA device
unless the caller of ``main`` passes another device; without a card it
raises.

  python -m rsis_tpu_torch.cli.soak_eval -model_name soak \\
      -models_root build/models -dataset synthetic \\
      -synthetic_length 128 -synthetic_max_instances 8 -num_classes 5 \\
      -imsize 256 --resize -maxseqlen 8 -gt_maxseqlen 10 -batch_size 16
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..config import config_from_args
from ..data.catalogs import get_dataset
from ..device import resolve_device
from ..evals.cvppp import evaluate_batch
from ..evals.exporters import LeavesExporter
from .eval import exact_fp32, load_eval_variables


def main(argv=None, device=None):
    """Returns the printed scores ({"SBD", "absDiC", "n", "forward_s",
    "n_images"}) and, under "labels", the predicted label image of each
    val sample by name."""
    device = resolve_device(device, "cli.soak_eval")
    exact_fp32()
    cfg = config_from_args(argv)
    eval_cfg, variables = load_eval_variables(cfg)
    ds = get_dataset(eval_cfg, split="val", augment=False)
    t0 = time.time()
    labels = LeavesExporter(eval_cfg, variables, dataset=ds,
                            device=device).predicted_labels()
    t1 = time.time()

    preds, gts = [], []
    for i, name in enumerate(ds.get_sample_list()):
        preds.append(labels[os.path.basename(name)])
        gts.append(np.asarray(ds.get_raw_sample(i)[1]))
    res = evaluate_batch(preds, gts)
    res["forward_s"] = round(t1 - t0, 2)
    res["n_images"] = len(preds)
    print(json.dumps(res))
    return {**res, "labels": labels}


if __name__ == "__main__":
    main()
