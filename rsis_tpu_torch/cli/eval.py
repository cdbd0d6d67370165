"""Evaluation entry point: COCO-style eval on Pascal
(``python -m rsis_tpu_torch.cli.eval -model_name ...``).

Counterpart of ``rsis_tpu/cli/eval.py`` (``load_eval_variables``,
``main``), reading the port's checkpoint files (``train/checkpoint.py``).
The run is on the CUDA device unless the caller of ``main`` passes
another device; without a card it raises.
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..config import Config, config_from_args
from ..device import resolve_device
from ..evals.evaluator import Evaluator
from ..train.checkpoint import load_weights, model_dir


def load_eval_variables(cfg: Config):
    """Rebuild the model from the saved train config and checkpoint.

    The saved ``args.json`` decides ONLY the model architecture; every
    runtime choice (dataset dirs, thresholds, display, maxseqlen, batch
    size) comes from the eval invocation. Returns (eval_cfg, (encoder
    state_dict, decoder state_dict)) on the CPU."""
    saved = Config.load(os.path.join(model_dir(cfg), "args.json"))
    eval_cfg = cfg.replace(
        base_model=saved.base_model, hidden_size=saved.hidden_size,
        kernel_size=saved.kernel_size, skip_mode=saved.skip_mode,
        num_classes=saved.num_classes, compute_dtype=saved.compute_dtype,
        dropout=0.0, dropout_stop=0.0, dropout_cls=0.0)
    return eval_cfg, load_weights(cfg)


def exact_fp32() -> None:
    """Keep fp32 products exact on the card (no TF32 in cuBLAS or cuDNN):
    evaluation compares against fp32-trained weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def log_to(cfg: Config, name: str):
    """stdout into ``<model_dir>/<name>`` unless ``--log_term``; restored
    on exit."""
    if cfg.log_term:
        yield
        return
    log_path = os.path.join(model_dir(cfg), name)
    print("Eval logs will be saved to:", log_path)
    with open(log_path, "w") as fp, contextlib.redirect_stdout(fp):
        yield


def main(argv=None, device=None):
    """Returns {"images", "forward_s", "annotations", "stats" (None with
    --no_run_coco_eval or a dataset other than Pascal), "per_class" (with
    --all_classes)}."""
    device = resolve_device(device, "cli.eval")
    exact_fp32()
    cfg = config_from_args(argv)
    with log_to(cfg, "eval.log"):
        eval_cfg, variables = load_eval_variables(cfg)
        ev = Evaluator(eval_cfg, variables, device=device)
        print("Dataset is %s" % eval_cfg.dataset)
        print("Split is %s" % eval_cfg.eval_split)
        print("Evaluating for %d images" % len(ev.sample_list))
        print("Number of classes is %d" % len(ev.class_names))
        # only Pascal has COCO ground truth: Cityscapes and CVPPP (whose
        # display recipes run this CLI) are annotated and displayed, not
        # scored here (the JAX package raises for them without
        # --no_run_coco_eval)
        if eval_cfg.no_run_coco_eval or eval_cfg.dataset != "pascal":
            results = {"annotations": len(ev.create_annotations()),
                       "stats": None}
        else:
            results = ev.run_eval()
    results.update(images=ev.forward.images, forward_s=ev.forward.seconds)
    return results


if __name__ == "__main__":
    main()
