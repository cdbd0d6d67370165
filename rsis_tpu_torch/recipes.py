"""The repository's nine run recipes (``scripts/*.sh``) through the port.

Each script runs one of the JAX package's command-line modules with a
fixed argument list: training, evaluation and overlay display for
Cityscapes, CVPPP (``leaves``) and Pascal VOC. ``RECIPES`` holds those
argument lists letter for letter, keyed by the script's stem, with the
JAX module ``rsis_tpu.cli.X`` mapped to the port's ``rsis_tpu_torch.cli.X``;
it is the one copy (``tests/test_torch_recipes.py`` holds it equal to the
scripts).

    python -m rsis_tpu_torch.recipes NAME [flags...]

runs recipe NAME on the card with the flags appended, so a later flag
wins, as argparse has it (say ``-cityscapes_dir``, ``-models_root`` or
``-max_epoch``). ``run(name, extra, device)`` is the same call from
Python; its result is the CLI's ``main``'s.
"""

from __future__ import annotations

import importlib
import sys

# stem of scripts/<stem>.sh -> (the port's CLI module, the script's argv)
RECIPES = {
    "train_cityscapes": ("train", [
        "-model_name=cityscapes", "-dataset=cityscapes", "-num_classes=9",
        "--augment", "-maxseqlen=20", "-gt_maxseqlen=20", "-patience=25",
        "-patience_stop=500", "-max_epoch=10000", "-class_loss_after=60",
        "-base_model=resnet101", "-stop_loss_after=100", "-batch_size=32",
        "--curriculum_learning", "-steps_cl=1", "-finetune_after=20",
        "-hidden_size=128", "-min_steps=5", "--log_term"]),
    "train_leaves": ("train", [
        "-model_name=leaves", "-max_epoch=10000", "-dataset=leaves",
        "-num_classes=2", "--augment", "--resize", "-maxseqlen=20",
        "-gt_maxseqlen=20", "-patience_stop=500", "-base_model=resnet101",
        "-class_loss_after=-1", "-batch_size=20", "-patience=30",
        "-stop_loss_after=500", "--curriculum_learning", "-min_steps=5",
        "-stop_weight=0.1", "-imsize=400", "--log_term"]),
    "train_pascal": ("train", ["-model_name", "rsis-pascal", "--resize"]),
    "eval_cityscapes": ("eval_cityscapes", [
        "-model_name=cityscapes", "-dataset=cityscapes", "-batch_size=5",
        "-maxseqlen=20", "--no_run_coco_eval", "--log_term"]),
    "eval_leaves": ("eval_leaves", [
        "-model_name=leaves", "-dataset=leaves", "-batch_size=5",
        "-maxseqlen=20", "--resize", "-imsize=400", "-class_th=0.2",
        "--log_term"]),
    "eval_pascal": ("eval", ["-model_name", "rsis-pascal", "--resize",
                             "--log_term"]),
    "display_cityscapes": ("eval", [
        "-model_name=cityscapes", "-dataset=cityscapes", "-batch_size=5",
        "-maxseqlen=20", "--no_run_coco_eval", "--display", "--log_term"]),
    "display_leaves": ("eval", [
        "-model_name=leaves", "-dataset=leaves", "-batch_size=5",
        "-maxseqlen=20", "--resize", "-imsize=400", "--display",
        "--log_term"]),
    "display_pascal": ("eval", [
        "-model_name", "rsis-pascal", "--resize", "-class_th=0.7",
        "--display", "--log_term"]),
}


def argv(name: str, extra=()) -> list:
    """Recipe ``name``'s argument list with ``extra`` appended."""
    return list(RECIPES[name][1]) + list(extra)


def run(name: str, extra=(), device=None):
    """Run recipe ``name`` with ``extra`` flags appended on ``device``
    (default: the card; the CLI raises without one); returns the CLI's
    result."""
    module = importlib.import_module(f"rsis_tpu_torch.cli.{RECIPES[name][0]}")
    return module.main(argv(name, extra), device=device)


def main(args=None) -> int:
    args = sys.argv[1:] if args is None else list(args)
    if not args or args[0] not in RECIPES:
        print("usage: python -m rsis_tpu_torch.recipes NAME [flags...]\n"
              "NAME: " + ", ".join(RECIPES), file=sys.stderr)
        return 2
    run(args[0], args[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
