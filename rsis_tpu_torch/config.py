"""Model, training and run configuration read by the port.

Counterpart of ``rsis_tpu/config.py`` (``Config``, ``get_parser``,
``config_from_args``): a copy of the fields the inference forward, the
training step and the train loop read, with the same names, defaults and
command-line flags, so a JAX ``Config`` and this one describe the same
model and the same run, training, evaluation and prediction alike.
Kernel dispatch goes by tensor device, so there is no ``pallas`` knob; the
JAX package's mesh, multi-host and checkpoint-format knobs are not here and
their flags are refused.
Like the reference, the config is saved beside the checkpoints
(``args.json``) and takes precedence on resume.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass


@dataclass
class Config:
    # training
    resume: bool = False
    epoch_resume: int = 0
    seed: int = 123
    batch_size: int = 28
    # optimizers: "adam", "sgd" or "rmsprop", L2 decay added to the gradient
    lr: float = 1e-3
    lr_cnn: float = 1e-6
    optim_cnn: str = "adam"
    momentum: float = 0.9
    weight_decay: float = 1e-6
    weight_decay_cnn: float = 1e-6
    optim: str = "adam"
    maxseqlen: int = 10
    gt_maxseqlen: int = 20
    best_val_loss: float = 1000.0
    crop: bool = False
    smooth_curves: bool = False

    # encoder fine-tuning and curriculum
    finetune_after: int = 0
    update_encoder: bool = False
    # initialisation from another model's checkpoint (a fresh fc_class
    # when the dataset differs) or from a torchvision / reference encoder
    # file (train/loop.py, models/torch_import.py)
    transfer: bool = False
    transfer_from: str = "model"
    torch_encoder: str = ""
    curriculum_learning: bool = False
    steps_cl: int = 1
    min_steps: int = 1
    min_delta: float = 0.0
    limit_seqlen_to: int = 0

    # loss schedule (StepFlags.from_config)
    class_loss_after: int = 20
    use_class_loss: bool = False
    stop_loss_after: int = 3000
    use_stop_loss: bool = False

    # stopping criterion
    patience: int = 15
    patience_stop: int = 60
    max_epoch: int = 4000

    # logging; visdom: a mask snapshot a epoch and the loopback dashboard
    # on ``port`` (utils/monitor.py, utils/dashboard.py)
    print_every: int = 10
    log_term: bool = False
    visdom: bool = False
    port: int = 8097

    # loss weights
    class_weight: float = 0.1
    iou_weight: float = 1.0
    stop_weight: float = 0.5
    stop_balance_weight: float = 0.5

    # augmentation: flip + one fused affine per sample inside the train
    # step (data/device_aug.py, the warp kernel K7); augment_on_device
    # False (--host_augment) flips and warps in the train loader's numpy
    # instead (data/augment.py)
    augment: bool = False
    augment_on_device: bool = True
    rotation: int = 10
    translation: float = 0.1
    shear: float = 0.1
    zoom: float = 0.7

    compute_dtype: str = "float32"  # or "bfloat16"
    # decode-step rematerialisation: auto (off while the saved decode
    # activations fit), on, off; see train/step.py::_resolve_remat
    remat: str = "auto"

    # model
    base_model: str = "resnet101"
    skip_mode: str = "concat"
    model_name: str = "model"
    log_file: str = "train.log"
    hidden_size: int = 128
    kernel_size: int = 3
    dropout: float = 0.0
    dropout_stop: float = 0.0
    dropout_cls: float = 0.0

    # dataset
    imsize: int = 256
    resize: bool = False
    num_classes: int = 21
    dataset: str = "pascal"
    pascal_dir: str = "/data/VOCAug/"
    cityscapes_dir: str = "/data/CityScapes/"
    leaves_dir: str = "/data/LeavesDataset/A1/"
    leaves_test_dir: str = "/data/CVPPP2014_LSC_testing_data/A1/"
    num_workers: int = 4
    synthetic_length: int = 16
    synthetic_max_instances: int = 4
    models_root: str = "../models"

    # testing / evaluation (cli/eval*.py)
    eval_split: str = "test"
    mask_th: float = 0.5
    stop_th: float = 0.5
    class_th: float = 0.5
    max_dets: int = 100
    min_size: float = 0.001
    cat_id: int = -1
    use_cats: bool = True
    display: bool = False
    no_display_text: bool = False
    all_classes: bool = False
    no_run_coco_eval: bool = False
    display_route: bool = False

    # the prediction CLI (cli/predict.py): any images in, instances out
    predict_input: str = ""      # image file, directory, or glob
    predict_output: str = ""     # output dir (default <model>/predictions)
    predict_format: str = "both"  # png | coco | both

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Known keys only: an ``args.json`` written by the JAX package
        loads too, without its TPU knobs."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            json.dump(self.to_dict(), fp, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as fp:
            return cls.from_dict(json.load(fp))


def get_parser() -> argparse.ArgumentParser:
    """The JAX package's command-line surface (the reference's), for the
    fields this Config has."""
    p = argparse.ArgumentParser(description="rsis_tpu_torch")
    d = Config()

    def flag(name, dest, **kw):
        kw.setdefault("default", getattr(d, dest))
        p.add_argument(name, dest=dest, **kw)

    def switch(name, dest, store=True):
        flag(name, dest, action="store_true" if store else "store_false")

    optims = ["adam", "sgd", "rmsprop"]
    # training
    switch("--resume", "resume")
    flag("-epoch_resume", "epoch_resume", type=int)
    flag("-seed", "seed", type=int)
    flag("-batch_size", "batch_size", type=int)
    flag("-lr", "lr", type=float)
    flag("-lr_cnn", "lr_cnn", type=float)
    flag("-optim_cnn", "optim_cnn", choices=optims)
    flag("-momentum", "momentum", type=float)
    flag("-weight_decay", "weight_decay", type=float)
    flag("-weight_decay_cnn", "weight_decay_cnn", type=float)
    flag("-optim", "optim", choices=optims)
    flag("-maxseqlen", "maxseqlen", type=int)
    flag("-gt_maxseqlen", "gt_maxseqlen", type=int)
    flag("-best_val_loss", "best_val_loss", type=float)
    switch("--crop", "crop")
    switch("--smooth_curves", "smooth_curves")
    # encoder fine-tuning and curriculum
    flag("-finetune_after", "finetune_after", type=int)
    switch("--update_encoder", "update_encoder")
    switch("--transfer", "transfer")
    flag("-transfer_from", "transfer_from")
    flag("-torch_encoder", "torch_encoder")
    switch("--curriculum_learning", "curriculum_learning")
    flag("-steps_cl", "steps_cl", type=int)
    flag("-min_steps", "min_steps", type=int)
    flag("-min_delta", "min_delta", type=float)
    # loss schedule
    flag("-class_loss_after", "class_loss_after", type=int)
    switch("--use_class_loss", "use_class_loss")
    flag("-stop_loss_after", "stop_loss_after", type=int)
    switch("--use_stop_loss", "use_stop_loss")
    # stopping criterion
    flag("-patience", "patience", type=int)
    flag("-patience_stop", "patience_stop", type=int)
    flag("-max_epoch", "max_epoch", type=int)
    # logging
    flag("-print_every", "print_every", type=int)
    switch("--log_term", "log_term")
    switch("--visdom", "visdom")
    flag("-port", "port", type=int)
    # loss weights
    flag("-class_weight", "class_weight", type=float)
    flag("-iou_weight", "iou_weight", type=float)
    flag("-stop_weight", "stop_weight", type=float)
    flag("-stop_balance_weight", "stop_balance_weight", type=float)
    # augmentation
    switch("--augment", "augment")
    switch("--host_augment", "augment_on_device", store=False)
    flag("-rotation", "rotation", type=int)
    flag("-translation", "translation", type=float)
    flag("-shear", "shear", type=float)
    flag("-zoom", "zoom", type=float)
    flag("-compute_dtype", "compute_dtype", choices=["float32", "bfloat16"])
    flag("-remat", "remat", choices=["auto", "on", "off"])
    # model
    flag("-base_model", "base_model",
         choices=["resnet101", "resnet50", "resnet34", "vgg16", "tiny"])
    flag("-skip_mode", "skip_mode", choices=["sum", "concat", "mul", "none"])
    flag("-model_name", "model_name")
    flag("-log_file", "log_file")
    flag("-hidden_size", "hidden_size", type=int)
    flag("-kernel_size", "kernel_size", type=int)
    flag("-dropout", "dropout", type=float)
    flag("-dropout_stop", "dropout_stop", type=float)
    flag("-dropout_cls", "dropout_cls", type=float)
    # dataset
    flag("-imsize", "imsize", type=int)
    switch("--resize", "resize")
    flag("-num_classes", "num_classes", type=int)
    flag("-dataset", "dataset",
         choices=["pascal", "cityscapes", "leaves", "synthetic"])
    flag("-pascal_dir", "pascal_dir")
    flag("-cityscapes_dir", "cityscapes_dir")
    flag("-leaves_dir", "leaves_dir")
    flag("-leaves_test_dir", "leaves_test_dir")
    flag("-num_workers", "num_workers", type=int)
    flag("-synthetic_length", "synthetic_length", type=int)
    flag("-synthetic_max_instances", "synthetic_max_instances", type=int)
    flag("-models_root", "models_root")
    # testing
    flag("-eval_split", "eval_split")
    flag("-mask_th", "mask_th", type=float)
    flag("-stop_th", "stop_th", type=float)
    flag("-class_th", "class_th", type=float)
    flag("-max_dets", "max_dets", type=int)
    flag("-min_size", "min_size", type=float)
    flag("-cat_id", "cat_id", type=int)
    switch("--ignore_cats", "use_cats", store=False)
    switch("--display", "display")
    switch("--no_display_text", "no_display_text")
    switch("--all_classes", "all_classes")
    switch("--no_run_coco_eval", "no_run_coco_eval")
    switch("--display_route", "display_route")
    flag("-predict_input", "predict_input")
    flag("-predict_output", "predict_output")
    flag("-predict_format", "predict_format",
         choices=["png", "coco", "both"])
    return p


def config_from_args(argv=None) -> Config:
    return Config.from_dict(vars(get_parser().parse_args(argv)))

