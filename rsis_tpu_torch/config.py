"""Model and training configuration read by the port.

Counterpart of ``rsis_tpu/config.py::Config``: a copy of the fields the
inference forward and the training step read, with the same names and
defaults, so a JAX ``Config`` and this one describe the same model and
the same step. Kernel dispatch goes by tensor device, so there is no
``pallas`` knob.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class Config:
    # model
    base_model: str = "resnet101"
    hidden_size: int = 128
    num_classes: int = 21
    kernel_size: int = 3
    skip_mode: str = "concat"
    maxseqlen: int = 10
    compute_dtype: str = "float32"  # or "bfloat16"

    # data and schedule
    batch_size: int = 28
    gt_maxseqlen: int = 20
    imsize: int = 256

    # optimizers: "adam", "sgd" or "rmsprop", L2 decay added to the gradient
    optim: str = "adam"
    optim_cnn: str = "adam"
    lr: float = 1e-3
    lr_cnn: float = 1e-6
    weight_decay: float = 1e-6
    weight_decay_cnn: float = 1e-6
    momentum: float = 0.9

    # loss weights
    iou_weight: float = 1.0
    class_weight: float = 0.1
    stop_weight: float = 0.5
    stop_balance_weight: float = 0.5

    # loss schedule and encoder fine-tuning (StepFlags.from_config)
    use_class_loss: bool = False
    use_stop_loss: bool = False
    update_encoder: bool = False

    # decode-step rematerialisation: auto (off while the saved decode
    # activations fit), on, off; see train/step.py::_resolve_remat
    remat: str = "auto"
    # not in this port yet: any dropout and device augmentation raise
    dropout: float = 0.0
    dropout_stop: float = 0.0
    dropout_cls: float = 0.0
    augment: bool = False

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
