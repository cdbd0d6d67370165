"""Model configuration read by the inference forward.

Counterpart of ``rsis_tpu/config.py::Config``: a copy of the fields the
inference slice reads, with the same names and defaults, so a JAX
``Config`` and this one describe the same model. Kernel dispatch goes by
tensor device, so there is no ``pallas`` knob.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    base_model: str = "resnet101"
    hidden_size: int = 128
    num_classes: int = 21
    kernel_size: int = 3
    skip_mode: str = "concat"
    maxseqlen: int = 10
    compute_dtype: str = "float32"  # or "bfloat16"
