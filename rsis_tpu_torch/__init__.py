"""PyTorch/CUDA port of rsis_tpu for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``rsis_tpu`` is the reference this package is held
against; nothing here imports it. Module names follow their JAX
counterparts (``models/rsis.py`` ports ``rsis_tpu/models/rsis.py`` and so
on). Model modules compute in NCHW; the decode loop and the cell kernels'
wrappers keep the reference's (B, H, C, W) layout. Four slices are
ported: the inference forward (``evals/forward.py``), the training step
(``train/step.py``), the trainer (``cli/train.py``, ``train/loop.py``,
with device augmentation in ``data/device_aug.py``) and evaluation and
prediction (``cli/eval.py``, ``cli/eval_cityscapes.py``,
``cli/eval_leaves.py``, ``cli/predict.py`` over ``evals/`` and the
dataset catalogs). The trainer also takes a pretrained encoder file
(``models/torch_import.py``), a transfer from another model, host-side
augmentation (``data/augment.py``) and ``--visdom`` (``utils/``);
``cli/verify_parity.py`` holds the forward against a plain-torch replica
of the reference (``models/torch_ref.py``). Data-parallel training runs
one process a GPU (``parallel/``, the trainer's ``-num_devices`` and
multi-process flags), streaming inference shards the image's rows over
the ranks (``evals/streaming.py``), and the CVPPP contest harness
(``evals/cvppp_harness.py``) and the Pascal VOC + SBD merge
(``data/tools/pascalplus_gen.py``) run on the host. ``recipes.py`` holds
the repository's nine run recipes (``scripts/*.sh``) and runs them
through the port's command-line modules.

Kernel wrappers dispatch on the device of the tensors they are given: a
CPU tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel (``csrc/``) or raises.
"""

from .config import Config

__all__ = ["Config"]
