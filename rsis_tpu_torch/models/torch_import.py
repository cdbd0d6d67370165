"""Pretrained weight files into the port's encoder.

Counterpart of the loader half of ``rsis_tpu/models/torch_import.py``
(``strip_parallel_prefix``, ``load_state_dict_file``,
``init_encoder_from_torch``, and ``merge_encoder_state``, its part after
the file is read). The port's modules keep the reference and
torchvision key names (``models/backbones.py``), so a file's tensors go
into the encoder's state_dict as they are, with no transposition. Two
layouts are told apart by their keys:

- a reference ``encoder.pt`` (``base.*`` plus the skip heads
  ``sk{i}``/``bn{i}``, found by any ``sk1.`` key) replaces the whole
  encoder;
- a torchvision ResNet (``conv1.weight``) or VGG-16 (``features.0.weight``)
  backbone replaces only ``base.*``; the skip heads keep their fresh
  init, as the reference's constructor leaves them.

Loading is strict: a key the encoder lacks, a key of it the file lacks,
or a shape that differs raises. Only what the JAX importer never reads
is passed over: the classifier (``fc.*``, VGG's ``classifier.*``) and
BatchNorm's ``num_batches_tracked`` counters (the encoder keeps its own),
in either layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_IMPORTABLE = ("resnet34", "resnet50", "resnet101", "vgg16")
# keys of a torchvision file that the backbone has no module for
_CLASSIFIER = ("fc.", "classifier.")


def strip_parallel_prefix(sd: Mapping[str, object]) -> Dict[str, object]:
    """Remove DataParallel ``module.`` prefixes if present."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):] if k.startswith("module.") else k: v
                for k, v in sd.items()}
    return dict(sd)


def load_state_dict_file(path: str) -> Dict[str, object]:
    """A torch state_dict from .pt/.pth (through torch, onto the CPU) or
    .npz (numpy arrays; export with
    ``np.savez(path, **{k: v.numpy() for k, v in sd.items()})``). A saved
    module, or a dict holding its ``state_dict``, is unwrapped."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return dict(sd)


def _counter(key: str) -> bool:
    return key.endswith("num_batches_tracked")


def _merge(target: Dict[str, torch.Tensor], source: Mapping[str, object],
           prefix: str, what: str) -> None:
    """Copy ``source[k]`` into ``target[prefix + k]`` for every key of the
    target under ``prefix`` but the counters; raise on a missing, extra
    or misshapen key."""
    want = {k[len(prefix):] for k in target
            if k.startswith(prefix) and not _counter(k)}
    have = {k for k in source if not _counter(k)}
    missing, extra = sorted(want - have), sorted(have - want)
    if missing or extra:
        raise ValueError(f"{what}: missing keys {missing[:5]} "
                         f"({len(missing)}), unexpected keys {extra[:5]} "
                         f"({len(extra)})")
    for k in sorted(want):
        old = target[prefix + k]
        new = torch.as_tensor(source[k])
        if tuple(new.shape) != tuple(old.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(new.shape)}, "
                             f"the encoder's {tuple(old.shape)}")
        target[prefix + k] = new.to(old.dtype).clone()


def _drop_classifier(sd: Mapping[str, object], base: str) -> dict:
    """``sd`` without the backbone's classifier keys (under ``base``)."""
    heads = tuple(base + c for c in _CLASSIFIER)
    return {k: v for k, v in sd.items() if not k.startswith(heads)}


def merge_encoder_state(sd: Mapping[str, object], base_model: str,
                        encoder_sd: Mapping[str, torch.Tensor],
                        what: str = "state_dict"
                        ) -> Dict[str, torch.Tensor]:
    """A new encoder state_dict: ``encoder_sd`` (the fresh encoder's)
    with the pretrained weights of ``sd`` (either layout, tensors or
    numpy arrays) merged in; neither input is mutated. A reference
    ``encoder.pt`` replaces every tensor, a torchvision backbone only
    ``base.*``. Raises ValueError for a base_model without a torch layout
    (``tiny``) and for weights that do not fit the encoder."""
    if base_model not in _IMPORTABLE:
        raise ValueError(
            f"no torch import layout for base_model={base_model!r}")
    sd = strip_parallel_prefix(sd)
    out = dict(encoder_sd)
    if any(k.startswith("sk1.") for k in sd):
        _merge(out, _drop_classifier(sd, "base."), "",
               f"{what} (reference encoder)")
    else:
        _merge(out, _drop_classifier(sd, ""), "base.",
               f"{what} ({base_model} backbone)")
    return out


def init_encoder_from_torch(path: str, base_model: str,
                            encoder_sd: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """``merge_encoder_state`` of the file at ``path`` (.pt, .pth or
    .npz): the fresh-start twin of the reference's ImageNet-pretrained
    backbone."""
    return merge_encoder_state(load_state_dict_file(path), base_model,
                               encoder_sd, what=path)
