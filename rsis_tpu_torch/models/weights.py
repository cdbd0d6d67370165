"""JAX variables -> the port's state_dicts.

Inverse of ``rsis_tpu/models/torch_import.py``: the JAX package's variables
pytree (numpy leaves, ``{"params": {"encoder", "decoder"}, "batch_stats":
{"encoder"}}``) becomes the state_dicts of ``FeatureExtractor`` and
``RSISDecoder`` in the reference key layout (``base.*`` in torchvision
names, ``sk{i}``, ``bn{i}``, ``clstm_list.{i}.Gates``, ``conv_out``,
``fc_class``, ``fc_stop``), which ``torch_import`` reads back. Also covers
the ``tiny`` trunk (``base.conv{i}`` with bias), which has no reference
layout.

  flax conv kernel (kH, kW, I, O) -> torch weight (O, I, kH, kW)
  flax dense kernel (I, O)        -> torch weight (O, I)
  BatchNorm scale/bias, mean/var  -> weight/bias, running_mean/running_var
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

_STAGE_SIZES = {"resnet34": (3, 4, 6, 3), "resnet50": (3, 4, 6, 3),
                "resnet101": (3, 4, 23, 3)}
# conv layer indices in torchvision's VGG-16 ``features``
_VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _conv(sd: StateDict, key: str, p: Mapping) -> None:
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _dense(sd: StateDict, key: str, p: Mapping) -> None:
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).transpose(1, 0))
    sd[key + ".bias"] = _t(p["bias"])


def _bn(sd: StateDict, key: str, p: Mapping, s: Mapping) -> None:
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])
    sd[key + ".running_mean"] = _t(s["mean"])
    sd[key + ".running_var"] = _t(s["var"])
    sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _resnet(sd: StateDict, p: Mapping, s: Mapping, base_model: str) -> None:
    _conv(sd, "base.conv1", p["conv1"])
    _bn(sd, "base.bn1", p["bn1"], s["bn1"])
    n_convs = 2 if base_model == "resnet34" else 3
    for stage, n_blocks in enumerate(_STAGE_SIZES[base_model]):
        for b in range(n_blocks):
            name = f"layer{stage + 1}_{b}"
            key = f"base.layer{stage + 1}.{b}"
            bp, bs = p[name], s[name]
            for c in range(1, n_convs + 1):
                _conv(sd, f"{key}.conv{c}", bp[f"conv{c}"])
                _bn(sd, f"{key}.bn{c}", bp[f"bn{c}"], bs[f"bn{c}"])
            if "downsample_conv" in bp:
                _conv(sd, f"{key}.downsample.0", bp["downsample_conv"])
                _bn(sd, f"{key}.downsample.1", bp["downsample_bn"],
                    bs["downsample_bn"])


def encoder_state_dict(params: Mapping, stats: Mapping,
                       base_model: str) -> StateDict:
    """FeatureExtractor state_dict from the encoder params/batch_stats."""
    sd: StateDict = {}
    base_p, base_s = params["base"], stats.get("base", {})
    if base_model in _STAGE_SIZES:
        _resnet(sd, base_p, base_s, base_model)
    elif base_model == "vgg16":
        for n, pos in enumerate(_VGG16_CONVS):
            _conv(sd, f"base.features.{pos}", base_p[f"conv{n}"])
    elif base_model == "tiny":
        for i in range(len(base_p)):
            _conv(sd, f"base.conv{i}", base_p[f"conv{i}"])
    else:
        raise ValueError(f"unknown base_model {base_model!r}")
    for i in range(5, 0, -1):  # module order: coarsest skip first
        _conv(sd, f"sk{i}", params[f"sk{i}"])
        _bn(sd, f"bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    return sd


def decoder_state_dict(params: Mapping) -> StateDict:
    """RSISDecoder state_dict from the decoder params."""
    sd: StateDict = {}
    i = 0
    while f"clstm{i}" in params:
        _conv(sd, f"clstm_list.{i}.Gates", params[f"clstm{i}"]["gates"])
        i += 1
    _conv(sd, "conv_out", params["conv_out"])
    _dense(sd, "fc_class", params["fc_class"])
    _dense(sd, "fc_stop", params["fc_stop"])
    return sd


def from_jax_variables(variables: Mapping, base_model: str
                       ) -> Tuple[StateDict, StateDict]:
    """(encoder_sd, decoder_sd) from a JAX variables pytree (numpy or
    array-like leaves)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {}).get("encoder", {})
    return (encoder_state_dict(params["encoder"], stats, base_model),
            decoder_state_dict(params["decoder"]))


def train_state_from_jax(cfg, variables: Mapping, device=None):
    """A fresh port ``TrainState`` (``train/step.py``) on ``device``
    (default cuda; raises without a card) holding the parameters and
    BatchNorm statistics of a JAX variables pytree, so both packages start
    a step from the same numbers. Optimizer moments start at zero."""
    from ..train.step import create_train_state
    return create_train_state(
        cfg, from_jax_variables(variables, cfg.base_model), device=device)
