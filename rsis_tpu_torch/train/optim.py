"""Per-group optimizers as plain functions on tensors.

Counterpart of ``rsis_tpu/train/optim.py``. The reference trains two
optimizers: one over the decoder plus the encoder's skip projections and
their BatchNorms, one over the backbone, each with its own algorithm, lr
and weight decay. Each is the optax chain

  add_decayed_weights(wd) -> scale_by_<algorithm> -> scale(-lr)

with the decay added to the gradient before the moments (coupled L2, as
torch's ``weight_decay``, not AdamW's decoupled decay), written out here:

  adam:    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
           u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
           (b1 0.9, b2 0.999, eps 1e-8)
  sgd:     t = g + momentum t;  u = t    (no trace when momentum == 0)
  rmsprop: nu = (1 - d) g^2 + d nu;  u = g / sqrt(nu + eps)
           (d 0.9, eps 1e-8 inside the root, nu starting at 0 -- not
           torch.optim.RMSprop's alpha 0.99 and eps outside the root)

and the parameter moves by -lr * u. States are dicts of tensors keyed like
the parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

Tensors = Dict[str, torch.Tensor]
ALGORITHMS = ("adam", "sgd", "rmsprop")
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_RMS_DECAY = 0.9


def split_params(params: Mapping[str, torch.Tensor]) -> Tuple[Tensors,
                                                              Tensors]:
    """Split parameters named ``encoder.*`` / ``decoder.*`` into the two
    reference groups: the backbone (``encoder.base.*``) and the rest (the
    decoder, and the encoder's ``sk{i}`` / ``bn{i}``)."""
    enc = {k: v for k, v in params.items() if k.startswith("encoder.base.")}
    dec = {k: v for k, v in params.items() if k not in enc}
    return enc, dec


def init_state(name: str, params: Mapping[str, torch.Tensor],
               momentum: float = 0.9) -> dict:
    """Zero moments of ``name`` for each parameter."""
    if name not in ALGORITHMS:
        raise ValueError(f"unknown optimizer {name!r}")

    def zeros():
        return {k: torch.zeros_like(p) for k, p in params.items()}

    if name == "adam":
        return {"count": 0, "mu": zeros(), "nu": zeros()}
    if name == "rmsprop":
        return {"nu": zeros()}
    return {"trace": zeros()} if momentum else {}


@torch.no_grad()
def apply_updates(name: str, lr: float, weight_decay: float,
                  momentum: float, params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: dict) -> dict:
    """One step: moves every parameter in place by its update and returns
    the new state (the old state's tensors are not modified). Each line is
    one multi-tensor (``torch._foreach_*``) call over the whole group, so a
    step costs a few launches instead of a few per parameter."""
    if name not in ALGORITHMS:
        raise ValueError(f"unknown optimizer {name!r}")
    keys = list(params)
    p = [params[k] for k in keys]
    g = [grads[k] for k in keys]
    if weight_decay:
        g = torch._foreach_add(g, p, alpha=weight_decay)
    new = dict(state)
    if name == "adam":
        count = state["count"] + 1
        mu = torch._foreach_mul([state["mu"][k] for k in keys], _B1)
        torch._foreach_add_(mu, g, alpha=1.0 - _B1)
        nu = torch._foreach_mul([state["nu"][k] for k in keys], _B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - _B2)
        denom = torch._foreach_div(nu, 1.0 - _B2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        u = torch._foreach_div(mu, 1.0 - _B1 ** count)
        torch._foreach_div_(u, denom)
        new.update(count=count, mu=dict(zip(keys, mu)),
                   nu=dict(zip(keys, nu)))
    elif name == "rmsprop":
        nu = torch._foreach_mul([state["nu"][k] for k in keys], _RMS_DECAY)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - _RMS_DECAY)
        u = torch._foreach_add(nu, _EPS)
        torch._foreach_rsqrt_(u)
        torch._foreach_mul_(u, g)
        new["nu"] = dict(zip(keys, nu))
    elif momentum:
        u = torch._foreach_add(g, [state["trace"][k] for k in keys],
                               alpha=momentum)
        new["trace"] = dict(zip(keys, u))
    else:
        u = g
    torch._foreach_add_(p, u, alpha=-lr)
    return new


def update_groups(cfg, params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], enc_opt: dict,
                  dec_opt: dict, update_encoder: float) -> Tuple[dict, dict]:
    """The train step's update: the decoder group always moves; the
    backbone group, and its optimizer state, only when update_encoder > 0
    (the reference's 0/1 gate). Returns the new (enc_opt, dec_opt)."""
    enc_p, dec_p = split_params(params)
    enc_g, dec_g = split_params(grads)
    dec_opt = apply_updates(cfg.optim, cfg.lr, cfg.weight_decay,
                            cfg.momentum, dec_p, dec_g, dec_opt)
    if float(update_encoder) > 0:
        enc_opt = apply_updates(cfg.optim_cnn, cfg.lr_cnn,
                                cfg.weight_decay_cnn, cfg.momentum, enc_p,
                                enc_g, enc_opt)
    return enc_opt, dec_opt
