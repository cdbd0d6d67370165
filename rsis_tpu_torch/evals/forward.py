"""Batch inference forward for evaluation.

Counterpart of ``rsis_tpu/evals/forward.py::make_forward``: encoder once,
decoder exactly T steps (no early stop), masks upsampled to the input size,
sigmoids applied. There is no jit; the returned function runs eagerly on
its device.
"""

from __future__ import annotations

from typing import Mapping, Tuple, Union

import torch
from torch import nn

from ..config import Config
from ..device import resolve_device
from ..models.rsis import build_models, compute_dtype, forward

Weights = Union[Mapping[str, torch.Tensor], nn.Module]


def make_forward(cfg: Config, T: int | None = None, device=None):
    """Returns fn((encoder, decoder), x_nhwc) -> (masks (B, T, H, W),
    class_probs (B, T, K), stops (B, T, 1)).

    encoder and decoder are each a state_dict in the reference key layout
    (``models/weights.py``) or a module whose state_dict is copied. The
    function keeps its own modules on ``device`` (default ``cuda``; there
    is no fallback to the CPU): the encoder in the compute dtype, the
    decoder in fp32 with its parameters cast at use. x_nhwc is a float
    (B, H, W, 3) normalised image batch, on any device."""
    T = T or cfg.maxseqlen
    device = resolve_device(device, "make_forward")
    encoder, decoder = build_models(cfg)
    encoder = encoder.to(device=device, dtype=compute_dtype(cfg))
    decoder = decoder.to(device=device)

    def fn(weights: Tuple[Weights, Weights], x_nhwc: torch.Tensor):
        enc_w, dec_w = weights
        for module, w in ((encoder, enc_w), (decoder, dec_w)):
            module.load_state_dict(
                w.state_dict() if isinstance(w, nn.Module) else w)
        x = torch.as_tensor(x_nhwc).to(device).permute(0, 3, 1, 2)
        return forward(cfg, encoder, decoder, x.contiguous(), T=T)

    return fn
