"""Batch inference forward for evaluation.

Counterpart of ``rsis_tpu/evals/forward.py::make_forward``: encoder once,
decoder exactly T steps (no early stop), masks upsampled to the input size,
sigmoids applied. There is no jit; the returned function runs eagerly on
its device. ``HostForward`` is the form the evaluator, the exporters and
the prediction CLI call.
"""

from __future__ import annotations

import time
from typing import Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..device import resolve_device
from ..models.rsis import build_models, compute_dtype, forward
from ..utils.profiling import span

Weights = Union[Mapping[str, torch.Tensor], nn.Module]


def _weights_key(w: Weights):
    """The tensors of a state_dict or module and their version counters.
    The same tensors at the same versions hold the same values, so the
    weights need not be copied again."""
    if isinstance(w, nn.Module):
        tensors = [*w.parameters(), *w.buffers()]
    else:
        tensors = list(w.values())
    return tensors, [t._version for t in tensors]


def _same_key(old, new) -> bool:
    return (old is not None and len(old[0]) == len(new[0])
            and all(a is b for a, b in zip(old[0], new[0]))
            and old[1] == new[1])


def make_forward(cfg: Config, T: int | None = None, device=None):
    """Returns fn((encoder, decoder), x_nhwc) -> (masks (B, T, H, W),
    class_probs (B, T, K), stops (B, T, 1)).

    encoder and decoder are each a state_dict in the reference key layout
    (``models/weights.py``) or a module whose state_dict is copied. The
    function keeps its own modules on ``device`` (default ``cuda``; there
    is no fallback to the CPU): the encoder in the compute dtype, the
    decoder in fp32 with its parameters cast at use. It copies the
    weights in only when they differ from the last call's (other tensors,
    or the same tensors changed in place), so a caller running it batch
    after batch with one set of weights copies them once. x_nhwc is a
    float (B, H, W, 3) normalised image batch, on any device."""
    T = T or cfg.maxseqlen
    device = resolve_device(device, "make_forward")
    encoder, decoder = build_models(cfg)
    encoder = encoder.to(device=device, dtype=compute_dtype(cfg))
    decoder = decoder.to(device=device)
    loaded = [None, None]

    def fn(weights: Tuple[Weights, Weights], x_nhwc: torch.Tensor):
        with span("rsis.forward"):
            for i, (module, w) in enumerate(zip((encoder, decoder),
                                                weights)):
                key = _weights_key(w)
                if not _same_key(loaded[i], key):
                    module.load_state_dict(
                        w.state_dict() if isinstance(w, nn.Module) else w)
                    loaded[i] = key
            x = torch.as_tensor(x_nhwc).to(device).permute(0, 3, 1, 2)
            return forward(cfg, encoder, decoder, x.contiguous(), T=T)

    return fn


class HostForward:
    """``make_forward`` for the host-side evaluation code
    (``evals/evaluator.py``, ``evals/exporters.py``,
    ``cli/predict.py``): takes a numpy image
    batch, returns (masks, class_probs, stops) as float32 numpy arrays
    (the copy waits for the device), and counts the images it ran
    (``images``) and the host seconds spent in it (``seconds``): the
    forward's share of an evaluation's wall time."""

    def __init__(self, cfg: Config, T: int | None = None, device=None):
        self.fn = make_forward(cfg, T, device)
        self.images = 0
        self.seconds = 0.0

    def __call__(self, weights, x_nhwc: np.ndarray):
        t0 = time.perf_counter()
        out = tuple(t.float().cpu().numpy()
                    for t in self.fn(weights, x_nhwc))
        self.seconds += time.perf_counter() - t0
        self.images += len(x_nhwc)
        return out
