"""Model operations of a forward and of a train step.

Convolutions and linear layers only, at 2 operations a multiply-add;
interpolation, elementwise work and the matcher's cost contraction are
not counted. The reference model runs on the meta device under
``torch.utils.flop_counter.FlopCounterMode`` at the cell's shapes. The
skip features do not change from step to step, so the skip part of each
cell's gate convolution (and of its backward) is counted once a forward,
not once a step: the reference recomputes it every step, the model needs
it once. A train step counts the forward and the backward that its update needs:
with a frozen backbone neither the backbone's weight gradients nor any
input gradient below the skip projections; no gradient of the image; no
rematerialisation. So work a step does not need is not counted, and
skipping it raises the rate without moving the count.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model
from ..reference.precision import Precision

_LAYER_OPS = ("convolution", "convolution_backward", "addmm", "mm")


def _meta_state(base_model, hidden, num_classes, train_backbone, train):
    enc, dec = model.layout(base_model, hidden, num_classes)
    out = []
    for part, grad in ((enc, None), (dec, True)):
        sd = {}
        for key, shape, kind in part:
            t = torch.empty(shape, device="meta",
                            dtype=torch.long if kind == "count"
                            else torch.float32)
            learn = (train and t.is_floating_point()
                     and (key.endswith(".weight") or key.endswith(".bias"))
                     and "running" not in key
                     and (grad or train_backbone
                          or not key.startswith("base.")))
            sd[key] = t.requires_grad_(learn)
        out.append(sd)
    return out


@functools.lru_cache(maxsize=None)
def model_flops(base_model: str, hidden: int, num_classes: int, batch: int,
                height: int, width: int, steps: int, train: bool = False,
                train_backbone: bool = True) -> float:
    """Operations of one forward (train False: the encoder once and
    ``steps`` decode steps) or train step over a (batch, 3, height,
    width) input."""
    enc, dec = _meta_state(base_model, hidden, num_classes, train_backbone,
                           train)
    prec = Precision("fp32")
    counter = FlopCounterMode(display=False)
    with counter, torch.set_grad_enabled(train):
        x = torch.empty((batch, 3, height, width), device="meta")
        skips = model.encoder(enc, x, prec, train, base_model)
        carry, total = None, 0
        for _ in range(steps):
            (mask, cls, stop), carry = model.decoder_step(dec, skips, carry,
                                                          prec, hidden)
            total = total + mask.sum() + cls.sum() + stop.sum()
        if train:
            total.backward()
    counts = counter.get_flop_counts().get("Global", {})
    layers = sum(n for op, n in counts.items()
                 if str(op).split(".")[1] in _LAYER_OPS)
    repeated = (max(steps - 1, 0) * (3 if train else 1)
                * skip_part_flops(batch, height, width, hidden))
    return float(layers - repeated)


def skip_part_flops(batch: int, height: int, width: int,
                    hidden: int) -> float:
    """Operations of the skip part of the five cells' gate convolutions in
    one step (3x3, 4C outputs over the skip feature's channels)."""
    skips = (hidden, hidden, hidden // 2, hidden // 4, hidden // 8)
    return sum(2.0 * 4 * c * 9 * s * batch * h * w
               for (h, w, c, _), s in zip(
                   cell_geometries(height, width, hidden), skips))


def cell_geometries(height: int, width: int, hidden: int):
    """(H, W, C, Cx) of the decode's five cells over a (height, width)
    input: the cell's state, C channels, and Cx channels of the coarser
    cell's upsampled state (the skip part of the gates is hoisted)."""
    widths = model.decoder_widths(hidden)
    return [(height // 2 ** (5 - i), width // 2 ** (5 - i), c,
             widths[i - 1] if i else 0) for i, c in enumerate(widths)]
