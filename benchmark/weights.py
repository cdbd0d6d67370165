"""Fresh weights drawn on the device from the run's seed.

The port's draw rule (flax's defaults, as the JAX package initialises a
model): every conv and linear weight from a normal truncated to two
standard deviations whose variance is 1 / fan_in, every bias 0,
BatchNorm scale 1, shift 0, running mean 0, running variance 1. All
weights come from one uniform draw of a ``torch.Generator`` on the
device, mapped through the normal's inverse distribution function, in
fp32 (the type the train state keeps; the forward casts its encoder).
"""

from __future__ import annotations

import math

import torch

from .reference.model import layout

# the standard deviation of a standard normal truncated to [-2, 2]
TRUNCATED_NORMAL_STD = 0.87962566103423978


def draw(base_model: str, hidden: int, num_classes: int, seed: int,
         device) -> tuple:
    """(encoder, decoder) state_dicts in the reference key layout, on
    ``device``."""
    enc_layout, dec_layout = layout(base_model, hidden, num_classes)
    leaves = enc_layout + dec_layout
    fan = [(key, shape) for key, shape, kind in leaves if kind == "fan_in"]
    sizes = [math.prod(shape) for _, shape in fan]
    stds = torch.tensor([math.sqrt(1.0 / math.prod(shape[1:]))
                         / TRUNCATED_NORMAL_STD for _, shape in fan],
                        device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device,
                   dtype=torch.float64)
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))          # Phi(-2)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo))
                                      - 1.0)
    values = (z.clamp_(-2.0, 2.0).float()
              * torch.repeat_interleave(stds, torch.tensor(sizes,
                                                           device=device)))
    drawn = dict(zip((key for key, _ in fan),
                     (v.view(shape) for v, (_, shape) in
                      zip(values.split(sizes), fan))))
    out = []
    for part in (enc_layout, dec_layout):
        sd = {}
        for key, shape, kind in part:
            if kind == "fan_in":
                sd[key] = drawn[key]
            elif kind == "count":
                sd[key] = torch.zeros((), dtype=torch.long, device=device)
            else:
                fill = 1.0 if kind == "one" else 0.0
                sd[key] = torch.full(shape, fill, device=device)
        out.append(sd)
    return out[0], out[1]
