"""The reference's inference forward: the encoder once in eval mode, T
decode steps, masks at the input size, the mask and stop sigmoids."""

from __future__ import annotations

import torch

from . import model
from .precision import Precision, exact_fp32


@torch.no_grad()
def forward(enc: model.StateDict, dec: model.StateDict, x_nhwc, T: int,
            hidden: int, prec: Precision, rows: int = 8,
            base_model: str = "resnet101"):
    """x_nhwc (B, H, W, 3) normalised -> (masks (B, T, H, W), class
    probabilities (B, T, K), stops (B, T, 1)), fp32 on x's device (in a
    control, the values its storage format holds), run ``rows`` images
    at a time with TF32 off."""
    outs = []
    with exact_fp32():
        for lo in range(0, x_nhwc.shape[0], rows):
            x = x_nhwc[lo:lo + rows].float().permute(0, 3, 1, 2)
            skips = model.encoder(enc, x.contiguous(), prec, False,
                                  base_model)
            carry, steps = None, []
            for _ in range(T):
                (mask, cls, stop), carry = model.decoder_step(
                    dec, skips, carry, prec, hidden)
                if tuple(mask.shape[-2:]) != tuple(x.shape[-2:]):
                    mask = torch.nn.functional.interpolate(
                        mask, size=x.shape[-2:], mode="bilinear",
                        align_corners=True)
                steps.append((prec.store(torch.sigmoid(mask[:, 0])), cls,
                              prec.store(torch.sigmoid(stop))))
            outs.append(tuple(torch.stack(t, 1) for t in zip(*steps)))
    return tuple(torch.cat(t) for t in zip(*outs))
