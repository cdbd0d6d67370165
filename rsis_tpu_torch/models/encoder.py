"""Feature extractor: backbone taps projected into the skip pyramid.

Counterpart of ``rsis_tpu/models/encoder.py::FeatureExtractor``: the five
backbone scales go through a conv + BatchNorm each (``sk{i}``/``bn{i}``,
i = 5 for the coarsest) into widths (h, h, h/2, h/4, h/8). NCHW.
"""

from __future__ import annotations

from torch import nn

from .backbones import BACKBONES, SKIP_DIMS, BatchNorm2d, Conv2d


class FeatureExtractor(nn.Module):
    def __init__(self, base_model: str = "resnet101", hidden_size: int = 128,
                 kernel_size: int = 3):
        super().__init__()
        self.base_model = base_model
        self.base = BACKBONES[base_model]()
        h = hidden_size
        widths = (h, h, h // 2, h // 4, h // 8)
        pad = (kernel_size - 1) // 2
        for i, (cin, width) in enumerate(zip(SKIP_DIMS[base_model], widths)):
            setattr(self, f"sk{5 - i}", Conv2d(cin, width, kernel_size,
                                                  padding=pad))
            setattr(self, f"bn{5 - i}", BatchNorm2d(width, eps=1e-5))

    def forward(self, x):
        """x: (B, 3, H, W) normalised image -> 5 skip features (x5..x1)."""
        taps = self.base(x)
        return tuple(getattr(self, f"bn{5 - i}")(getattr(self, f"sk{5 - i}")(t))
                     for i, t in enumerate(taps))
