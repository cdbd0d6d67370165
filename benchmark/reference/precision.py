"""Operand precision of the reference's convolutions and linear layers.

``fp32`` leaves every operand as it is (the reference proper, run with
TF32 off). The lower precisions are the controls: every operand of a
convolution or a linear layer (input and weight) is rounded to the
format before an fp32 product, as a tensor core takes it, and in a
backward pass the gradient that reaches the operand is rounded too. A
storage format (``bf16``, ``fp8``) also rounds every activation the
model stores (each layer's output, the residual sums, the cells' states,
the upsampled maps), as a program computing in that format keeps them;
TF32 is a mode of the products alone and stores fp32:

- ``tf32``: 10 mantissa bits (round half away from zero on the bits);
- ``bf16``: bfloat16, round to nearest even;
- ``fp8``: float8 e4m3 for values and e5m2 for gradients, each tensor
  scaled so its largest magnitude meets the format's largest finite value.
"""

from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32", "bf16", "fp8")
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _scaled(x: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / top
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    return _scaled(x, torch.float8_e4m3fn, _E4M3_MAX)


def round_e5m2(x: torch.Tensor) -> torch.Tensor:
    return _scaled(x, torch.float8_e5m2, _E5M2_MAX)


_ROUNDS = {"tf32": (round_tf32, round_tf32),
           "bf16": (round_bf16, round_bf16),
           "fp8": (round_e4m3, round_e5m2)}


class _Round(torch.autograd.Function):
    """Rounds the value forward and the gradient backward."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return _ROUNDS[name][0](x)

    @staticmethod
    def backward(ctx, grad):
        return _ROUNDS[ctx.name][1](grad), None


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in PRECISIONS:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        return _Round.apply(x, self.name)

    def store(self, x: torch.Tensor) -> torch.Tensor:
        if self.name in ("fp32", "tf32"):
            return x
        return _Round.apply(x, self.name)


class exact_fp32:
    """Context: fp32 products without TF32 (cuDNN and cuBLAS), the flags
    restored on exit."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False
