"""Model assembly, the fresh initialisation, the plain decode loop and the
inference forward.

Counterpart of ``rsis_tpu/models/rsis.py`` (``compute_dtype``,
``build_models``, ``init_variables`` as ``init_weights``,
``decode_sequence``, ``forward``). The encoder runs once;
the decoder runs exactly T steps (no early stop) in a Python loop; masks
are upsampled to the input size and the mask and stop sigmoids applied.
Skip modes concat/sum/none with 3x3 convolutions decode through the
kernels (``models/rowmajor_decoder.py``); ``mul`` is not
channel-separable and, like other kernel sizes, takes the plain decode,
whose 3x3 cells run the ConvLSTM step kernel K8 and whose 3x3 head runs
the mask head kernel K2 in inference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..config import Config
from ..ops.upsample import upsample_bilinear_align_corners
from ..utils.profiling import span
from .decoder import RSISDecoder
from .encoder import FeatureExtractor
from .rowmajor_decoder import CHANNEL_SEPARABLE, decode_sequence_rowmajor


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def build_models(cfg: Config) -> Tuple[FeatureExtractor, RSISDecoder]:
    """Fresh (encoder, decoder) modules in eval mode, fp32 parameters on
    the CPU, with PyTorch's module initialisation from the global torch
    seed (a template that weights are loaded into; ``init_weights`` draws
    a fresh model)."""
    encoder = FeatureExtractor(base_model=cfg.base_model,
                               hidden_size=cfg.hidden_size,
                               kernel_size=cfg.kernel_size)
    decoder = RSISDecoder(hidden_size=cfg.hidden_size,
                          num_classes=cfg.num_classes,
                          kernel_size=cfg.kernel_size,
                          skip_mode=cfg.skip_mode, dropout=cfg.dropout,
                          dropout_cls=cfg.dropout_cls,
                          dropout_stop=cfg.dropout_stop)
    return encoder.eval(), decoder.eval()


# the std of a standard normal truncated to [-2, 2]: flax's truncated
# variance scaling divides by it so the drawn weights keep the variance
TRUNCATED_NORMAL_STD = 0.87962566103423978


def init_weights(cfg: Config, generator: torch.Generator
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(encoder, decoder) state_dicts of a fresh model, fp32 on the CPU,
    drawn as the JAX package's ``init_variables`` draws one (flax's
    defaults): every conv and linear weight from ``lecun_normal``, a
    normal truncated to two standard deviations whose variance is
    1 / fan_in (fan_in: in_channels x kh x kw, or in_features); every
    bias 0; BatchNorm weight 1, bias 0, running mean 0, running var 1.

    The draws come from ``generator`` (a CPU generator, which the caller
    seeds), module by module in registration order; the global torch
    generator is neither read nor advanced."""
    with torch.device("meta"):
        models = build_models(cfg)
    out = []
    for model in models:
        model.to_empty(device="cpu")
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) \
                    / TRUNCATED_NORMAL_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif (list(m.parameters(recurse=False))
                  or list(m.buffers(recurse=False))):
                raise TypeError(f"init_weights: no rule for {name} "
                                f"({type(m).__name__})")
        out.append(model.state_dict())
    return out[0], out[1]


def decode_sequence(decoder: RSISDecoder, skips, T: int, carry=None,
                    plain: bool = False):
    """Unroll the plain decoder T steps; plain=True sends its cells to
    K8's plain version.

    Returns (masks (B, T, 2H, 2W) logits, class_probs (B, T, K),
    stop_logits (B, T, 1), final_carry)."""
    masks, clss, stops = [], [], []
    with span("rsis.decode"):
        for _ in range(T):
            (mask, cls, stop), carry = decoder(skips, carry, plain=plain)
            masks.append(mask[:, 0])
            clss.append(cls)
            stops.append(stop)
        return (torch.stack(masks, dim=1), torch.stack(clss, dim=1),
                torch.stack(stops, dim=1), carry)


@torch.inference_mode()
def forward(cfg: Config, encoder: FeatureExtractor, decoder: RSISDecoder,
            x: torch.Tensor, T: int | None = None, plain: bool = False):
    """Inference forward on an NCHW image batch.

    The encoder runs in the dtype of its parameters on x cast to it; the
    decoder computes in ``compute_dtype(cfg)``. plain=True replaces the
    kernels (K1 and K2, or K8 and K2 in the plain decode) by their plain
    versions (the oracle they are held against on the card). Returns (sigmoid
    masks (B, T, H, W), class_probs (B, T, K), sigmoid stops (B, T, 1))."""
    T = T if T is not None else cfg.maxseqlen
    dtype = compute_dtype(cfg)
    enc_dtype = next(encoder.parameters()).dtype
    with span("rsis.encoder"):
        skips = tuple(s.to(dtype) for s in encoder(x.to(enc_dtype)))
    # the kernels pack 3x3 gate convolutions
    if cfg.skip_mode in CHANNEL_SEPARABLE and cfg.kernel_size == 3:
        masks, clss, stops = decode_sequence_rowmajor(
            decoder, skips, T, cfg.skip_mode, dtype=dtype, plain=plain)
    else:
        masks, clss, stops, _ = decode_sequence(decoder, skips, T,
                                                plain=plain)
    h, w = x.shape[2], x.shape[3]
    with span("rsis.output"):
        if tuple(masks.shape[-2:]) != (h, w):
            masks = upsample_bilinear_align_corners(masks, h, w)
        return torch.sigmoid(masks), clss, torch.sigmoid(stops)
