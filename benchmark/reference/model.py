"""The RSIS model as plain functions over its state_dicts.

Written from the reference architecture (imatge-upc/rsis: a torchvision
ResNet whose five scales are projected by a 3x3 conv and a BatchNorm
each, then a cascade of five ConvLSTM cells with concat skips, a 3x3
mask head on the finest state upsampled twice, and class and stop heads
on the cells' spatial maxima), in the reference's state_dict key layout
(``base.layer3.7.conv2.weight``, ``clstm_list.2.Gates.weight``, ...).
Every convolution and linear layer takes its operands through a
``Precision`` (``precision.py``), and every stored activation passes its
``store``: both are the identity for the fp32 reference and round to the
format for a control.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from .precision import Precision

StateDict = Mapping[str, torch.Tensor]
STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
BN_EPS = 1e-5


def decoder_widths(hidden: int) -> tuple:
    return (hidden, hidden // 2, hidden // 4, hidden // 8, hidden // 16)


def conv(sd: StateDict, key: str, x, prec: Precision, stride: int = 1,
         padding: int = 0):
    w = sd[key + ".weight"]
    return prec.store(F.conv2d(prec.operand(x), prec.operand(w),
                               sd.get(key + ".bias"), stride, padding))


def linear(sd: StateDict, key: str, x, prec: Precision):
    return prec.store(F.linear(prec.operand(x),
                               prec.operand(sd[key + ".weight"]),
                               sd[key + ".bias"]))


def batch_norm(sd: StateDict, key: str, x, train: bool, prec: Precision):
    """Train mode: the batch's statistics (biased variance); eval: the
    running ones."""
    if train:
        return prec.store(F.batch_norm(x, None, None, sd[key + ".weight"],
                                       sd[key + ".bias"], True, 0.0, BN_EPS))
    return prec.store(F.batch_norm(x, sd[key + ".running_mean"],
                                   sd[key + ".running_var"],
                                   sd[key + ".weight"], sd[key + ".bias"],
                                   False, 0.0, BN_EPS))


def _bottleneck(sd, key, x, prec, stride, train, downsample):
    out = F.relu(batch_norm(sd, key + ".bn1",
                            conv(sd, key + ".conv1", x, prec), train, prec))
    out = F.relu(batch_norm(sd, key + ".bn2",
                            conv(sd, key + ".conv2", out, prec, stride, 1),
                            train, prec))
    out = batch_norm(sd, key + ".bn3", conv(sd, key + ".conv3", out, prec),
                     train, prec)
    if downsample:
        x = batch_norm(sd, key + ".downsample.1",
                       conv(sd, key + ".downsample.0", x, prec, stride),
                       train, prec)
    return prec.store(F.relu(out + x))


def backbone(sd: StateDict, x, prec: Precision, train: bool,
             base_model: str = "resnet101"):
    """The five taps (x5 .. x1) of a bottleneck ResNet, keys ``base.*``."""
    x = F.relu(batch_norm(sd, "base.bn1",
                          conv(sd, "base.conv1", prec.store(x), prec, 2, 3),
                          train, prec))
    taps = [x]
    x = F.max_pool2d(x, 3, 2, 1)
    for layer, blocks in enumerate(STAGES[base_model], start=1):
        for i in range(blocks):
            stride = 2 if layer > 1 and i == 0 else 1
            x = _bottleneck(sd, f"base.layer{layer}.{i}", x, prec, stride,
                            train, downsample=i == 0)
        taps.append(x)
    return taps[::-1]


def encoder(sd: StateDict, x, prec: Precision, train: bool,
            base_model: str = "resnet101"):
    """x (B, 3, H, W) normalised -> the skip pyramid (x5 .. x1)."""
    taps = backbone(sd, x, prec, train, base_model)
    return tuple(batch_norm(sd, f"bn{5 - i}",
                            conv(sd, f"sk{5 - i}", t, prec, padding=1),
                            train, prec)
                 for i, t in enumerate(taps))


def _up(x, size, prec: Precision):
    return prec.store(F.interpolate(x, size=size, mode="bilinear",
                                    align_corners=True))


def decoder_step(sd: StateDict, skips: Sequence[torch.Tensor], carry,
                 prec: Precision, hidden: int):
    """One decode step with concat skips and 3x3 cells.

    Returns (mask logits (B, 1, 2 H1, 2 W1), class probabilities (B, K),
    stop logits (B, 1)) and the new carry (a (h, c) pair a cell)."""
    widths = decoder_widths(hidden)
    x = skips[0]
    new_carry, side = [], []
    for i, width in enumerate(widths):
        if carry is None:
            zero = x.new_zeros((x.shape[0], width) + tuple(x.shape[2:]))
            h_prev, c_prev = zero, zero
        else:
            h_prev, c_prev = carry[i]
        gates = conv(sd, f"clstm_list.{i}.Gates",
                     torch.cat([x, h_prev], 1), prec, padding=1)
        in_g, forget_g, out_g, cell_g = gates.chunk(4, 1)
        c = prec.store(torch.sigmoid(forget_g) * c_prev
                       + torch.sigmoid(in_g) * torch.tanh(cell_g))
        h = prec.store(torch.sigmoid(out_g) * torch.tanh(c))
        new_carry.append((h, c))
        side.append(h.amax(dim=(2, 3)))
        if i + 1 < len(widths):
            nxt = skips[i + 1]
            x = torch.cat([_up(h, tuple(nxt.shape[-2:]), prec), nxt], 1)
        else:
            x = _up(h, (2 * h.shape[2], 2 * h.shape[3]), prec)
    mask = conv(sd, "conv_out", x, prec, padding=1)
    feats = torch.cat(side, 1)
    cls = prec.store(torch.softmax(linear(sd, "fc_class", feats, prec),
                                   dim=-1))
    stop = linear(sd, "fc_stop", feats, prec)
    return (mask, cls, stop), new_carry


def layout(base_model: str, hidden: int, num_classes: int):
    """The two state_dicts' leaves in the reference's order: (encoder,
    decoder) lists of (key, shape, kind), kind one of "fan_in" (a conv
    or linear weight), "zero" (a bias, a BatchNorm shift or running
    mean), "one" (a BatchNorm scale or running variance), "count" (a
    BatchNorm's batch counter)."""
    enc = []

    def conv_(key, cout, cin, k, bias=False):
        enc.append((key + ".weight", (cout, cin, k, k), "fan_in"))
        if bias:
            enc.append((key + ".bias", (cout,), "zero"))

    def bn_(key, c):
        enc.extend([(key + ".weight", (c,), "one"),
                    (key + ".bias", (c,), "zero"),
                    (key + ".running_mean", (c,), "zero"),
                    (key + ".running_var", (c,), "one"),
                    (key + ".num_batches_tracked", (), "count")])

    conv_("base.conv1", 64, 3, 7)
    bn_("base.bn1", 64)
    inplanes = 64
    for layer, blocks in enumerate(STAGES[base_model], start=1):
        planes = 64 * 2 ** (layer - 1)
        for i in range(blocks):
            key = f"base.layer{layer}.{i}"
            conv_(key + ".conv1", planes, inplanes, 1)
            bn_(key + ".bn1", planes)
            conv_(key + ".conv2", planes, planes, 3)
            bn_(key + ".bn2", planes)
            conv_(key + ".conv3", planes * 4, planes, 1)
            bn_(key + ".bn3", planes * 4)
            if i == 0:
                conv_(key + ".downsample.0", planes * 4, inplanes, 1)
                bn_(key + ".downsample.1", planes * 4)
            inplanes = planes * 4
    taps = (2048, 1024, 512, 256, 64)
    widths = (hidden, hidden, hidden // 2, hidden // 4, hidden // 8)
    for i, (cin, width) in enumerate(zip(taps, widths)):
        conv_(f"sk{5 - i}", width, cin, 3, bias=True)
        bn_(f"bn{5 - i}", width)
    dec = []
    cells = decoder_widths(hidden)
    for i, width in enumerate(cells):
        cin = widths[0] if i == 0 else cells[i - 1] + widths[i]
        dec += [(f"clstm_list.{i}.Gates.weight", (4 * width, cin + width,
                                                  3, 3), "fan_in"),
                (f"clstm_list.{i}.Gates.bias", (4 * width,), "zero")]
    dec += [("conv_out.weight", (1, cells[-1], 3, 3), "fan_in"),
            ("conv_out.bias", (1,), "zero"),
            ("fc_class.weight", (num_classes, sum(cells)), "fan_in"),
            ("fc_class.bias", (num_classes,), "zero"),
            ("fc_stop.weight", (1, sum(cells)), "fan_in"),
            ("fc_stop.bias", (1,), "zero")]
    return enc, dec
