"""Backbone CNNs with five feature taps, NCHW.

Counterpart of ``rsis_tpu/models/backbones.py`` (``ResNetTaps``,
``BottleneckBlock``, ``BasicBlock``, ``VGG16Taps``, ``TinyTaps``). Every
trunk returns the five feature scales (x5, x4, x3, x2, x1), coarsest
first. Module and parameter names follow torchvision, so a torchvision or
reference ``base.*`` state_dict loads as it is and
``rsis_tpu/models/torch_import.py`` reads this package's state_dicts.
Under ``parallel.mesh.sharded_rows`` every convolution and max pool takes
a slab of an image whose rows are sharded over ranks (``Conv2d``,
``MaxPool2d``), so a trunk's own forward runs the streaming forward's
encoder (``evals/streaming.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import batch_stats_group, halo, row_group


_CHANNEL_SUM = (0, 2, 3)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class Conv2d(nn.Conv2d):
    """nn.Conv2d that, under ``parallel.mesh.sharded_rows``, convolves an
    H-sharded NCHW slab: the rows its windows read beyond the slab
    (padding above, k - stride - padding below) come from the
    neighbouring ranks, zeros at the image's edges, and H is not padded.
    The slab's first row must be a multiple of the stride."""

    def forward(self, x):
        group = row_group()
        if group is None:
            return super().forward(x)
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        out = F.conv2d(halo(x, group, p, max(k - s - p, 0), dim=2),
                       self.weight, self.bias, s, (0, self.padding[1]),
                       self.dilation, self.groups)
        assert out.shape[2] * s == x.shape[2], (out.shape, x.shape, k, s, p)
        return out


class MaxPool2d(nn.MaxPool2d):
    """nn.MaxPool2d that, under ``parallel.mesh.sharded_rows``, pools an
    H-sharded slab with its neighbours' rows, -inf at the image's edges."""

    def forward(self, x):
        group = row_group()
        if group is None:
            return super().forward(x)
        k, s, p = self.kernel_size, self.stride, self.padding
        xe = halo(x, group, p, max(k - s - p, 0), dim=2, fill=float("-inf"))
        return F.max_pool2d(xe, k, s, (0, p))


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation over the global batch of a
    data-parallel group, each rank holding its rows (NCHW).

    Forward: the per-channel sums of x and x^2 (accumulated in float64)
    are summed over the ranks, giving the mean and the biased variance
    (flax's E[x^2] - E[x]^2); out = x alpha + beta with alpha = invstd
    weight and beta = bias - mean alpha, in fp32 (float64 for float64
    x), cast to x's dtype.
    Backward: the per-channel sums of dy and of dy (x - mean) (float64)
    are summed over the ranks and dx = (dy - sum(dy) / n - (x - mean) k)
    invstd weight with k = sum(dy (x - mean)) invstd^2 / n; the weight's
    and bias's cotangents are this rank's sums (the step sums every
    gradient over the ranks). The arithmetic is ATen's CPU batch norm's,
    with float64 sums, so one rank reproduces ``F.batch_norm`` on the CPU
    closely and the ranks' partial sums add no rounding of their own: a
    ResNet's BatchNorm backward cancels to a few bits at small batches,
    and rounding there is amplified into the weights below it.
    apply(x, weight, bias, group, eps) -> (out, mean, var), mean and var
    float64 (for the running statistics, no gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, eps):
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        sums = torch.stack([xf.sum(_CHANNEL_SUM, dtype=torch.float64),
                            (xf * xf).sum(_CHANNEL_SUM,
                                          dtype=torch.float64)])
        group.all_reduce_(sums)
        n = x.numel() // x.shape[1] * group.size
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        invstd = (1.0 / torch.sqrt(var + eps)).to(acc)
        mean_a = mean.to(acc)
        alpha = invstd * weight.to(acc)
        beta = bias.to(acc) - mean_a * alpha
        out = xf * _per_channel(alpha) + _per_channel(beta)
        ctx.save_for_backward(x, weight, mean_a, invstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean_a, invstd = ctx.saved_tensors
        acc = mean_a.dtype
        centred = x.to(acc) - _per_channel(mean_a)
        dyf = dy.to(acc)
        local = torch.stack([dyf.sum(_CHANNEL_SUM, dtype=torch.float64),
                             (dyf * centred).sum(_CHANNEL_SUM,
                                                 dtype=torch.float64)])
        total = ctx.group.all_reduce_(local.clone())
        k = total[1].to(acc) * invstd * invstd / ctx.n
        grad_mean = (total[0] / ctx.n).to(acc)
        dx = ((dyf - _per_channel(grad_mean) - centred * _per_channel(k))
              * _per_channel(invstd) * _per_channel(weight.to(acc)))
        return (dx.to(dy.dtype), (local[1].to(acc) * invstd).to(weight.dtype),
                local[0].to(weight.dtype), None, None)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose running statistics follow flax.linen.BatchNorm
    in train mode: torch moves running_var toward the unbiased batch
    variance (n / (n - 1) times the biased one), flax toward the biased
    one. torch's momentum 0.1 is flax's 0.9.

    Under ``parallel.mesh.global_batch_stats`` (which the train step sets
    with more than one rank) train mode normalises with the statistics of
    the global batch, as flax does on a sharded batch
    (``GlobalBatchNorm``), and every rank moves the same running
    statistics. Otherwise ``F.batch_norm``."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        group = batch_stats_group()
        if group is not None:
            out, mean, var = GlobalBatchNorm.apply(x, self.weight,
                                                   self.bias, group,
                                                   self.eps)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1.0 - m) * self.running_mean
                                        + m * mean.float())
                self.running_var.copy_((1.0 - m) * self.running_var
                                       + m * var.float())
            return out
        kept = (1.0 - self.momentum) * self.running_var
        # batch_norm updates (and autograd keeps) this copy, so the buffer
        # can be rewritten below without touching a saved tensor
        var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                           True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        # torch added momentum * var * n / (n - 1): keep (n - 1) / n of it
        torch.lerp(kept, var.detach(), (n - 1) / n, out=self.running_var)
        return out


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5)


class Bottleneck(nn.Module):
    """torchvision bottleneck: 1x1 -> 3x3(stride) -> 1x1 (x4)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            _bn(planes * 4)) if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class BasicBlock(nn.Module):
    """torchvision basic block: 3x3(stride) -> 3x3."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes, 1, stride=stride, bias=False),
            _bn(planes)) if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class ResNetTaps(nn.Module):
    """ResNet trunk returning (x5, x4, x3, x2, x1), coarsest first."""

    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool = True):
        super().__init__()
        block = Bottleneck if bottleneck else BasicBlock
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = MaxPool2d(3, stride=2, padding=1)
        inplanes, planes = 64, 64
        for stage, n_blocks in enumerate(stage_sizes):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                first = b == 0
                need_ds = first and (stride != 1
                                     or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes,
                                    stride=stride if first else 1,
                                    downsample=need_ds))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x):
        x1 = self.relu(self.bn1(self.conv1(x)))
        x2 = self.layer1(self.maxpool(x1))
        x3 = self.layer2(x2)
        x4 = self.layer3(x3)
        x5 = self.layer4(x4)
        return x5, x4, x3, x2, x1


def resnet34():
    return ResNetTaps((3, 4, 6, 3), bottleneck=False)


def resnet50():
    return ResNetTaps((3, 4, 6, 3), bottleneck=True)


def resnet101():
    return ResNetTaps((3, 4, 23, 3), bottleneck=True)


class TinyTaps(nn.Module):
    """Minimal five-scale trunk for tests (not part of the reference
    surface): five stride-2 3x3 convs with bias, x1 /2 ... x5 /32."""
    widths = (16, 24, 32, 48, 64)

    def __init__(self):
        super().__init__()
        cin = 3
        for i, wd in enumerate(self.widths):
            setattr(self, f"conv{i}", Conv2d(cin, wd, 3, stride=2,
                                                padding=1))
            cin = wd

    def forward(self, x):
        taps = []
        for i in range(len(self.widths)):
            x = torch.relu(getattr(self, f"conv{i}")(x))
            taps.append(x)
        x1, x2, x3, x4, x5 = taps
        return x5, x4, x3, x2, x1


def tiny():
    return TinyTaps()


_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M")


class VGG16Taps(nn.Module):
    """VGG-16 ``features`` trunk (torchvision indices); taps after each
    max-pool (x1..x5)."""

    def __init__(self):
        super().__init__()
        layers = []
        cin = 3
        for item in _VGG16_PLAN:
            if item == "M":
                layers.append(MaxPool2d(2, stride=2))
            else:
                layers += [Conv2d(cin, item, 3, padding=1),
                           nn.ReLU(inplace=True)]
                cin = item
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        taps = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.MaxPool2d):
                taps.append(x)
        x1, x2, x3, x4, x5 = taps
        return x5, x4, x3, x2, x1


def vgg16():
    return VGG16Taps()


# channel widths of (x5..x1) per backbone
SKIP_DIMS = {
    "tiny": (64, 48, 32, 24, 16),
    "resnet50": (2048, 1024, 512, 256, 64),
    "resnet101": (2048, 1024, 512, 256, 64),
    "resnet34": (512, 256, 128, 64, 64),
    "vgg16": (512, 512, 256, 128, 64),
}

BACKBONES = {
    "tiny": tiny,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "vgg16": vgg16,
}
