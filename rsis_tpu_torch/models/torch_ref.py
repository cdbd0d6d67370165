"""Plain-torch replica of the reference RSIS architecture, for parity.

Counterpart of ``rsis_tpu/models/torch_ref.py``, the port's own copy: the
reference model's semantics and state_dict key layout (its encoder over
torchvision's ResNet / VGG-16, ConvLSTM cells, decoder) written directly
in ``torch.nn``, independent of the port's modules and kernels.
``cli/verify_parity.py`` runs it beside the port's forward on the same
weights and inputs. Its initial hidden states are made on the input's
device and in its dtype, so it runs on the card as well as the CPU.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class ResNetTaps(nn.Module):
    """torchvision-layout ResNet returning the 5 scales x5..x1."""

    def __init__(self, block, layers):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias=False),
                nn.BatchNorm2d(planes * block.expansion))
        mods = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            mods.append(block(self.inplanes, planes))
        return nn.Sequential(*mods)

    def forward(self, x):
        x = self.conv1(x)
        x = self.bn1(x)
        x1 = F.relu(x)
        x = self.maxpool(x1)
        x2 = self.layer1(x)
        x3 = self.layer2(x2)
        x4 = self.layer3(x3)
        x5 = self.layer4(x4)
        return x5, x4, x3, x2, x1


_VGG_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]


class VGG16Taps(nn.Module):
    def __init__(self):
        super().__init__()
        layers = []
        in_ch = 3
        for item in _VGG_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.Conv2d(in_ch, item, 3, padding=1))
                layers.append(nn.ReLU(inplace=True))
                in_ch = item
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        taps = []
        for mod in self.features:
            x = mod(x)
            if isinstance(mod, nn.MaxPool2d):
                taps.append(x)
        x1, x2, x3, x4, x5 = taps
        return x5, x4, x3, x2, x1


SKIP_DIMS = {
    "resnet": None,  # computed from blocks
    "vgg16": (512, 512, 256, 128, 64),
}


class FeatureExtractor(nn.Module):
    def __init__(self, base, skip_dims_in, hidden_size=128, kernel_size=3):
        super().__init__()
        self.base = base
        pad = 0 if kernel_size == 1 else 1
        h = hidden_size
        self.sk5 = nn.Conv2d(skip_dims_in[0], h, kernel_size, padding=pad)
        self.sk4 = nn.Conv2d(skip_dims_in[1], h, kernel_size, padding=pad)
        self.sk3 = nn.Conv2d(skip_dims_in[2], h // 2, kernel_size, padding=pad)
        self.sk2 = nn.Conv2d(skip_dims_in[3], h // 4, kernel_size, padding=pad)
        self.sk1 = nn.Conv2d(skip_dims_in[4], h // 8, kernel_size, padding=pad)
        self.bn5 = nn.BatchNorm2d(h)
        self.bn4 = nn.BatchNorm2d(h)
        self.bn3 = nn.BatchNorm2d(h // 2)
        self.bn2 = nn.BatchNorm2d(h // 4)
        self.bn1 = nn.BatchNorm2d(h // 8)

    def forward(self, x):
        x5, x4, x3, x2, x1 = self.base(x)
        return (self.bn5(self.sk5(x5)), self.bn4(self.sk4(x4)),
                self.bn3(self.sk3(x3)), self.bn2(self.sk2(x2)),
                self.bn1(self.sk1(x1)))


class ConvLSTMCell(nn.Module):
    def __init__(self, input_size, hidden_size, kernel_size, padding):
        super().__init__()
        self.hidden_size = hidden_size
        self.Gates = nn.Conv2d(input_size + hidden_size, 4 * hidden_size,
                               kernel_size, padding=padding)

    def forward(self, x, prev):
        if prev is None:
            shape = (x.size(0), self.hidden_size, x.size(2), x.size(3))
            prev = (x.new_zeros(shape), x.new_zeros(shape))
        h_prev, c_prev = prev
        gates = self.Gates(torch.cat((x, h_prev), 1))
        i, f, o, g = gates.chunk(4, 1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return [h, c]


class RSISDecoder(nn.Module):
    def __init__(self, hidden_size=128, num_classes=21, kernel_size=3,
                 skip_mode="concat"):
        super().__init__()
        pad = 0 if kernel_size == 1 else 1
        self.skip_mode = skip_mode
        h = hidden_size
        dims_out = [h, h // 2, h // 4, h // 8, h // 16]
        cells = []
        for i, d in enumerate(dims_out):
            in_dim = h if i == 0 else dims_out[i - 1] * (
                2 if skip_mode == "concat" else 1)
            cells.append(ConvLSTMCell(in_dim, d, kernel_size, pad))
        self.clstm_list = nn.ModuleList(cells)
        self.conv_out = nn.Conv2d(dims_out[-1], 1, kernel_size, padding=pad)
        fc_dim = sum(dims_out)
        self.fc_class = nn.Linear(fc_dim, num_classes)
        self.fc_stop = nn.Linear(fc_dim, 1)

    def forward(self, skip_feats, prev_hidden_list):
        clstm_in = skip_feats[0]
        rest = skip_feats[1:]
        side_feats = []
        hidden_list = []
        for i in range(len(rest) + 1):
            prev = None if prev_hidden_list is None else prev_hidden_list[i]
            state = self.clstm_list[i](clstm_in, prev)
            hidden_list.append(state)
            hidden = state[0]
            side_feats.append(
                F.max_pool2d(hidden, kernel_size=hidden.shape[2:]))
            if i < len(rest):
                skip_vec = rest[i]
                hidden = F.interpolate(hidden, size=skip_vec.shape[-2:],
                                       mode="bilinear", align_corners=True)
                if self.skip_mode == "concat":
                    clstm_in = torch.cat([hidden, skip_vec], 1)
                elif self.skip_mode == "sum":
                    clstm_in = hidden + skip_vec
                elif self.skip_mode == "mul":
                    clstm_in = hidden * skip_vec
                else:
                    clstm_in = hidden
            else:
                hidden = F.interpolate(
                    hidden, size=(hidden.size(-2) * 2, hidden.size(-1) * 2),
                    mode="bilinear", align_corners=True)
                clstm_in = hidden
        out_mask = self.conv_out(clstm_in)
        feats = torch.cat(side_feats, 1).squeeze(-1).squeeze(-1)
        class_probs = torch.softmax(self.fc_class(feats), dim=-1)
        stop_logits = self.fc_stop(feats)
        return out_mask, class_probs, stop_logits, hidden_list


def randomize_bn_stats(module, seed=0):
    """Give BatchNorm layers non-trivial running stats so eval-mode parity
    actually exercises them."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.BatchNorm2d,)):
            m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                             generator=g) * 0.1)
            m.running_var.copy_(
                torch.rand(m.running_var.shape, generator=g) + 0.5)
