"""The operation and byte counters against hand counts at tiny shapes,
and against the bounds the port's kernel table holds."""

import pytest

from benchmark.counts import flops, kernels, peaks


def conv(cout, cin, k, h, w, b=1):
    return 2.0 * cout * cin * k * k * h * w * b


def backbone_and_skips(h, w, hidden):
    """resnet50 by hand: stem, bottlenecks (stride on the 3x3), the five
    3x3 skip projections."""
    total = conv(64, 3, 7, h // 2, w // 2)
    inplanes, size = 64, (h // 4, w // 4)
    for layer, blocks in enumerate((3, 4, 6, 3), start=1):
        planes = 64 * 2 ** (layer - 1)
        for i in range(blocks):
            stride = 2 if layer > 1 and i == 0 else 1
            oh, ow = size[0] // stride, size[1] // stride
            total += conv(planes, inplanes, 1, *size)
            total += conv(planes, planes, 3, oh, ow)
            total += conv(planes * 4, planes, 1, oh, ow)
            if i == 0:
                total += conv(planes * 4, inplanes, 1, oh, ow)
            inplanes, size = planes * 4, (oh, ow)
    taps = ((2048, hidden, 32), (1024, hidden, 16), (512, hidden // 2, 8),
            (256, hidden // 4, 4), (64, hidden // 8, 2))
    for cin, cout, scale in taps:
        total += conv(cout, cin, 3, h // scale, w // scale)
    return total


def decode_step(h, w, hidden, classes, skip_once=False):
    """One decode step by hand: five 3x3 gate convs over [input, state],
    the 3x3 head at the input size, the two linear heads."""
    widths = [hidden // 2 ** i for i in range(5)]
    skips = [hidden, hidden, hidden // 2, hidden // 4, hidden // 8]
    total = 0.0
    for i, c in enumerate(widths):
        hh, ww = h // 2 ** (5 - i), w // 2 ** (5 - i)
        up = widths[i - 1] if i else 0
        skip = 0 if skip_once else skips[i]
        total += conv(4 * c, up + skip + c, 3, hh, ww)
    total += conv(1, widths[-1], 3, h, w)
    total += 2.0 * sum(widths) * (classes + 1)
    return total


def skip_parts(h, w, hidden):
    widths = [hidden // 2 ** i for i in range(5)]
    skips = [hidden, hidden, hidden // 2, hidden // 4, hidden // 8]
    return sum(conv(4 * c, s, 3, h // 2 ** (5 - i), w // 2 ** (5 - i))
               for i, (c, s) in enumerate(zip(widths, skips)))


@pytest.mark.parametrize("steps", [1, 3])
def test_forward_flops_by_hand(steps):
    h, w, hidden, classes = 64, 128, 16, 5
    got = flops.model_flops("resnet50", hidden, classes, 1, h, w, steps)
    want = (backbone_and_skips(h, w, hidden) + skip_parts(h, w, hidden)
            + steps * decode_step(h, w, hidden, classes, skip_once=True))
    assert got == pytest.approx(want, rel=1e-12)


def test_forward_flops_scale_with_batch():
    one = flops.model_flops("resnet50", 16, 5, 1, 64, 64, 2)
    assert flops.model_flops("resnet50", 16, 5, 3, 64, 64, 2) == \
        pytest.approx(3 * one)


def test_train_flops_by_hand():
    """Forward plus weight and input gradients of every layer, but no
    input gradient of the stem (the image needs none); a frozen backbone
    adds only the decoder's and skip projections' weight gradients and
    the decoder's input gradients."""
    h, w, hidden, classes, steps = 64, 64, 16, 5, 2
    fwd = flops.model_flops("resnet50", hidden, classes, 1, h, w, steps)
    full = flops.model_flops("resnet50", hidden, classes, 1, h, w, steps,
                             train=True)
    stem = conv(64, 3, 7, h // 2, w // 2)
    assert full == pytest.approx(3 * fwd - stem, rel=1e-12)
    frozen = flops.model_flops("resnet50", hidden, classes, 1, h, w, steps,
                               train=True, train_backbone=False)
    skips = backbone_and_skips(h, w, hidden) - backbone_and_skips(h, w, 0)
    decoder = fwd - backbone_and_skips(h, w, hidden)
    # skip projections: weight gradients only; every decoder layer's
    # input depends on trained weights, so it takes both gradients
    assert frozen == pytest.approx(fwd + skips + 2 * decoder, rel=1e-12)


def test_cell_geometries():
    assert flops.cell_geometries(512, 1024, 128) == [
        (16, 32, 128, 0), (32, 64, 64, 128), (64, 128, 32, 64),
        (128, 256, 16, 32), (256, 512, 8, 16)]


def test_k1_k4_bytes_by_hand():
    b, h, w, c, cx = 2, 3, 5, 4, 6
    state = b * h * c * w
    k1 = 2 * (state * 2 + b * (h + 2) * cx * (w + 2) + 4 * state
              + 4 * c * 9 * (cx + c) + 2 * state)
    assert kernels.k1_bytes(b, h, w, c, cx, 2) == k1
    k4 = k1 - 2 * 2 * state + 2 * (2 * state + 4 * state + state)
    assert kernels.k4_bytes(b, h, w, c, cx, 2) == k4
    assert kernels.gate_ops(b, h, w, c, cx) == 2.0 * 4 * c * 9 * (cx + c) \
        * b * h * w


def test_bounds_match_the_port_kernel_table():
    """K1 0.438 ms a decode step at B=32, 512x1024; K4 0.1518 / 0.0382 at
    256x512, B=32 / 8 (the PERF.md kernel table, bf16)."""
    fwd = flops.cell_geometries(512, 1024, 128)
    train = flops.cell_geometries(256, 512, 128)
    assert kernels.step_bound_s("k1", 32, fwd, "bfloat16") * 1e3 == \
        pytest.approx(0.438, abs=5e-4)
    assert kernels.step_bound_s("k4", 32, train, "bfloat16") * 1e3 == \
        pytest.approx(0.1518, abs=5e-5)
    assert kernels.step_bound_s("k4", 8, train, "bfloat16") * 1e3 == \
        pytest.approx(0.0382, abs=5e-5)


def test_mfu_peaks():
    assert peaks.mfu_peak("bfloat16") == 989e12
    assert peaks.mfu_peak("float32") == 495e12
