"""The decode's inter-cell upsample: ``ops/upsample.py``'s tap tables,
its kernel wrapper and ``UpsampleFunction``, against the plain version
``upsample_rowmajor_ref`` (the two fp32 interpolation products).

On the CPU:

- ``interp_taps`` rebuilds ``interp_matrix`` exactly, padded and unpadded,
  in both dtypes, at every inter-cell upsample of the Cityscapes (512x1024
  forward, 256x512 train) and Pascal (256x256) shapes and at n_in = 1 and
  n_out = 1;
- a mirror of the kernel's arithmetic (each row's, then each column's
  two taps in fp32, rounded once to the dtype) equals the plain version bit
  for bit in bf16 at the Cityscapes forward's four upsamples;
- the wrapper and the Function on a CPU tensor return the plain version's
  output, and the Function's gradient is autograd's through it.

On the card (marker ``cuda``; they skip without one): the kernel against
the plain version (bf16 bit for bit at the forward's shapes, fp32 within
an ulp at the Pascal shapes), its zero ring, its refusals, its launch
count in a decode, and the Function's pullback. This file imports no
JAX: on the card, ``python -m pytest --noconftest -m cuda
tests/test_torch_upsample.py``."""

import numpy as np
import pytest
import torch

from rsis_tpu_torch.ops.upsample import (UpsampleFunction, interp_matrix,
                                         interp_taps,
                                         upsample_rowmajor_kernel,
                                         upsample_rowmajor_ref)
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
DTYPES = (torch.float32, torch.bfloat16)
# (B, h, C, w) -> (out_h, out_w) of the four inter-cell upsamples
CITYSCAPES_FORWARD = [((2, 16, 128, 32), (32, 64)),
                      ((2, 32, 64, 64), (64, 128)),
                      ((2, 64, 32, 128), (128, 256)),
                      ((2, 128, 16, 256), (256, 512))]
PASCAL = [((2, 8, 128, 8), (16, 16)), ((2, 16, 64, 16), (32, 32)),
          ((2, 32, 32, 32), (64, 64)), ((2, 64, 16, 64), (128, 128))]
# the axes (n_in, n_out) of every cell shape above and of the Cityscapes
# train step (256x512), and the one-row edges
AXES = sorted({(n, 2 * n) for n in (8, 16, 32, 64, 128, 256)}
              | {(1, 1), (1, 5), (5, 1), (2, 3), (3, 7)})


def _dense(taps: torch.Tensor, n_in: int) -> torch.Tensor:
    """The matrix whose row i is w_lo at column lo plus w_hi at hi."""
    t = taps.numpy()
    w = t[:, 2:].copy().view(np.float32)
    m = np.zeros((t.shape[0], n_in), dtype=np.float32)
    rows = np.arange(t.shape[0])
    np.add.at(m, (rows, t[:, 0]), w[:, 0])
    np.add.at(m, (rows, t[:, 1]), w[:, 1])
    return torch.from_numpy(m)


def _mirror(x: torch.Tensor, out_h: int, out_w: int, pad: bool):
    """The kernel's arithmetic: rows, then columns, two taps each in fp32,
    each pass rounded once to x's dtype."""
    b, h, c, w = x.shape
    rt = interp_taps(h, out_h, x.dtype, CPU, pad)
    ct = interp_taps(w, out_w, x.dtype, CPU, pad)

    def parts(t):
        return (t[:, 0].long(), t[:, 1].long(),
                t[:, 2].view(torch.float32), t[:, 3].view(torch.float32))

    lo, hi, wl, wh = parts(rt)
    xf = x.float()
    y = (wl[:, None, None] * xf[:, lo] + wh[:, None, None] * xf[:, hi])
    y = y.to(x.dtype).float()
    lo, hi, wl, wh = parts(ct)
    return (wl * y[..., lo] + wh * y[..., hi]).to(x.dtype)


def _input(shape, dtype, seed=0, device=CPU):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_taps_rebuild_interp_matrix(dtype, pad):
    for n_in, n_out in AXES:
        taps = interp_taps(n_in, n_out, dtype, CPU, pad)
        assert taps.dtype == torch.int32
        assert tuple(taps.shape) == (n_out + 2 * pad, 4)
        want = interp_matrix(n_in, n_out, dtype, CPU, pad)
        assert torch.equal(_dense(taps, n_in), want), (n_in, n_out)
        if pad:
            assert not taps[[0, -1]].any()
        assert (taps[:, 0] <= taps[:, 1]).all()
        assert (taps[:, 1] < n_in).all()


def test_kernel_arithmetic_is_the_plain_version_in_bf16():
    """bf16 operands multiply exactly in fp32 and two terms round once, so
    the taps give the products' result bit for bit; fp32 to an ulp."""
    for shape, (out_h, out_w) in CITYSCAPES_FORWARD:
        x = _input(shape, torch.bfloat16)
        for pad in (False, True):
            assert torch.equal(_mirror(x, out_h, out_w, pad),
                               upsample_rowmajor_ref(x, out_h, out_w, pad))
    shape, (out_h, out_w) = PASCAL[0]
    x = _input(shape, torch.float32)
    want = upsample_rowmajor_ref(x, out_h, out_w, True)
    torch.testing.assert_close(_mirror(x, out_h, out_w, True), want,
                               rtol=0, atol=4e-7 * want.abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    x = _input((2, 3, 4, 5), dtype)
    for pad in (False, True):
        want = upsample_rowmajor_ref(x, 6, 10, pad)
        assert torch.equal(upsample_rowmajor_kernel(x, 6, 10, pad), want)
        assert torch.equal(UpsampleFunction.apply(x, 6, 10, pad), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_function_gradient_is_the_plain_pullback(dtype):
    x = _input((2, 3, 4, 5), dtype).requires_grad_()
    g = _input((2, 8, 4, 12), dtype, seed=1)
    (got,) = torch.autograd.grad(UpsampleFunction.apply(x, 6, 10, True), x,
                                 g)
    (want,) = torch.autograd.grad(upsample_rowmajor_ref(x, 6, 10, True), x,
                                  g)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_wrapper_does_not_fall_back_off_the_cpu():
    with pytest.raises(ValueError, match="no kernel"):
        upsample_rowmajor_kernel(torch.empty(1, 2, 4, 3, device="meta"), 4, 6,
                                 True)


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [True, False])
def test_card_bf16_is_bit_identical(cuda, pad):
    for shape, (out_h, out_w) in CITYSCAPES_FORWARD:
        x = _input(shape, torch.bfloat16, device=cuda)
        got = upsample_rowmajor_kernel(x, out_h, out_w, pad)
        assert torch.equal(got, upsample_rowmajor_ref(x, out_h, out_w, pad))
        if pad:
            assert not got[:, [0, -1]].any()
            assert not got[..., [0, -1]].any()


@pytest.mark.cuda
def test_card_fp32_within_an_ulp(cuda):
    for shape, (out_h, out_w) in PASCAL:
        x = _input(shape, torch.float32, device=cuda)
        got = upsample_rowmajor_kernel(x, out_h, out_w, True)
        want = upsample_rowmajor_ref(x, out_h, out_w, True)
        ulp = torch.finfo(torch.float32).eps * want.abs().clamp_min(
            torch.finfo(torch.float32).tiny)
        assert ((got - want).abs() <= ulp).all()
        assert not got[:, [0, -1]].any()
        assert not got[..., [0, -1]].any()


@pytest.mark.cuda
def test_card_ragged_shapes(cuda):
    """Rows whose bytes are no multiple of 16, odd widths, one-row edges:
    the scalar paths of the kernel."""
    for shape, (out_h, out_w) in [((1, 3, 5, 7), (5, 13)),
                                  ((3, 1, 3, 1), (4, 9)),
                                  ((2, 4, 9, 3), (1, 1))]:
        for dtype in DTYPES:
            x = _input(shape, dtype, device=cuda)
            for pad in (True, False):
                got = upsample_rowmajor_kernel(x, out_h, out_w, pad)
                want = upsample_rowmajor_ref(x, out_h, out_w, pad)
                torch.testing.assert_close(got, want, rtol=0, atol=(
                    0 if dtype == torch.bfloat16
                    else 4e-7 * want.abs().max().item()))


@pytest.mark.cuda
def test_card_refuses_what_it_does_not_take(cuda):
    x = _input((2, 4, 8, 6), torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        upsample_rowmajor_kernel(x.transpose(1, 2), 8, 12, True)
    with pytest.raises(TypeError, match="float16"):
        upsample_rowmajor_kernel(x.half(), 8, 12, True)


@pytest.mark.cuda
def test_card_decode_launches(cuda):
    from rsis_tpu_torch.models.decoder import RSISDecoder, skip_widths
    from rsis_tpu_torch.models.rowmajor_decoder import (
        decode_sequence_rowmajor)
    T = 3
    decoder = RSISDecoder(hidden_size=128, num_classes=4,
                          skip_mode="concat").to(cuda).eval()
    # NCHW skips x5..x1 of a 64x64 image
    skips = [_input((2, c, 2 ** (i + 1), 2 ** (i + 1)), torch.float32,
                    seed=i, device=cuda)
             for i, c in enumerate(skip_widths(128))]
    before = upsample_rowmajor_kernel.launches
    with torch.inference_mode():
        masks, clss, stops = decode_sequence_rowmajor(
            decoder, skips, T, "concat", dtype=torch.bfloat16)
    assert upsample_rowmajor_kernel.launches - before == 4 * T
    assert tuple(masks.shape) == (2, T, 64, 64)
    assert torch.isfinite(masks.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_pullback(cuda, dtype):
    x = _input((2, 16, 64, 16), dtype, device=cuda).requires_grad_()
    g = _input((2, 34, 64, 34), dtype, seed=1, device=cuda)
    (got,) = torch.autograd.grad(UpsampleFunction.apply(x, 32, 32, True), x,
                                 g)
    (want,) = torch.autograd.grad(upsample_rowmajor_ref(x, 32, 32, True), x,
                                  g)
    assert torch.equal(got, want)
