"""The port's ConvLSTM step (K8's plain version, ``ops/clstm_step.py``)
against the JAX package's.

- ``fused_convlstm_step`` (the JAX signature: NHWC, HWIO) and
  ``clstm_step`` (NCHW, OIHW) against the Pallas ``fused_convlstm_step``
  in interpret mode at ``tests/test_pallas_clstm.py``'s three shapes and
  over a 3-step recurrence, fp32, atol 3e-5 (the same sums in another
  order);
- an odd H, which the Pallas kernel rejects, against the flax
  ``ConvLSTMCell``, fp32, atol 3e-5;
- the port's ``ConvLSTMCell`` in inference (no gradient) takes the
  wrapper, under autograd its own convolution, and both agree (1e-5);
  ``plain`` reaches every cell of the plain decode through
  ``decode_sequence`` and leaves the result unchanged (exactly);
- the kernel's OHWI weight copy holds the OIHW weight's values in the
  input dtype, contiguous, for fp32 and bf16;
- the wrapper raises on a tensor that is neither on the CPU nor on a
  CUDA device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsis_tpu.models.clstm import ConvLSTMCell as FlaxCell
from rsis_tpu.ops.pallas_clstm import fused_convlstm_step as jax_step
from rsis_tpu_torch.models import clstm as port_clstm
from rsis_tpu_torch.models.decoder import RSISDecoder
from rsis_tpu_torch.models.rsis import decode_sequence
from rsis_tpu_torch.ops.clstm_step import (clstm_step, clstm_step_ref,
                                           fused_convlstm_step, ohwi_weight)
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 3e-5


def _flax_params(b, h, w, cx, ch, seed):
    x = jnp.zeros((b, h, w, cx))
    state = (jnp.zeros((b, h, w, ch)),) * 2
    v = jax.jit(FlaxCell(hidden=ch, kernel_size=3).init)(
        jax.random.PRNGKey(seed), x, state)
    return (np.asarray(v["params"]["gates"]["kernel"]),
            np.asarray(v["params"]["gates"]["bias"]), v)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [
    (2, 8, 16, 12, 8),    # B, H, W, Cx, C
    (1, 16, 32, 24, 16),
    (2, 4, 8, 4, 4),
])
def test_step_matches_pallas_kernel(shape):
    b, h, w, cx, ch = shape
    rng = np.random.default_rng(0)
    x, h0, c0 = (_normal(rng, b, h, w, n) for n in (cx, ch, ch))
    kernel, bias, _ = _flax_params(b, h, w, cx, ch, 0)
    want = jax_step(x, h0, c0, kernel, bias, interpret=True)
    got = fused_convlstm_step(_t(x), _t(h0), _t(c0), _t(kernel), _t(bias))
    # the NCHW entry point on the same operands
    nchw = [_t(a).permute(0, 3, 1, 2) for a in (x, h0, c0)]
    got_nchw = clstm_step(*nchw, _t(kernel).permute(3, 2, 0, 1), _t(bias))
    for g, gn, wt in zip(got, got_nchw, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), atol=ATOL)
        np.testing.assert_allclose(gn.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(wt), atol=ATOL)


def test_recurrence_matches_pallas_kernel():
    b, h, w, cx, ch = 1, 8, 8, 6, 4
    rng = np.random.default_rng(1)
    x = _normal(rng, b, h, w, cx)
    kernel, bias, _ = _flax_params(b, h, w, cx, ch, 1)
    hj = cj = np.zeros((b, h, w, ch), np.float32)
    hp = cp = torch.zeros(b, h, w, ch)
    for _ in range(3):
        hj, cj = jax_step(x, hj, cj, kernel, bias, interpret=True)
        hp, cp = fused_convlstm_step(_t(x), hp, cp, _t(kernel), _t(bias))
        np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=ATOL)
        np.testing.assert_allclose(cp.numpy(), np.asarray(cj), atol=ATOL)


def test_odd_height_matches_flax_cell():
    b, h, w, cx, ch = 2, 7, 12, 5, 4
    rng = np.random.default_rng(2)
    x, h0, c0 = (_normal(rng, b, h, w, n) for n in (cx, ch, ch))
    kernel, bias, v = _flax_params(b, h, w, cx, ch, 2)
    with pytest.raises(ValueError):
        jax_step(x, h0, c0, kernel, bias, interpret=True)
    h_want, (_, c_want) = FlaxCell(hidden=ch, kernel_size=3).apply(
        v, x, (h0, c0))
    got = fused_convlstm_step(_t(x), _t(h0), _t(c0), _t(kernel), _t(bias))
    for g, wt in zip(got, (h_want, c_want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), atol=ATOL)


def test_cell_takes_the_wrapper_in_inference_only(monkeypatch):
    torch.manual_seed(0)
    cell = port_clstm.ConvLSTMCell(6, 4)
    x = torch.randn(2, 6, 5, 7)
    state = (torch.randn(2, 4, 5, 7), torch.randn(2, 4, 5, 7))
    calls = []

    def spy(*args, plain=False):
        calls.append(plain)
        return clstm_step(*args, plain=plain)

    monkeypatch.setattr(port_clstm, "clstm_step", spy)
    with torch.no_grad():
        h_inf, (_, c_inf) = cell(x, state)
        cell(x, state, plain=True)
    h_ad, (_, c_ad) = cell(x, state)
    assert calls == [False, True]
    assert h_ad.requires_grad
    torch.testing.assert_close(h_inf, h_ad.detach(), rtol=0, atol=1e-5)
    torch.testing.assert_close(c_inf, c_ad.detach(), rtol=0, atol=1e-5)


def test_plain_reaches_the_cells_of_the_plain_decode(monkeypatch):
    torch.manual_seed(1)
    dec = RSISDecoder(hidden_size=16, num_classes=4, skip_mode="mul").eval()
    skips = [torch.randn(2, c, 2 ** (i + 1), 2 ** (i + 2))
             for i, c in enumerate((16, 16, 8, 4, 2))]
    calls = []

    def spy(*args, plain=False):
        calls.append(plain)
        return clstm_step(*args, plain=plain)

    monkeypatch.setattr(port_clstm, "clstm_step", spy)
    with torch.no_grad():
        got = decode_sequence(dec, skips, 3)[:3]
        assert calls == [False] * 15
        want = decode_sequence(dec, skips, 3, plain=True)[:3]
    assert calls[15:] == [True] * 15
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ref_rounds_once_in_bf16():
    # h and c are the fp32 results rounded to the input dtype once
    rng = np.random.default_rng(3)
    ops = [_t(_normal(rng, *s)) for s in
           ((1, 3, 4, 5), (1, 2, 4, 5), (1, 2, 4, 5), (8, 5, 3, 3), (8,))]
    h32, c32 = clstm_step_ref(*ops)
    bf = [t.to(torch.bfloat16) for t in ops[:4]] + [ops[4]]
    h16, c16 = clstm_step_ref(*bf)
    assert h16.dtype == c16.dtype == torch.bfloat16
    h_exact, c_exact = clstm_step_ref(*[t.float() for t in bf[:4]], ops[4])
    assert torch.equal(h16, h_exact.to(torch.bfloat16))
    assert torch.equal(c16, c_exact.to(torch.bfloat16))
    assert not torch.equal(h16.float(), h32)


def test_wrapper_does_not_fall_back_off_the_cpu():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        clstm_step(torch.empty(1, 3, 4, 5, **meta),
                   torch.empty(1, 2, 4, 5, **meta),
                   torch.empty(1, 2, 4, 5, **meta),
                   torch.empty(8, 5, 3, 3, **meta), torch.empty(8, **meta))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ohwi_weight_is_a_contiguous_copy(dtype):
    w = torch.randn(16, 7, 3, 3)
    got = ohwi_weight(w, dtype)
    assert got.shape == (16, 3, 3, 7) and got.dtype == dtype
    assert got.is_contiguous() and got.data_ptr() != w.data_ptr()
    for o, i, y, x in ((3, 5, 0, 2), (15, 0, 2, 1), (0, 6, 1, 1)):
        assert got[o, y, x, i] == w[o, i, y, x].to(dtype)
    flat = got.reshape(16, -1)
    assert torch.equal(flat[:, 1 * 7 + 4], w[:, 4, 0, 1].to(dtype))
