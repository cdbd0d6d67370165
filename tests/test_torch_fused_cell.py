"""The port's fused decode cell (rsis_tpu_torch/ops/fused_cell.py) against
the JAX package's Pallas cell (rsis_tpu/ops/pallas_decode.py) run in
interpret mode on the CPU, standard and dy-folded. On CPU tensors the
port's wrapper runs its plain version, the oracle the CUDA kernel is held
against on the card. fp32 throughout; atol 3e-5 covers fp32 summation
order over K <= 9 * (Cx + C) terms."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rsis_tpu.ops import pallas_decode as jpd
from rsis_tpu_torch.ops import fused_cell as tfc
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 3e-5

GEOMS = [
    # (B, H, W, Cx, C): no up-input (cell 0), Cx > 0, a full-lane W, and
    # H = 48 (three 16-row Pallas tiles: halo rows between tiles), and an
    # odd W (the SAME padding at a row end of the CVPPP recipe's
    # 13-wide cell)
    (2, 8, 32, 0, 16),
    (2, 8, 16, 16, 8),
    (1, 8, 128, 8, 4),
    (1, 48, 16, 4, 4),
    (1, 6, 13, 8, 8),
]


def _case(b, h, w, cx, ch, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, cx, w)).astype(np.float32) if cx else None
    x_pad = (np.pad(x, ((0, 0), (1, 1), (0, 0), (1, 1))) if cx else None)
    h_prev = rng.normal(size=(b, h, ch, w)).astype(np.float32)
    c_prev = rng.normal(size=(b, h, ch, w)).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, cx + ch, 4 * ch)) * 0.2).astype(
        np.float32)                                   # HWIO, as in JAX
    s = (rng.normal(size=(b, h, 4 * ch, w)) * 0.1).astype(np.float32)
    return x_pad, h_prev, c_prev, kernel, s


def _port(x_pad, h_prev, c_prev, kernel, s, cx, ch):
    t = torch.from_numpy
    weight = t(kernel.transpose(3, 2, 0, 1).copy())  # OIHW
    wt = tfc.pack_cell_weights(weight, cx, ch, dtype=torch.float32)
    return tfc.fused_cell_rowmajor(
        t(h_prev), None if x_pad is None else t(x_pad), t(c_prev), t(s), wt,
        cx=cx, ch=ch)


def _jax(x_pad, h_prev, c_prev, kernel, s, cx, ch, dyfold):
    wt = jpd.pack_cell_weights(jnp.asarray(kernel), cx, ch,
                               dtype=jnp.float32)
    return jpd.fused_cell_rowmajor(
        jnp.asarray(h_prev), None if x_pad is None else jnp.asarray(x_pad),
        jnp.asarray(c_prev), jnp.asarray(s), wt, cx=cx, ch=ch,
        interpret=True, dyfold=dyfold)


@pytest.mark.parametrize("b,h,w,cx,ch", GEOMS)
def test_matches_pallas_cell(b, h, w, cx, ch):
    case = _case(b, h, w, cx, ch, seed=h + w + cx + ch)
    launches = tfc.fused_cell_rowmajor.launches
    h_t, c_t = _port(*case, cx, ch)
    assert tfc.fused_cell_rowmajor.launches == launches  # CPU: no kernel
    h_j, c_j = _jax(*case, cx, ch, dyfold=False)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL)


@pytest.mark.parametrize("b,h,w,cx,ch", [(1, 8, 128, 8, 4),
                                         (1, 16, 128, 0, 8)])
def test_matches_pallas_cell_dyfold(b, h, w, cx, ch):
    assert jpd._dyfold_th(4 * ch, cx + ch, h, w) is not None
    case = _case(b, h, w, cx, ch, seed=7)
    h_t, c_t = _port(*case, cx, ch)
    h_j, c_j = _jax(*case, cx, ch, dyfold=True)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL)


@pytest.mark.parametrize("cx,ch", [(0, 3), (2, 3), (16, 8)])
def test_pack_cell_weights_equal(cx, ch):
    kernel = np.arange(3 * 3 * (cx + ch) * 4 * ch, dtype=np.float32
                       ).reshape(3, 3, cx + ch, 4 * ch)
    want = jpd.pack_cell_weights(jnp.asarray(kernel), cx, ch,
                                 dtype=jnp.float32)
    got = tfc.pack_cell_weights(
        torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), cx, ch,
        dtype=torch.float32)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_storage():
    """bf16 operands: products and the update in fp32, h and c rounded
    once, as the Pallas kernel stores them (pallas_decode.py:578-579)."""
    x_pad, h_prev, c_prev, kernel, s = _case(1, 8, 16, 4, 4, seed=3)
    bf = torch.bfloat16
    t = torch.from_numpy
    wt = tfc.pack_cell_weights(t(kernel.transpose(3, 2, 0, 1).copy()), 4, 4,
                               dtype=bf)
    ops = [t(a).to(bf) for a in (h_prev, x_pad, c_prev, s)]
    h_b, c_b = tfc.fused_cell_rowmajor(ops[0], ops[1], ops[2], ops[3], wt,
                                       cx=4, ch=4)
    assert h_b.dtype == bf and c_b.dtype == bf
    h_f, c_f = tfc.fused_cell_rowmajor_ref(
        *[o.float() for o in ops[:4]], wt.float(), cx=4, ch=4)
    np.testing.assert_array_equal(h_b.float().numpy(),
                                  h_f.to(bf).float().numpy())
    np.testing.assert_array_equal(c_b.float().numpy(),
                                  c_f.to(bf).float().numpy())


def test_rejects_bad_operands():
    x_pad, h_prev, c_prev, kernel, s = _case(1, 8, 16, 4, 4, seed=1)
    t = torch.from_numpy
    wt = tfc.pack_cell_weights(t(kernel.transpose(3, 2, 0, 1).copy()), 4, 4,
                               dtype=torch.float32)
    with pytest.raises(ValueError):
        tfc.fused_cell_rowmajor(t(h_prev), None, t(c_prev), t(s), wt,
                                cx=4, ch=4)
    with pytest.raises(ValueError):
        tfc.fused_cell_rowmajor(t(h_prev), t(x_pad), t(c_prev),
                                t(s)[:, :, :8], wt, cx=4, ch=4)
