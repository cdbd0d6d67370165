"""The port's cell backward (rsis_tpu_torch/ops/fused_cell_vjp.py,
ops/conv3x3.py) against the JAX package's Pallas backward
(rsis_tpu/ops/pallas_decode_vjp.py) run in interpret mode on the CPU. On
CPU tensors each port wrapper runs its plain version, the oracle its CUDA
kernel is held against on the card.

- FusedCellFunction's five cotangents against jax.grad through
  make_fused_cell_vjp(..., interpret=True), with and without an up-input,
  atol 5e-4 as tests/test_pallas_vjp.py;
- bf16 gate cotangents (K4's plain version) are its fp32 ones rounded
  once, as the Pallas kernel stores them (pallas_decode_vjp.py:90-94);
- the plain conv (K3's plain version) with the flipped, transposed weight
  against _conv_transpose_rowmajor, which runs the Pallas conv;
- the weight gradient (K5's plain version) against weight_grad_rowmajor,
  fp32 and with the cast to bf16.
H = 4 keeps the interpret-mode runs short and still has rows away from
the zero halo."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsis_tpu.ops import pallas_decode as jpd
from rsis_tpu.ops import pallas_decode_vjp as jvjp
from rsis_tpu_torch.ops import fused_cell_vjp as tvjp
from rsis_tpu_torch.ops.conv3x3 import conv3x3_rowmajor
from torch_threads import one_torch_thread  # noqa: F401

# (B, H, W, Cx, C): an up-input cell and a cell without one (cell 0)
GEOMS = [(2, 4, 16, 16, 8), (2, 4, 32, 0, 16)]
BF16_ULP = 2.0 ** -7


def _case(b, h, w, cx, ch, seed):
    """Forward inputs (x_pad with a zero ring), HWIO kernel and the two
    output cotangents, fp32 numpy."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x_pad = (np.pad(normal(b, h, cx, w), ((0, 0), (1, 1), (0, 0), (1, 1)))
             if cx else None)
    return {"h_prev": normal(b, h, ch, w), "x_pad": x_pad,
            "c_prev": normal(b, h, ch, w), "s": normal(b, h, 4 * ch, w,
                                                       scale=0.2),
            "kernel": normal(3, 3, cx + ch, 4 * ch, scale=0.3),
            "dh": normal(b, h, ch, w), "dc": normal(b, h, ch, w)}


def _packed(case, cx, ch):
    wt_j = jpd.pack_cell_weights(jnp.asarray(case["kernel"]), cx, ch,
                                 dtype=jnp.float32)
    return wt_j, torch.from_numpy(np.asarray(wt_j).copy())


@pytest.mark.parametrize("b,h,w,cx,ch", GEOMS)
def test_cell_vjp_matches_jax(b, h, w, cx, ch):
    case = _case(b, h, w, cx, ch, seed=h + w + cx + ch)
    wt_j, wt_t = _packed(case, cx, ch)
    names = ["h_prev", "x_pad", "c_prev", "s"]
    cell = jvjp.make_fused_cell_vjp(cx, ch, interpret=True)
    dh, dc = jnp.asarray(case["dh"]), jnp.asarray(case["dc"])

    def objective(hp, x_pad, cp, s, wt):
        hh, cc = cell(hp, x_pad, cp, s, wt)
        return jnp.sum(hh * dh) + jnp.sum(cc * dc)

    args = [None if case[n] is None else jnp.asarray(case[n])
            for n in names] + [wt_j]
    argnums = tuple(i for i, a in enumerate(args) if a is not None)
    want = jax.grad(objective, argnums=argnums)(*args)

    leaves = [None if case[n] is None
              else torch.from_numpy(case[n]).requires_grad_()
              for n in names] + [wt_t.clone().requires_grad_()]
    h_t, c_t = tvjp.FusedCellFunction.apply(*leaves, cx, ch)
    ((h_t * torch.from_numpy(case["dh"])).sum()
     + (c_t * torch.from_numpy(case["dc"])).sum()).backward()
    got = [leaves[i].grad for i in argnums]
    assert len(got) == (5 if cx else 4)
    for i, g, w_ in zip(argnums, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=5e-4,
                                   rtol=5e-4,
                                   err_msg=(names + ["wt"])[i])


def test_dgates_bf16_round_once():
    b, h, w, cx, ch = GEOMS[0]
    case = _case(b, h, w, cx, ch, seed=5)
    _, wt_t = _packed(case, cx, ch)
    names = ["h_prev", "x_pad", "c_prev", "s"]
    ops = [torch.from_numpy(case[n]).to(torch.bfloat16) for n in names]
    cot = [torch.from_numpy(case[n]).to(torch.bfloat16)
           for n in ("dh", "dc")]
    wt = wt_t.to(torch.bfloat16)
    got = tvjp.cell_backward_dgates(*ops, wt, *cot, cx=cx, ch=ch)
    want = tvjp.cell_backward_dgates(*[o.float() for o in ops], wt.float(),
                                     *[c.float() for c in cot], cx=cx, ch=ch)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w_.to(torch.bfloat16))


@pytest.mark.parametrize("b,h,w,cx,ch", GEOMS)
def test_conv3x3_pullback_matches_jax(b, h, w, cx, ch):
    """The pullback conv as the backward calls it: dg (B, H, 4C, W) with
    the flip/transpose repack of the weight of both inputs."""
    case = _case(b, h, w, cx, ch, seed=1)
    wt_j, wt_t = _packed(case, cx, ch)
    dg = np.random.default_rng(2).normal(size=(b, h, 4 * ch, w)).astype(
        np.float32)
    take = "xh" if cx else "h"
    want = jvjp._conv_transpose_rowmajor(jnp.asarray(dg), wt_j, cx, ch,
                                         take=take, interpret=True)
    wpack = tvjp.conv_transpose_weights(wt_t, cx, ch, take)
    got = conv3x3_rowmajor(torch.from_numpy(dg), wpack, cin=4 * ch,
                           cout=cx + ch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,cx,ch", GEOMS)
def test_weight_grad_matches_jax(b, h, w, cx, ch, dtype):
    case = _case(b, h, w, cx, ch, seed=9)
    dg = np.random.default_rng(3).normal(size=(b, h, 4 * ch, w)).astype(
        np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x_pad = case["x_pad"]
    want = jvjp.weight_grad_rowmajor(
        jnp.asarray(case["h_prev"]).astype(jdt),
        None if x_pad is None else jnp.asarray(x_pad).astype(jdt),
        jnp.asarray(dg).astype(jdt), cx=cx, ch=ch,
        interpret=True).astype(jdt)            # _cell_bwd_core's cast
    got = tvjp.weight_grad_rowmajor(
        torch.from_numpy(case["h_prev"]).to(tdt),
        None if x_pad is None else torch.from_numpy(x_pad).to(tdt),
        torch.from_numpy(dg).to(tdt), cx=cx, ch=ch)
    assert got.dtype == tdt and tuple(got.shape) == (4 * ch, 9 * (cx + ch))
    want = np.asarray(want.astype(jnp.float32))
    # fp32: a sum over B*H*W = 128..256 products; bf16: the fp32 sums
    # agree to that, then round once
    tol = 1e-4 if dtype == "float32" else BF16_ULP * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
