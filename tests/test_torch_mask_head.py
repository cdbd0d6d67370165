"""The port's mask head (rsis_tpu_torch/ops/mask_head.py) against the JAX
package's Pallas head (rsis_tpu/ops/pallas_mask_head.py) run in interpret
mode on the CPU, at the shapes of tests/test_pallas_mask_head.py. On CPU
tensors the port's wrapper runs its plain version (conv2d over the
align-corners upsample), the oracle the CUDA kernel is held against on the
card. fp32; atol 1e-4 as the JAX head's own test uses."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rsis_tpu.ops.mask_head import mask_head_fused
from rsis_tpu.ops.pallas_mask_head import mask_head_pallas
from rsis_tpu_torch.ops import mask_head as tmh
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4


def _case(b, h, c, w, seed=0):
    rng = np.random.default_rng(seed)
    hs = rng.normal(size=(b, h, c, w)).astype(np.float32)
    k = rng.normal(size=(3, 3, c, 1)).astype(np.float32)   # HWIO
    bias = rng.normal(size=(1,)).astype(np.float32)
    return hs, k, bias


def _port(hs, k, bias):
    weight = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())  # (1, C, 3, 3)
    return tmh.mask_head_fused_kernel(torch.from_numpy(hs), weight,
                                      torch.from_numpy(bias))


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 16),    # single tile
    (1, 64, 8, 16),   # one 64-row tile
    (2, 48, 4, 8),    # three 16-row tiles (halo + edge masks)
    (1, 96, 8, 16),   # multi-tile at th=32
    (1, 6, 3, 8),     # odd channel count, tiny tile
])
def test_matches_pallas_head(shape):
    hs, k, bias = _case(*shape)
    launches = tmh.mask_head_fused_kernel.launches
    got = _port(hs, k, bias)
    assert tmh.mask_head_fused_kernel.launches == launches  # CPU: no kernel
    want = mask_head_pallas(jnp.asarray(hs), jnp.asarray(k),
                            jnp.asarray(bias), interpret=True)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 1, 2, 1), (2, 5, 3, 7)])
def test_matches_dense_head(shape):
    """Degenerate and odd sizes (H = W = 1 interpolates by copying) against
    the dense formulation the Pallas head is proven against."""
    hs, k, bias = _case(*shape, seed=1)
    want = mask_head_fused(jnp.moveaxis(jnp.asarray(hs), 2, -1),
                           jnp.asarray(k), jnp.asarray(bias))
    np.testing.assert_allclose(_port(hs, k, bias).numpy(), np.asarray(want),
                               atol=ATOL)


def test_bf16_rounds_once():
    hs, k, bias = _case(1, 8, 4, 16, seed=2)
    weight = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    h16 = torch.from_numpy(hs).to(torch.bfloat16)
    got = tmh.mask_head_fused_kernel(h16, weight, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    want = tmh.mask_head_ref(h16.float(), weight, torch.from_numpy(bias))
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.to(torch.bfloat16).float().numpy())


def test_rejects_wrong_weight():
    hs, k, bias = _case(1, 4, 3, 4)
    with pytest.raises(ValueError):
        tmh.mask_head_fused_kernel(torch.from_numpy(hs),
                                   torch.zeros(1, 2, 3, 3),
                                   torch.from_numpy(bias))
