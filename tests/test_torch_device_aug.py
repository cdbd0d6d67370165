"""The port's device augmentation (``rsis_tpu_torch/data/device_aug.py``)
against the JAX package's (``rsis_tpu/data/device_aug.py``).

torch.Generator and jax.random draw different numbers, so the tests
reproduce JAX's own draws (``k_flip, k_aff = split(rng)``, the flips from
``bernoulli(k_flip, 0.5)``, the matrices from five keys split off k_aff)
and hand them to the port:

- ``affine_from_draws`` on JAX's drawn values against JAX's
  ``sample_affine_matrices``, atol 1e-6 (3x3 products summed in another
  order);
- ``augment_wire_batch_with`` on JAX's flips and matrices against JAX's
  ``augment_wire_batch`` (its CPU path: a physical flip and a gather), on
  fp32 and bf16 images and disjoint instance masks, under the tie rule of
  ``tests/test_torch_warp.py``;
- ``zoom_range_for`` and the port's own draws (shapes, ranges, one
  generator giving the same batch twice from the same seed)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.data import device_aug as jax_aug
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.data import device_aug as port_aug
from test_torch_warp import assert_equal_except_f32_ties
from torch_threads import one_torch_thread  # noqa: F401

ROT, TRANS, SHEAR = 10.0, 0.1, 0.1


def _jax_draws(key, b, h, w, zoom):
    """The values ``sample_affine_matrices(key, ...)`` draws."""
    ks = jax.random.split(key, 5)

    def uni(k, shape, lim):
        return np.asarray(jax.random.uniform(k, shape, minval=-lim,
                                             maxval=lim))
    draws = [uni(ks[0], (b,), ROT), uni(ks[1], (b,), TRANS) * h,
             uni(ks[2], (b,), TRANS) * w, uni(ks[3], (b,), SHEAR)]
    z = (None if zoom is None else np.asarray(jax.random.uniform(
        ks[4], (b, 2), minval=zoom[0], maxval=zoom[1])))
    return [torch.from_numpy(np.array(d)) for d in draws], (
        None if z is None else torch.from_numpy(np.array(z)))


@pytest.mark.parametrize("zoom", [None, (0.7, 1.4)])
def test_composition_matches_jax(zoom):
    key = jax.random.PRNGKey(3)
    b, h, w = 6, 64, 128
    want = np.asarray(jax_aug.sample_affine_matrices(
        key, b, h, w, ROT, TRANS, SHEAR, zoom))
    draws, z = _jax_draws(key, b, h, w, zoom)
    got = port_aug.affine_from_draws(*draws, z)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _wire(rng, b, h, w, n):
    """Normalised-looking images and disjoint uint8 masks (B, N, H*W)."""
    x = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    ins = rng.integers(0, n + 1, (b, h * w))
    masks = (ins[:, None, :] == np.arange(1, n + 1)[None, :, None])
    return x, masks.astype(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_augment_wire_batch_matches_jax(dtype):
    b, h, w, n = 4, 48, 64, 6
    x, y_mask = _wire(np.random.default_rng(1), b, h, w, n)
    key = jax.random.PRNGKey(9)
    zoom = (0.7, 1.4)
    jx = jnp.asarray(x, dtype)
    want_x, want_m = jax_aug.augment_wire_batch(
        key, jx, jnp.asarray(y_mask), ROT, TRANS, SHEAR, zoom)
    k_flip, k_aff = jax.random.split(key)
    flip = np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))
    ms = np.array(jax_aug.sample_affine_matrices(k_aff, b, h, w, ROT, TRANS,
                                                 SHEAR, zoom))
    assert flip.any() and not flip.all()
    got_x, got_m = port_aug.augment_wire_batch_with(
        torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            getattr(torch, dtype)),
        torch.from_numpy(y_mask), torch.from_numpy(ms),
        torch.from_numpy(flip))
    assert got_x.dtype == getattr(torch, dtype)
    assert got_m.dtype == torch.uint8 and got_m.shape == (b, n, h * w)

    def pixels(img, masks):
        m = np.asarray(masks).reshape(b, n, h, w).transpose(0, 2, 3, 1)
        return np.concatenate([np.asarray(img, np.float32), m], axis=-1)
    assert_equal_except_f32_ties(
        pixels(got_x.float().numpy(), got_m.numpy()),
        pixels(want_x.astype(jnp.float32), want_m), ms, flip)


@pytest.mark.parametrize("dataset,resize", [("pascal", False),
                                            ("cityscapes", False),
                                            ("cityscapes", True),
                                            ("synthetic", False)])
def test_zoom_range_for_matches_jax(dataset, resize):
    kw = dict(dataset=dataset, resize=resize, zoom=0.7)
    assert (port_aug.zoom_range_for(Config(**kw))
            == jax_aug.zoom_range_for(JaxConfig(**kw)))


def test_own_draws_are_seeded_and_in_range():
    b, h, w = 64, 32, 48
    x = torch.randn(b, h, w, 3, generator=torch.Generator().manual_seed(0))
    y = torch.randint(0, 2, (b, 3, h * w), dtype=torch.uint8)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        outs.append(port_aug.augment_wire_batch(gen, x, y, ROT, TRANS,
                                                SHEAR, (0.7, 1.4)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    m = port_aug.sample_affine_matrices(torch.Generator().manual_seed(1), b,
                                        h, w, ROT, TRANS, SHEAR, (0.7, 1.4))
    assert m.shape == (b, 3, 3)
    # the translation column stays within the drawn range after R @ T
    lim = TRANS * math.hypot(h, w) * 1.4
    assert m[:, :2, 2].abs().max() <= lim
    np.testing.assert_allclose(m[:, 2].numpy(),
                               np.tile([0.0, 0.0, 1.0], (b, 1)))
