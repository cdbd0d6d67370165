"""The port's affine warp (``rsis_tpu_torch/ops/warp.py``, kernel K7)
against the JAX package's (``rsis_tpu/ops/pallas_warp.py``).

- ``_coef_from_matrices`` equal to JAX's bit for bit, with and without
  flips;
- the plain warp (the CPU path of ``affine_warp``) against JAX's
  ``nearest_index_maps`` and a numpy gather, over several seeds, with and
  without flips, with a strong translation that clamps at the borders, on
  a bf16 plane of integer ids, and at the identity;
- one small case against the Pallas kernel itself in interpret mode;
- the uint8 id plane refuses 256 or more instance slots.

Tolerance: exact equality, except at pixels whose float64 source
coordinate lies within 1e-4 of a .5 rounding boundary, at most 16 of them
(the rule of ``tests/test_pallas_warp.py``): there a float32 expression
may round either way between separately compiled programs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsis_tpu.data.device_aug import sample_affine_matrices
from rsis_tpu.ops import pallas_warp as jax_warp
from rsis_tpu_torch.data.device_aug import augment_wire_batch_with
from rsis_tpu_torch.ops import warp as port_warp
from torch_threads import one_torch_thread  # noqa: F401


def _mats(b, h, w, seed, rotation=10.0, translation=0.1, shear=10.0,
          zoom=(0.77, 1.0)):
    return np.array(sample_affine_matrices(
        jax.random.PRNGKey(seed), b, h, w, rotation, translation, shear,
        zoom))


def assert_equal_except_f32_ties(got, want, matrices, flip=None, tol=1e-4,
                                 max_bad=16):
    """got, want (B, H, W, C): equal at every pixel, except at most
    max_bad pixels each within tol of a rounding tie."""
    got, want = np.asarray(got), np.asarray(want)
    b, h, w = got.shape[:3]
    bad = np.argwhere((got != want).reshape(b, h, w, -1).any(-1))
    assert len(bad) <= max_bad, f"{len(bad)} mismatches (too many)"
    coef = np.asarray(jax_warp._coef_from_matrices(
        jnp.asarray(matrices), h, w,
        None if flip is None else jnp.asarray(flip)))
    for bi, r, c in bad:
        p, q, m, u, v, o = coef[bi, :6].astype(np.float64)
        fr = (p * r + (q * c + m)) % 1.0
        fc = (v * r + (u * c + o)) % 1.0
        assert min(abs(fr - 0.5), abs(fc - 0.5)) < tol, (
            f"true mismatch at b{bi} ({r},{c}): fr={fr:.6f} fc={fc:.6f}")


def _jax_gather(x, matrices, flip=None):
    """x (B, H, W, C) numpy warped by JAX's canonical index maps."""
    b, h, w, c = x.shape
    idx = np.asarray(jax_warp.nearest_index_maps(
        jnp.asarray(matrices), h, w,
        None if flip is None else jnp.asarray(flip)))
    return np.stack([x[i].reshape(h * w, c)[idx[i]].reshape(h, w, c)
                     for i in range(b)])


def _port_warp(x, matrices, flip=None, dtype=torch.float32):
    b, h, w, _ = x.shape
    ids = torch.zeros((b, h, w), dtype=torch.uint8)
    out, _ = port_warp.affine_warp(
        torch.from_numpy(x).to(dtype), ids, torch.from_numpy(matrices),
        None if flip is None else torch.from_numpy(flip))
    return out.float().numpy()


@pytest.mark.parametrize("flip", [None, [True, False, True]])
def test_coef_matches_jax_bit_for_bit(flip):
    ms = _mats(3, 48, 80, 4)
    fl = None if flip is None else np.asarray(flip)
    want = np.asarray(jax_warp._coef_from_matrices(
        jnp.asarray(ms), 48, 80, None if fl is None else jnp.asarray(fl)))
    got = port_warp._coef_from_matrices(
        torch.from_numpy(ms), 48, 80,
        None if fl is None else torch.from_numpy(fl)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_warp_matches_jax(seed):
    b, h, w, c = 2, 64, 96, 3
    x = np.random.default_rng(seed).normal(size=(b, h, w, c)).astype(
        np.float32)
    ms = _mats(b, h, w, seed)
    assert_equal_except_f32_ties(_port_warp(x, ms), _jax_gather(x, ms), ms)


def test_plain_warp_with_flip_matches_jax():
    b, h, w, c = 4, 64, 128, 2
    x = np.random.default_rng(7).normal(size=(b, h, w, c)).astype(
        np.float32)
    ms = _mats(b, h, w, 7)
    flip = np.asarray([True, False, True, False])
    assert_equal_except_f32_ties(_port_warp(x, ms, flip),
                                 _jax_gather(x, ms, flip), ms, flip)


def test_plain_warp_strong_translation_clamps_at_borders():
    b, h, w, c = 2, 64, 64, 1
    x = np.random.default_rng(3).normal(size=(b, h, w, c)).astype(
        np.float32)
    ms = _mats(b, h, w, 3, rotation=15.0, translation=0.4, shear=5.0,
               zoom=(0.8, 1.2))
    got = _port_warp(x, ms)
    # rows or columns clamp: some output pixels repeat an edge pixel
    idx = np.asarray(jax_warp.nearest_index_maps(jnp.asarray(ms), h, w))
    rows, cols = idx // w, idx % w
    assert ((rows == 0) | (rows == h - 1) | (cols == 0)
            | (cols == w - 1)).mean() > 0.05
    assert_equal_except_f32_ties(got, _jax_gather(x, ms), ms)


def test_plain_warp_bf16_id_plane_exact():
    b, h, w = 2, 64, 64
    ids = np.random.default_rng(5).integers(0, 21, (b, h, w, 1)).astype(
        np.float32)
    ms = _mats(b, h, w, 5)
    got = _port_warp(ids, ms, dtype=torch.bfloat16)
    assert_equal_except_f32_ties(got, _jax_gather(ids, ms), ms)


def test_identity_is_exact():
    x = torch.randn(1, 32, 48, 3, generator=torch.Generator().manual_seed(0))
    ids = torch.randint(0, 9, (1, 32, 48), dtype=torch.uint8)
    out, ids_out = port_warp.affine_warp(x, ids, torch.eye(3)[None])
    assert torch.equal(out, x) and torch.equal(ids_out, ids)


def test_plain_warp_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode), planes (1, 2, 128, 128)
    with a flip."""
    b, ch, h, w = 1, 2, 128, 128
    x = np.random.default_rng(11).normal(size=(b, ch, h, w)).astype(
        np.float32)
    ms = _mats(b, h, w, 11)
    flip = np.asarray([True])
    want = jax_warp.affine_warp_planes(jnp.asarray(x), jnp.asarray(ms),
                                       flip=jnp.asarray(flip),
                                       interpret=True)
    got = _port_warp(np.ascontiguousarray(x.transpose(0, 2, 3, 1)), ms,
                     flip)
    assert_equal_except_f32_ties(
        got, np.asarray(want).transpose(0, 2, 3, 1), ms, flip)


def test_id_plane_needs_fewer_than_256_slots():
    x = torch.zeros(1, 8, 8, 3)
    eye = torch.eye(3)[None]
    flip = torch.zeros(1, dtype=torch.bool)
    out = augment_wire_batch_with(x, torch.zeros(1, 255, 64,
                                                 dtype=torch.uint8),
                                  eye, flip)
    assert out[1].shape == (1, 255, 64)
    with pytest.raises(ValueError, match="255"):
        augment_wire_batch_with(x, torch.zeros(1, 256, 64,
                                               dtype=torch.uint8),
                                eye, flip)
