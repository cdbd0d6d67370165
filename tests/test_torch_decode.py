"""The port's decode loops against the JAX package's on shared weights.

- models/rowmajor_decoder.decode_sequence_rowmajor (the kernel decode, on
  the CPU through the kernels' plain versions) against JAX
  decode_sequence_rowmajor with its Pallas kernels in interpret mode, for
  the channel-separable skip modes;
- models/rsis.decode_sequence (the plain decode, the only path for "mul")
  against JAX rsis.decode_sequence.

Weights come from JAX init (jitted: the same numbers as the eager init in
a fraction of the time) and pass through models/weights.py. fp32, T=3;
atol 1e-4 (as tests/test_rowmajor_decoder.py) covers fp32 summation order
compounded over 5 cells x 3 steps. The skip pyramid is the one of
tests/test_fast_decoder.py::make_setup with its fine cells shrunk 4x,
which keeps the interpret-mode compiles short."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsis_tpu.models.decoder import RSISDecoder as JaxRSISDecoder
from rsis_tpu.models.rowmajor_decoder import (
    decode_sequence_rowmajor as jax_decode_rowmajor)
from rsis_tpu.models.rsis import decode_sequence as jax_decode_sequence
from rsis_tpu_torch.models import rowmajor_decoder as trm
from rsis_tpu_torch.models.decoder import RSISDecoder
from rsis_tpu_torch.models.rsis import decode_sequence
from rsis_tpu_torch.models.weights import decoder_state_dict
from rsis_tpu_torch.ops.upsample import upsample_rowmajor_ref
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4
T = 3
# (C, H, W) of the five skips, coarsest first
GEOMS = [(16, 2, 4), (16, 2, 4), (8, 2, 4), (4, 4, 8), (2, 8, 16)]
# widths 3, 5, 10, 20 and 40, as the CVPPP recipe's 13, 25, 50, 100 and
# 200: SAME padding at odd row ends and an upsample to the skip's own
# width (3 -> 5), not to twice the coarse one (H stays even: the Pallas
# kernels' 2-row halo blocks need it)
ODD_GEOMS = [(16, 2, 3), (16, 2, 5), (8, 2, 10), (4, 4, 20), (2, 8, 40)]


def _jax_setup(skip_mode, seed=0, geoms=GEOMS):
    rng = np.random.default_rng(seed)
    skips = [jnp.asarray(rng.normal(size=(1, hh, ww, c)).astype(np.float32))
             for (c, hh, ww) in geoms]
    dec = JaxRSISDecoder(hidden_size=16, num_classes=4, skip_mode=skip_mode)
    variables = jax.jit(lambda key: dec.init(key, skips, None, train=False))(
        jax.random.PRNGKey(seed))
    return dec, variables["params"], skips


def _port_setup(skip_mode, geoms=GEOMS):
    dec, params, skips = _jax_setup(skip_mode, geoms=geoms)
    decoder = RSISDecoder(hidden_size=dec.hidden_size, num_classes=4,
                          skip_mode=skip_mode)
    decoder.load_state_dict(
        decoder_state_dict(jax.tree.map(np.asarray, params)))
    t_skips = [torch.from_numpy(np.array(s)).permute(0, 3, 1, 2)
               for s in skips]
    return dec, params, skips, decoder.eval(), t_skips


def _rowmajor_matches_jax(skip_mode, geoms=GEOMS):
    dec, params, skips, decoder, t_skips = _port_setup(skip_mode, geoms)
    want = jax_decode_rowmajor(params, skips, T, dec.hidden_size, skip_mode,
                               dtype=jnp.float32, interpret=True)
    with torch.inference_mode():
        got = trm.decode_sequence_rowmajor(decoder, t_skips, T, skip_mode,
                                           dtype=torch.float32)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    return got


@pytest.mark.parametrize("skip_mode", ["concat", "sum", "none"])
def test_rowmajor_decode_matches_jax(skip_mode):
    _rowmajor_matches_jax(skip_mode)


def test_rowmajor_decode_matches_jax_at_odd_widths():
    masks = _rowmajor_matches_jax("concat", ODD_GEOMS)[0]
    assert tuple(masks.shape) == (1, T, 16, 80)


def test_plain_decode_matches_jax_mul():
    dec, params, skips, decoder, t_skips = _port_setup("mul")
    m_w, c_w, s_w, carry_w = jax_decode_sequence(dec, params, skips, T)
    with torch.inference_mode():
        m_g, c_g, s_g, carry_g = decode_sequence(decoder, t_skips, T)
    np.testing.assert_allclose(m_g.numpy(), np.asarray(m_w)[..., 0],
                               atol=ATOL)
    np.testing.assert_allclose(c_g.numpy(), np.asarray(c_w), atol=ATOL)
    np.testing.assert_allclose(s_g.numpy(), np.asarray(s_w), atol=ATOL)
    for (hg, cg), (hw, cw) in zip(carry_g, carry_w):
        np.testing.assert_allclose(hg.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(hw), atol=ATOL)
        np.testing.assert_allclose(cg.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(cw), atol=ATOL)


def test_rowmajor_rejects_mul():
    decoder = RSISDecoder(hidden_size=16, num_classes=4, skip_mode="mul")
    t_skips = [torch.zeros(1, c, hh, ww) for (c, hh, ww) in GEOMS]
    with pytest.raises(ValueError):
        trm.decode_sequence_rowmajor(decoder, t_skips, 1, "mul",
                                     dtype=torch.float32)


def test_upsample_pad_matches_unpadded():
    """pad=True is the unpadded upsample with a zero halo ring (equal up to
    fp32 summation order: the products have other shapes)."""
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(2, 3, 4, 5)).astype(np.float32))
    plain = upsample_rowmajor_ref(x, 6, 10)
    padded = upsample_rowmajor_ref(x, 6, 10, pad=True)
    assert tuple(padded.shape) == (2, 8, 4, 12)
    np.testing.assert_allclose(padded[:, 1:-1, :, 1:-1].numpy(),
                               plain.numpy(), atol=1e-6)
    assert padded[:, [0, -1]].abs().max() == 0
    assert padded[..., [0, -1]].abs().max() == 0
