"""The port's train step learns: the counterpart of
``tests/test_learning.py``.

JAX's configuration (tiny backbone, hidden 16, 3 classes, 32x32, B=4,
T=4, gt_maxseqlen 6, fp32, lr 1e-2, lr_cnn 3e-3, adam, all three step
flags on) overfits one fixed synthetic batch for 200 port steps on the
CPU, and JAX's two limits hold: the mean of the last 3 losses is below
0.4 x the mean of the first 3, and the SBD of the thresholded
predictions against the training masks is above 0.5. Both from JAX's
``init_variables(PRNGKey(0))`` carried across and from the port's own
``init_weights``. Over the first 5 steps from the carried weights the
port's losses are within 1e-4 of JAX's ``make_train_step``
(``pallas="off"``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu.train import step as jax_step
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.data.base import normalize_image, unpack_target
from rsis_tpu_torch.data.catalogs import SyntheticBlobs
from rsis_tpu_torch.data.pipeline import DataLoader
from rsis_tpu_torch.evals.cvppp import evaluate_batch
from rsis_tpu_torch.models.rsis import build_models, forward, init_weights
from rsis_tpu_torch.models.weights import from_jax_variables
from rsis_tpu_torch.train import step as port_step
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 200
PARITY_STEPS = 5
KW = dict(dataset="synthetic", base_model="tiny", hidden_size=16,
          num_classes=3, imsize=32, maxseqlen=4, gt_maxseqlen=6,
          batch_size=4, resize=True, lr=1e-2, lr_cnn=3e-3,
          update_encoder=True, compute_dtype="float32")
CFG = Config(**KW)


@pytest.fixture(scope="module")
def batch():
    """One fixed uint8 wire batch (image, packed target) of the train
    split."""
    ds = SyntheticBlobs(CFG, split="train", imsize=CFG.imsize,
                        length=CFG.batch_size)
    loader = DataLoader(ds, batch_size=CFG.batch_size, shuffle=False,
                        num_workers=1, seed=0)
    return next(iter(loader))


@pytest.fixture(scope="module")
def jax_variables():
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_rsis.init_variables(JaxConfig(**KW), key))(
        jax.random.PRNGKey(0)))


def _train(weights, batch, steps):
    state = port_step.create_train_state(CFG, weights, device="cpu")
    train_step, _ = port_step.make_train_step(CFG, device="cpu")
    flags = port_step.StepFlags(use_class_loss=1.0, use_stop_loss=1.0,
                                update_encoder=1.0)
    losses = []
    for _ in range(steps):
        state, metrics = train_step(state, batch, flags)
        losses.append(metrics[0].item())
    return state, np.array(losses)


def _instance_labels(masks, stops, thr=0.5):
    """(T, H, W) sigmoid masks and (T,) objectness -> one label map; later
    instances paint over earlier ones where confident (test_learning's)."""
    lab = np.zeros(masks.shape[1:], np.int32)
    for t in range(masks.shape[0]):
        if stops[t] < 0.5:
            break
        lab[masks[t] > thr] = t + 1
    return lab


def _sbd(state, batch):
    img, tgt = batch
    encoder, decoder = build_models(CFG)
    encoder.load_state_dict(state.encoder.state_dict())
    decoder.load_state_dict(state.decoder.state_dict())
    x = torch.from_numpy(normalize_image(img)).permute(0, 3, 1, 2)
    masks, _, stops = (t.numpy() for t in forward(CFG, encoder, decoder, x))
    y_mask, _, sw_mask, _ = unpack_target(tgt)
    h = w = CFG.imsize
    preds, gts = [], []
    for b in range(CFG.batch_size):
        preds.append(_instance_labels(masks[b], stops[b, :, 0]))
        gt = np.zeros((h, w), np.int32)
        for t in range(y_mask.shape[1]):
            if sw_mask[b, t] > 0:
                gt[y_mask[b, t].reshape(h, w) > 0.5] = t + 1
        gts.append(gt)
    return evaluate_batch(preds, gts)


@pytest.mark.parametrize("start", ["jax_init", "port_init"])
def test_overfit_one_batch_loss_drops_and_sbd_rises(start, batch,
                                                    jax_variables):
    weights = (from_jax_variables(jax_variables, "tiny")
               if start == "jax_init"
               else init_weights(CFG, torch.Generator().manual_seed(0)))
    state, losses = _train(weights, batch, STEPS)
    first, last = losses[:3].mean(), losses[-3:].mean()
    assert np.isfinite(losses).all(), losses
    assert last < 0.4 * first, (first, last, losses[::10])
    res = _sbd(state, batch)
    assert res["SBD"] > 0.5, res


def test_first_losses_match_jax(batch, jax_variables):
    jcfg = JaxConfig(**KW, pallas="off")
    state = jax_step.create_train_state(jcfg, jax_variables)
    train_step, _ = jax_step.make_train_step(jcfg, donate=False)
    flags = jax_step.StepFlags(use_class_loss=jnp.float32(1),
                               use_stop_loss=jnp.float32(1),
                               update_encoder=jnp.float32(1))
    want = []
    for i in range(PARITY_STEPS):
        state, metrics = train_step(state, batch, flags,
                                    jax.random.PRNGKey(100 + i))
        want.append(float(metrics[0]))
    _, got = _train(from_jax_variables(jax_variables, "tiny"), batch,
                    PARITY_STEPS)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
