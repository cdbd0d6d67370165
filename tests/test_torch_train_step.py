"""The port's training step against the JAX package's on shared weights.

One JAX ``make_train_step`` (tiny backbone, 64x64, B=2, T=3, N=5, hidden
16, pallas="off", fp32) is compiled once for the module. Both optimizers
are SGD with lr 1, momentum 0.9 and no decay, so the first step moves
every parameter by exactly minus its gradient, and both loss flags are on
so every loss carries gradient. The port's step (``train_state_from_jax``,
CPU, concat skips: the kernel decode with its plain versions) is held
against it:

- the four metrics at atol 1e-5;
- every updated parameter at atol 1e-4 (fp32 gradient summation order
  over 3 steps x 5 cells and the encoder);
- every updated BatchNorm statistic at atol 1e-5 (flax moves the running
  variance toward the biased batch variance, torch toward the unbiased);
- with update_encoder off, the backbone stays bit-identical while the skip
  convolutions, their BatchNorms and the decoder move as in JAX.
Also eval_step and decode_batch on the same uint8 wire batch, and the
port's synthetic wire batches against bench.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import _synthetic_wire_batch
from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu.train import step as jax_step
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.data.synthetic import synthetic_wire_batch
from rsis_tpu_torch.models.weights import (from_jax_variables,
                                           train_state_from_jax)
from rsis_tpu_torch.train import step as port_step

T = 3
JCFG = JaxConfig(base_model="tiny", hidden_size=16, num_classes=4,
                 imsize=64, maxseqlen=T, gt_maxseqlen=5, batch_size=2,
                 pallas="off", optim="sgd", optim_cnn="sgd", lr=1.0,
                 lr_cnn=1.0, momentum=0.9, weight_decay=0.0,
                 weight_decay_cnn=0.0, update_encoder=True,
                 use_class_loss=True, use_stop_loss=True)
CFG = Config(base_model="tiny", hidden_size=16, num_classes=4, imsize=64,
             maxseqlen=T, gt_maxseqlen=5, batch_size=2, optim="sgd",
             optim_cnn="sgd", lr=1.0, lr_cnn=1.0, momentum=0.9,
             weight_decay=0.0, weight_decay_cnn=0.0, update_encoder=True,
             use_class_loss=True, use_stop_loss=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """The JAX step's inputs and results, for both encoder gates."""
    # jitted: the same numbers as the eager init in a quarter of the time
    variables = _np_tree(jax.jit(lambda key: jax_rsis.init_variables(
        JCFG, key, (64, 64)))(jax.random.PRNGKey(0)))
    batch = synthetic_wire_batch(np.random.default_rng(0), 2, 64, 64, 5, 4)
    train_step, eval_step = jax_step.make_train_step(JCFG, T=T, donate=False)
    rng = jax.random.PRNGKey(1)
    out = {"variables": variables, "batch": batch}
    for gate in (1.0, 0.0):
        flags = jax_step.StepFlags(use_class_loss=jnp.float32(1),
                                   use_stop_loss=jnp.float32(1),
                                   update_encoder=jnp.float32(gate))
        state = jax_step.create_train_state(JCFG, variables)
        new, metrics = train_step(state, batch, flags, rng)
        out[gate] = (np.asarray(metrics), _np_tree(
            {"params": new.params, "batch_stats": new.batch_stats}))
    out["eval"] = np.asarray(eval_step(state, batch, flags, rng))
    return out


def _port_step(ref, gate: float):
    state = train_state_from_jax(CFG, ref["variables"], device="cpu")
    train_step, _ = port_step.make_train_step(CFG, T=T, device="cpu")
    flags = port_step.StepFlags(use_class_loss=1.0, use_stop_loss=1.0,
                                update_encoder=gate)
    before = {k: v.clone() for k, v in state.encoder.state_dict().items()}
    state, metrics = train_step(state, ref["batch"], flags)
    return before, state, metrics


def _compare_modules(state, want_vars, skip=lambda key: False):
    enc_want, dec_want = from_jax_variables(want_vars, "tiny")
    for module, want in ((state.encoder, enc_want),
                         (state.decoder, dec_want)):
        for key, got in module.state_dict().items():
            if key.endswith("num_batches_tracked") or skip(key):
                continue
            stat = key.endswith(("running_mean", "running_var"))
            np.testing.assert_allclose(
                got.numpy(), want[key].numpy(), atol=1e-5 if stat else 1e-4,
                rtol=0, err_msg=key)


def test_train_step_matches_jax(ref):
    _, state, metrics = _port_step(ref, 1.0)
    want_metrics, want_vars = ref[1.0]
    np.testing.assert_allclose(metrics.numpy(), want_metrics, atol=1e-5,
                               rtol=0)
    assert state.step == 1
    _compare_modules(state, want_vars)


def test_closed_encoder_gate_keeps_the_backbone(ref):
    before, state, metrics = _port_step(ref, 0.0)
    want_metrics, want_vars = ref[0.0]
    np.testing.assert_allclose(metrics.numpy(), want_metrics, atol=1e-5,
                               rtol=0)
    moved = 0
    for key, got in state.encoder.state_dict().items():
        if key.startswith("base."):
            assert torch.equal(got, before[key]), key
        elif key.endswith(".weight"):
            moved += not torch.equal(got, before[key])
    assert moved == 10   # sk1..sk5 and bn1..bn5
    # the skip convolutions, their BatchNorms and the decoder as in JAX
    _compare_modules(state, want_vars, skip=lambda k: k.startswith("base."))


def test_eval_step_matches_jax(ref):
    state = train_state_from_jax(CFG, ref["variables"], device="cpu")
    _, eval_step = port_step.make_train_step(CFG, T=T, device="cpu")
    flags = port_step.StepFlags.from_config(CFG)
    got = eval_step(state, ref["batch"], flags)
    np.testing.assert_allclose(got.numpy(), ref["eval"], atol=1e-5, rtol=0)


def test_decode_batch_matches_jax(ref):
    want = jax_step.decode_batch(JCFG, ref["batch"])
    got = port_step.decode_batch(CFG, ref["batch"], torch.device("cpu"))
    assert got[1].dtype == torch.uint8          # y_mask stays uint8
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_synthetic_wire_batch_matches_bench():
    got = synthetic_wire_batch(np.random.default_rng(5), 3, 32, 64, 6, 9)
    want = _synthetic_wire_batch(np.random.default_rng(5), 3, 32, 64, 6, 9)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
