"""Cases of the port against the JAX package that no other test holds: the
forward with ``sum`` and ``none`` skips, the train step with ``mul`` and
``sum`` skips, and the train step with Adam for the decoder and RMSprop
for the encoder.

The setup is ``tests/test_torch_train_step.py``'s (tiny backbone, 64x64,
B=2, T=3, N=5, hidden 16, pallas="off", fp32, weights from JAX's init):

- the forwards (``make_forward(..., device="cpu")`` against
  ``rsis.forward``) within 6e-8, a float32 ulp of the [0.5, 1) outputs;
- the train steps with SGD lr 1 (the first step moves each parameter by
  minus its gradient) within 1.2e-7 on the metrics, the parameters and
  the BatchNorm statistics;
- Adam (decoder) and RMSprop (encoder), lr 1e-3, weight decay 1e-4, the
  encoder updated: every parameter within 3e-6, except the skip
  convolutions' biases ``sk1-5.bias``. BatchNorm follows those convs, so
  their true gradient is zero and both packages return rounding noise
  there, which Adam and RMSprop scale to about lr: they are held within
  lr of JAX's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu.train import step as jax_step
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.data.synthetic import synthetic_wire_batch
from rsis_tpu_torch.evals.forward import make_forward
from rsis_tpu_torch.models.weights import (from_jax_variables,
                                           train_state_from_jax)
from rsis_tpu_torch.train import step as port_step
from torch_threads import one_torch_thread  # noqa: F401

T = 3
SGD = dict(base_model="tiny", hidden_size=16, num_classes=4, imsize=64,
           maxseqlen=T, gt_maxseqlen=5, batch_size=2, optim="sgd",
           optim_cnn="sgd", lr=1.0, lr_cnn=1.0, momentum=0.9,
           weight_decay=0.0, weight_decay_cnn=0.0, update_encoder=True,
           use_class_loss=True, use_stop_loss=True)
ADAM_RMSPROP = dict(SGD, optim="adam", optim_cnn="rmsprop", lr=1e-3,
                    lr_cnn=1e-3, weight_decay=1e-4, weight_decay_cnn=1e-4)


@functools.lru_cache(maxsize=None)
def _init(concat: bool):
    """JAX's initial variables; only concat skips change their shapes,
    so one init serves sum, none and mul."""
    jcfg = JaxConfig(base_model="tiny", hidden_size=16, num_classes=4,
                     skip_mode="concat" if concat else "sum")
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_rsis.init_variables(jcfg, key, (64, 64)))(
            jax.random.PRNGKey(0)))


def _variables(jcfg):
    return _init(jcfg.skip_mode == "concat")


def _port_config(jcfg) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: getattr(jcfg, k) for k in fields})


@pytest.mark.parametrize("skip_mode", ["sum", "none"])
def test_forward_matches_jax(skip_mode):
    jcfg = JaxConfig(base_model="tiny", hidden_size=16, num_classes=4,
                     maxseqlen=T, skip_mode=skip_mode, pallas="off")
    v = _variables(jcfg)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jax_rsis.forward(jcfg, v, x, T=T))(v, x)
    got = make_forward(_port_config(jcfg), device="cpu")(
        from_jax_variables(v, "tiny"), x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=6e-8,
                                   rtol=0)


def _steps(cfg_kw, skip_mode):
    """(JAX's metrics and new variables, the port's metrics and state)
    after one step from the same weights and wire batch."""
    jcfg = JaxConfig(**cfg_kw, skip_mode=skip_mode, pallas="off")
    v = _variables(jcfg)
    batch = synthetic_wire_batch(np.random.default_rng(0), 2, 64, 64, 5, 4)
    flags = jax_step.StepFlags(use_class_loss=jnp.float32(1),
                               use_stop_loss=jnp.float32(1),
                               update_encoder=jnp.float32(1))
    train_step, _ = jax_step.make_train_step(jcfg, T=T, donate=False)
    new, metrics = train_step(jax_step.create_train_state(jcfg, v), batch,
                              flags, jax.random.PRNGKey(1))
    want = jax.tree.map(np.asarray, {"params": new.params,
                                     "batch_stats": new.batch_stats})
    cfg = _port_config(jcfg)
    state = train_state_from_jax(cfg, v, device="cpu")
    port_train, _ = port_step.make_train_step(cfg, T=T, device="cpu")
    state, got = port_train(state, batch, port_step.StepFlags(1.0, 1.0, 1.0))
    return np.asarray(metrics), want, got.numpy(), state


def _deltas(state, want_vars):
    enc, dec = from_jax_variables(want_vars, "tiny")
    out = {}
    for prefix, module, want in (("encoder", state.encoder, enc),
                                 ("decoder", state.decoder, dec)):
        for key, got in module.state_dict().items():
            if not key.endswith("num_batches_tracked"):
                out[f"{prefix}.{key}"] = float(np.abs(
                    got.numpy() - want[key].numpy()).max())
    return out


@pytest.mark.parametrize("skip_mode", ["mul", "sum"])
def test_train_step_matches_jax(skip_mode):
    want_metrics, want_vars, metrics, state = _steps(SGD, skip_mode)
    np.testing.assert_allclose(metrics, want_metrics, atol=1.2e-7, rtol=0)
    deltas = _deltas(state, want_vars)
    assert len(deltas) > 40
    assert {k: d for k, d in deltas.items() if d > 1.2e-7} == {}


def test_adam_decoder_rmsprop_encoder_match_jax():
    want_metrics, want_vars, metrics, state = _steps(ADAM_RMSPROP, "concat")
    np.testing.assert_allclose(metrics, want_metrics, atol=1.2e-7, rtol=0)
    deltas = _deltas(state, want_vars)
    noise = {f"encoder.sk{i}.bias" for i in range(1, 6)}
    assert noise <= deltas.keys()
    assert {k: d for k, d in deltas.items()
            if k not in noise and d > 3e-6} == {}
    assert {k: deltas[k] for k in noise if deltas[k] > 1e-3} == {}
