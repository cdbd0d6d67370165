"""The port's inference slice against the JAX package on shared weights.

- the whole forward: rsis_tpu_torch make_forward(cfg, device="cpu")
  against JAX rsis.forward (pallas="off"), tiny backbone at 64x64, hidden
  16, T=3; "concat" goes through the port's kernel decode, "mul" and
  5x5 convolutions through its plain decode. atol 1e-4: fp32 summation
  order over 5 cells x 3 steps;
- encoder parity for resnet34 / resnet50 at 64x64, B=1, with randomised
  BatchNorm statistics. atol 2e-4, as tests/test_torch_parity.py: fp32
  convolutions over up to 50 layers;
- resnet101: models/weights.py on jax.eval_shape shapes gives exactly the
  keys and shapes of the port's modules;
- the round trip port state_dict -> rsis_tpu torch_import -> the JAX
  variables, exactly.
Weights come from JAX init; inputs from a numpy seed. The JAX init and
forward run jitted: the same numbers as eager execution, compiled once
instead of op by op."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu.models.torch_import import import_reference_checkpoint
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.evals.forward import make_forward
from rsis_tpu_torch.models.rsis import build_models
from rsis_tpu_torch.models.weights import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401


_INITS = {}


def _jax_variables(cfg, hw, seed=0):
    """JAX init with randomised BatchNorm statistics (numpy leaves). The
    jitted init is kept per configuration, so seeds share one compile."""
    key = (repr(cfg), hw)
    if key not in _INITS:
        _INITS[key] = jax.jit(
            lambda k: jax_rsis.init_variables(cfg, k, hw))
    v = jax.tree.map(np.asarray, _INITS[key](jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "mean":
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=leaf.shape).astype(np.float32)
        return leaf

    v["batch_stats"] = jax.tree_util.tree_map_with_path(perturb,
                                                        v["batch_stats"])
    return v


def _port_config(jcfg):
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: getattr(jcfg, k) for k in fields})


@pytest.mark.parametrize("skip_mode,kernel_size", [
    ("concat", 3),   # the kernel decode
    ("mul", 3),      # the plain decode
    ("concat", 5),   # the plain decode: the kernels pack 3x3 convs
])
def test_forward_matches_jax(skip_mode, kernel_size):
    jcfg = JaxConfig(base_model="tiny", hidden_size=16, num_classes=4,
                     maxseqlen=3, skip_mode=skip_mode,
                     kernel_size=kernel_size, pallas="off")
    v = _jax_variables(jcfg, (64, 64))
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jax_rsis.forward(jcfg, v, x, T=3))(v, x)
    fn = make_forward(_port_config(jcfg), device="cpu")
    got = fn(from_jax_variables(v, "tiny"), x)
    assert [tuple(g.shape) for g in got] == [(2, 3, 64, 64), (2, 3, 4),
                                            (2, 3, 1)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("base_model", ["resnet34", "resnet50"])
def test_encoder_matches_jax(base_model):
    jcfg = JaxConfig(base_model=base_model, hidden_size=16)
    v = _jax_variables(jcfg, (64, 64))
    x = np.random.default_rng(2).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    jenc, _ = jax_rsis.build_models(jcfg)
    want = jax.jit(lambda enc_vars, x: jenc.apply(enc_vars, x, train=False))(
        {"params": v["params"]["encoder"],
         "batch_stats": v["batch_stats"]["encoder"]}, x)
    encoder, _ = build_models(_port_config(jcfg))
    encoder.load_state_dict(from_jax_variables(v, base_model)[0])
    with torch.inference_mode():
        got = encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=2e-4)


def test_resnet101_state_dict_layout():
    jcfg = JaxConfig(base_model="resnet101", hidden_size=128, num_classes=9)
    shapes = jax.eval_shape(lambda k: jax_rsis.init_variables(
        jcfg, k, (64, 64)), jax.random.PRNGKey(0))
    v = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    enc_sd, dec_sd = from_jax_variables(v, "resnet101")
    encoder, decoder = build_models(_port_config(jcfg))
    for got, module in ((enc_sd, encoder), (dec_sd, decoder)):
        want = module.state_dict()
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k


def test_round_trip_through_torch_import():
    # the configuration of test_encoder_matches_jax[resnet34]: one compile
    jcfg = JaxConfig(base_model="resnet34", hidden_size=16)
    v = _jax_variables(jcfg, (64, 64), seed=3)
    encoder, decoder = build_models(_port_config(jcfg))
    enc_sd, dec_sd = from_jax_variables(v, "resnet34")
    encoder.load_state_dict(enc_sd)
    decoder.load_state_dict(dec_sd)
    back = import_reference_checkpoint(encoder.state_dict(),
                                       decoder.state_dict(), "resnet34")
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = jax.tree_util.tree_leaves_with_path(v)
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (path, got), (_, want) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(got, want, err_msg=str(path))
