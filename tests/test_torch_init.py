"""A fresh port model against the JAX package's fresh model.

``models/rsis.init_weights`` is the port's ``init_variables``: flax draws
every conv and dense kernel from ``lecun_normal`` (a normal truncated to
two standard deviations, variance 1 / fan_in) and sets every bias to 0,
because no JAX module sets ``kernel_init`` or ``bias_init``. For the
tiny, resnet34, resnet50 and vgg16 trunks (hidden 16, 5 classes, 32x32)
the port's fresh state_dicts and JAX's ``init_variables`` carried across
(``from_jax_variables``):

- have the same keys and shapes;
- have every bias exactly 0 and BatchNorm at weight 1, bias 0, running
  mean 0, running var 1;
- every kernel of at least 4096 entries has a standard deviation within
  5% of sqrt(1 / fan_in) in both (at 4096 entries the sampling error of
  the std is about 1.1%);
- every port kernel entry lies within 2 sqrt(1 / fan_in) / 0.8796 (the
  truncation);
- the same seed gives identical tensors twice, and the global torch
  generator is neither read nor advanced.

The draws are equal in distribution, not sample by sample: JAX draws from
threefry, the port from a torch CPU generator."""

import math

import jax
import numpy as np
import pytest
import torch

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.models.rsis import TRUNCATED_NORMAL_STD, init_weights
from rsis_tpu_torch.models.weights import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

BACKBONES = ("tiny", "resnet34", "resnet50", "vgg16")
KW = dict(hidden_size=16, num_classes=5, imsize=32)
STD_REL_TOL = 0.05
MIN_ENTRIES = 4096


@pytest.fixture(scope="module", params=BACKBONES)
def fresh(request):
    """(base_model, port state_dicts, JAX state_dicts)."""
    base = request.param
    # jitted (eager init costs more in op-by-op compiles), compiled with
    # XLA's cheaper passes: the program runs once
    key = jax.random.PRNGKey(0)
    init = jax.jit(lambda k: jax_rsis.init_variables(
        JaxConfig(base_model=base, **KW), k, (32, 32))).lower(key).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    variables = jax.tree.map(np.asarray, init(key))
    port = init_weights(Config(base_model=base, **KW),
                        torch.Generator().manual_seed(0))
    return base, port, from_jax_variables(variables, base)


def _items(sds):
    for sd in sds:
        yield from sd.items()


def _kernels(sds):
    """(key, weight, fan_in) of every conv and linear weight."""
    for k, v in _items(sds):
        if k.endswith(".weight") and v.dim() >= 2:
            yield k, v, v[0].numel()


def test_same_keys_and_shapes(fresh):
    _, port, jax_sd = fresh
    for got, want in zip(port, jax_sd):
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.shape == want[k].shape, k
            assert v.dtype == want[k].dtype, k


def test_biases_zero_and_batchnorm_identity(fresh):
    _, port, jax_sd = fresh
    for sds in (port, jax_sd):
        n_bias = n_bn = 0
        for k, v in _items(sds):
            if k.endswith(".bias"):
                assert not v.any(), k
                n_bias += 1
            elif k.endswith(".weight") and v.dim() == 1:
                assert torch.equal(v, torch.ones_like(v)), k
                n_bn += 1
            elif k.endswith(".running_mean"):
                assert not v.any(), k
            elif k.endswith(".running_var"):
                assert torch.equal(v, torch.ones_like(v)), k
        assert n_bias >= 7 and n_bn >= 5     # sk1-5/bn1-5, conv_out, fcs


def test_kernel_std_is_lecun_normal_in_both(fresh):
    _, port, jax_sd = fresh
    for name, sds in (("port", port), ("jax", jax_sd)):
        checked = 0
        for k, v, fan_in in _kernels(sds):
            if v.numel() < MIN_ENTRIES:
                continue
            want = math.sqrt(1.0 / fan_in)
            got = v.double().std().item()
            assert abs(got / want - 1) < STD_REL_TOL, (name, k, got, want)
            assert abs(v.double().mean().item()) < 0.05 * want, (name, k)
            checked += 1
        assert checked >= 5, name


def test_port_kernels_within_the_truncation(fresh):
    _, port, _ = fresh
    for k, v, fan_in in _kernels(port):
        bound = 2.0 * math.sqrt(1.0 / fan_in) / TRUNCATED_NORMAL_STD
        assert v.abs().max().item() <= bound * (1 + 1e-6), k


def test_same_seed_same_tensors_and_the_global_seed_untouched(fresh):
    base, port, _ = fresh
    cfg = Config(base_model=base, **KW)
    before = torch.random.get_rng_state()
    again = init_weights(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(torch.random.get_rng_state(), before)
    for x, y in zip(port, again):
        assert list(x) == list(y)
        assert all(torch.equal(x[k], y[k]) for k in x)
    other = init_weights(cfg, torch.Generator().manual_seed(1))
    assert not torch.equal(port[1]["fc_class.weight"],
                           other[1]["fc_class.weight"])
