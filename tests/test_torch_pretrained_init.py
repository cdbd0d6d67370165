"""The port's pretrained-encoder import (``-torch_encoder``,
``rsis_tpu_torch/models/torch_import.py``) against the JAX package's
``init_encoder_from_torch``:

- a seeded torchvision-layout resnet34 file (with its ``fc.*``
  classifier), as ``.pth`` and as ``.npz``: the JAX result, mapped by
  ``from_jax_variables``, equals the port's exactly, the skip heads keep
  the fresh init, and the input state_dict is not mutated;
- the reference ``encoder.pt`` layout (the whole encoder replaced) and a
  DataParallel ``module.`` prefix give JAX's result exactly too;
- ``tiny`` raises, as in JAX; a file that does not fit raises (strict);
- a torchvision-layout VGG-16 file (``features.*`` plus ``classifier.*``
  keys): the import equals JAX's exactly, and the port's encoder after
  import matches the flax encoder at the five scales within 2.0e-6;
- one port ``Trainer`` run (resnet34, 32x32, B=2, 1 epoch,
  ``finetune_after=-1`` so the encoder stays frozen) from the file: every
  backbone parameter after training equals the file's exactly, and the
  run printed ``Encoder initialized from``."""

import jax
import numpy as np
import pytest
import torch

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu.models import torch_import as jax_ti
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.models import torch_import as ti
from rsis_tpu_torch.models.backbones import resnet34, vgg16
from rsis_tpu_torch.models.encoder import FeatureExtractor
from rsis_tpu_torch.models.weights import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

HW = (32, 32)


def _jax_variables(base_model):
    """A JAX variables pytree of the model's structure (``eval_shape``: no
    init is compiled) holding seeded values, BatchNorm variances
    positive."""
    jcfg = JaxConfig(base_model=base_model, hidden_size=16, num_classes=3)
    shapes = jax.eval_shape(lambda k: jax_rsis.init_variables(jcfg, k, HW),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)

    def fill(path, s):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)
    return jcfg, jax.tree_util.tree_map_with_path(fill, shapes)


def _random_bn_stats(module, seed):
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                             generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=g) + 0.5)


def _torchvision_resnet34():
    """A torchvision resnet34 state_dict: the port's trunk under a seed,
    non-trivial BatchNorm statistics, and the ImageNet classifier."""
    torch.manual_seed(0)
    trunk = resnet34()
    _random_bn_stats(trunk, 1)
    sd = dict(trunk.state_dict())
    sd["fc.weight"] = torch.randn(1000, 512)
    sd["fc.bias"] = torch.randn(1000)
    return sd


@pytest.fixture(scope="module")
def r34(tmp_path_factory):
    d = tmp_path_factory.mktemp("r34")
    sd = _torchvision_resnet34()
    paths = {"pth": str(d / "resnet34.pth"), "npz": str(d / "resnet34.npz"),
             "module": str(d / "resnet34_dp.pth"),
             "encoder": str(d / "encoder.pt")}
    torch.save(sd, paths["pth"])
    np.savez(paths["npz"], **{k: v.numpy() for k, v in sd.items()})
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               paths["module"])
    torch.manual_seed(2)
    enc = FeatureExtractor("resnet34", hidden_size=16)
    _random_bn_stats(enc, 3)
    torch.save(enc.state_dict(), paths["encoder"])
    jcfg, variables = _jax_variables("resnet34")
    return sd, paths, variables, enc.state_dict()


def _both(path, base_model, variables):
    """(port's merged encoder state_dict, JAX's, mapped to the port)."""
    fresh = from_jax_variables(variables, base_model)[0]
    got = ti.init_encoder_from_torch(path, base_model, fresh)
    want = from_jax_variables(jax_ti.init_encoder_from_torch(
        path, base_model, variables), base_model)[0]
    return fresh, got, want


def _assert_sd_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


@pytest.mark.parametrize("fmt", ["pth", "npz", "module"])
def test_torchvision_resnet34_equals_jax(r34, fmt):
    sd, paths, variables, _ = r34
    fresh, got, want = _both(paths[fmt], "resnet34", variables)
    before = {k: v.clone() for k, v in fresh.items()}
    _assert_sd_equal(got, want)
    torch.testing.assert_close(got["base.conv1.weight"], sd["conv1.weight"],
                               rtol=0, atol=0)
    torch.testing.assert_close(got["base.layer4.2.bn2.running_var"],
                               sd["layer4.2.bn2.running_var"], rtol=0,
                               atol=0)
    for k in fresh:
        if not k.startswith("base."):            # the skip heads stay fresh
            assert got[k] is fresh[k], k
        torch.testing.assert_close(fresh[k], before[k], rtol=0, atol=0)
    _ = ti.init_encoder_from_torch(paths[fmt], "resnet34", fresh)
    for k in fresh:                               # the input is not mutated
        torch.testing.assert_close(fresh[k], before[k], rtol=0, atol=0)


def test_reference_encoder_layout_equals_jax(r34):
    _, paths, variables, enc_sd = r34
    _, got, want = _both(paths["encoder"], "resnet34", variables)
    _assert_sd_equal(got, want)
    for k, v in enc_sd.items():                   # the whole encoder
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_tiny_and_misfits_raise(r34, tmp_path):
    sd, paths, variables, _ = r34
    with pytest.raises(ValueError, match="base_model"):
        jax_ti.init_encoder_from_torch(paths["npz"], "tiny", variables)
    with pytest.raises(ValueError, match="base_model"):
        ti.init_encoder_from_torch(paths["npz"], "tiny", {})
    fresh = from_jax_variables(variables, "resnet34")[0]
    broken = [
        ({k: v for k, v in sd.items() if k != "layer1.0.conv1.weight"},
         r"missing keys \['layer1.0.conv1.weight'\]"),
        ({**sd, "layer5.0.conv1.weight": sd["conv1.weight"]},
         r"unexpected keys \['layer5.0.conv1.weight'\]"),
        ({**sd, "conv1.weight": sd["conv1.weight"][:, :2]},
         r"conv1.weight has shape \(64, 2, 7, 7\)")]
    for i, (bad, message) in enumerate(broken):
        path = str(tmp_path / f"bad{i}.pth")
        torch.save(bad, path)
        with pytest.raises(ValueError, match=message):
            ti.init_encoder_from_torch(path, "resnet34", fresh)
    # resnet34 weights do not fit resnet50's trunk
    fresh50 = {f"base.{k}": v for k, v in
               FeatureExtractor("resnet50", 16).base.state_dict().items()}
    with pytest.raises(ValueError):
        ti.init_encoder_from_torch(paths["pth"], "resnet50", fresh50)


def test_vgg16_equals_jax_and_matches_flax_encoder(tmp_path):
    torch.manual_seed(4)
    sd = dict(vgg16().state_dict())
    # torchvision's classifier keys; the import never reads them, so
    # small stand-ins of the same names do
    for i in (0, 3, 6):
        sd[f"classifier.{i}.weight"] = torch.randn(10, 8)
        sd[f"classifier.{i}.bias"] = torch.randn(10)
    path = str(tmp_path / "vgg16.pth")
    torch.save(sd, path)
    jcfg, variables = _jax_variables("vgg16")
    _, got, want = _both(path, "vgg16", variables)
    _assert_sd_equal(got, want)

    merged = jax_ti.init_encoder_from_torch(path, "vgg16", variables)
    x = np.random.default_rng(5).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    jenc, _ = jax_rsis.build_models(jcfg)
    flax_out = jax.jit(lambda v, x: jenc.apply(v, x, train=False))(
        {"params": merged["params"]["encoder"],
         "batch_stats": merged["batch_stats"]["encoder"]}, x)
    encoder = FeatureExtractor("vgg16", hidden_size=16).eval()
    encoder.load_state_dict(got)
    with torch.inference_mode():
        port_out = encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(port_out) == 5
    for g, w in zip(port_out, flax_out):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=0, atol=2.0e-6)


def test_trainer_starts_from_the_file_and_keeps_it_frozen(r34, tmp_path,
                                                          capsys):
    from rsis_tpu_torch.train.loop import Trainer
    sd, paths, _, _ = r34
    cfg = Config(dataset="synthetic", base_model="resnet34", hidden_size=16,
                 num_classes=3, imsize=32, maxseqlen=2, gt_maxseqlen=3,
                 batch_size=2, resize=True, max_epoch=1, print_every=1,
                 models_root=str(tmp_path), model_name="pretrained",
                 log_term=True, num_workers=0, synthetic_length=2,
                 finetune_after=-1, torch_encoder=paths["npz"])
    state = Trainer(cfg, device="cpu").run()
    assert f"Encoder initialized from {paths['npz']}" in \
        capsys.readouterr().out
    assert state.step == 1
    base = dict(state.encoder.base.named_parameters())
    assert len(base) == 108
    for k, p in base.items():
        torch.testing.assert_close(p.detach(), sd[k], rtol=0, atol=0,
                                   msg=k)
