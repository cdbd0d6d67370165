"""The port's ``cli.verify_parity`` and its reference replica
(``rsis_tpu_torch/models/torch_ref.py``):

- on matching weights (resnet34, hidden 16, 32x64 images, T=2, ``.npz``
  exports of the replica's state_dicts, non-trivial BatchNorm statistics)
  the CLI on the CPU prints ``PARITY OK`` and returns 0, in concat and mul;
- with its weight loading broken by a monkeypatch (``conv_out``'s bias
  moved by 1) it prints ``PARITY EXCEEDED`` and returns 1, as JAX's CLI
  does (``tests/test_verify_parity_cli.py``);
- the port's replica gives outputs identical to the JAX package's
  ``rsis_tpu/models/torch_ref`` on the same state_dicts and inputs
  (resnet34 and vgg16 encoders, the decoder in every skip mode)."""

import numpy as np
import pytest
import torch

from rsis_tpu.models import torch_ref as jax_tr
from rsis_tpu_torch.cli import verify_parity
from rsis_tpu_torch.models import torch_ref as tr
from torch_threads import one_torch_thread  # noqa: F401

ARGV = ["-base_model", "resnet34", "-hidden_size", "16", "-num_classes",
        "5", "-imsize", "32", "-maxseqlen", "2", "-n_images", "1"]


def _export(sd, path):
    np.savez(path, **{k: v.detach().numpy() for k, v in sd.items()})


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(encoder.npz, decoder.npz) of the replica for each skip mode."""
    d = tmp_path_factory.mktemp("parity")
    torch.manual_seed(0)
    enc = tr.FeatureExtractor(tr.ResNetTaps(tr.BasicBlock, (3, 4, 6, 3)),
                              (512, 256, 128, 64, 64), hidden_size=16)
    tr.randomize_bn_stats(enc, seed=1)
    _export(enc.state_dict(), str(d / "enc.npz"))
    out = {}
    for skip in ("concat", "mul"):
        dec = tr.RSISDecoder(hidden_size=16, num_classes=5, skip_mode=skip)
        _export(dec.state_dict(), str(d / f"dec_{skip}.npz"))
        out[skip] = [str(d / "enc.npz"), str(d / f"dec_{skip}.npz")]
    return out


@pytest.mark.parametrize("skip", ["concat", "mul"])
def test_parity_ok_on_matching_weights(checkpoints, capsys, skip):
    rc = verify_parity.main(checkpoints[skip] + ARGV + ["-skip_mode", skip])
    out = capsys.readouterr().out
    assert "PARITY OK" in out and "device: cpu" in out, out
    assert rc == 0


def test_parity_detects_a_weight_loading_bug(checkpoints, capsys,
                                             monkeypatch):
    """Both sides read the same files, so the CLI's job is catching a
    loader or forward divergence; break the port's loading and it must
    go red."""
    orig = verify_parity.load_port_weights

    def broken(cfg, enc_sd, dec_sd):
        enc, dec = orig(cfg, enc_sd, dec_sd)
        return enc, {**dec, "conv_out.bias": dec["conv_out.bias"] + 1.0}

    monkeypatch.setattr(verify_parity, "load_port_weights", broken)
    rc = verify_parity.main(checkpoints["concat"] + ARGV)
    out = capsys.readouterr().out
    assert "PARITY EXCEEDED" in out, out
    assert rc == 1


def _pair(build):
    """The same module built from both replicas under one seed."""
    torch.manual_seed(3)
    port = build(tr)
    torch.manual_seed(3)
    ref = build(jax_tr)
    ref.load_state_dict(port.state_dict())
    return port.eval(), ref.eval()


@pytest.fixture(scope="module", params=["resnet34", "vgg16"])
def features(request):
    """Both replicas' encoder features on one input, held equal."""
    def encoder(m):
        if request.param == "vgg16":
            enc = m.FeatureExtractor(m.VGG16Taps(), (512, 512, 256, 128, 64),
                                     hidden_size=16)
        else:
            enc = m.FeatureExtractor(m.ResNetTaps(m.BasicBlock,
                                                  (3, 4, 6, 3)),
                                     (512, 256, 128, 64, 64), hidden_size=16)
        m.randomize_bn_stats(enc, seed=2)
        return enc

    enc_p, enc_r = _pair(encoder)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 3, 32, 64)).astype(np.float32))
    with torch.no_grad():
        return enc_p(x), enc_r(x)


@pytest.mark.parametrize("skip", ["concat", "sum", "mul", "none"])
def test_replica_equals_jax_replica(features, skip):
    feats_p, feats_r = features
    for a, b in zip(feats_p, feats_r):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dec_p, dec_r = _pair(lambda m: m.RSISDecoder(hidden_size=16,
                                                 num_classes=4,
                                                 skip_mode=skip))
    with torch.no_grad():
        hid_p = hid_r = None
        for _ in range(2):
            *outs_p, hid_p = dec_p(feats_p, hid_p)
            *outs_r, hid_r = dec_r(feats_r, hid_r)
            for a, b in zip(outs_p, outs_r):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
