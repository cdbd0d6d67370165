"""Bit-parity tests: flax modules vs the torch reference architecture.

Random torch weights (reference state_dict key layout) are imported through
rsis_tpu.models.torch_import and the forwards compared. This is the harness
BASELINE.md requires for checkpoint parity (<=1e-3 mask-IoU delta); with no
downloadable pretrained weights in this environment, a faithful torch replica
(tests/torch_replica.py) stands in.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_replica as tr
from rsis_tpu.models import backbones as fb
from rsis_tpu.models import torch_import as ti
from rsis_tpu.models.decoder import RSISDecoder as FlaxDecoder
from rsis_tpu.models.encoder import FeatureExtractor as FlaxEncoder
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4


def to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def image():
    torch.manual_seed(0)
    return torch.randn(2, 3, 64, 64)


class TestResNetParity:
    def test_small_bottleneck_resnet(self, image):
        torch.manual_seed(1)
        net = tr.ResNetTaps(tr.Bottleneck, [1, 1, 1, 1]).eval()
        tr.randomize_bn_stats(net, seed=1)
        sd = net.state_dict()
        params, stats = ti.import_resnet(sd, (1, 1, 1, 1), bottleneck=True)
        fnet = fb.ResNetTaps(stage_sizes=(1, 1, 1, 1), bottleneck=True)
        with torch.no_grad():
            want = net(image)
        got = fnet.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(to_nhwc(image)), train=False)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), to_nhwc(w), atol=ATOL)

    def test_small_basic_resnet(self, image):
        torch.manual_seed(2)
        net = tr.ResNetTaps(tr.BasicBlock, [2, 2, 2, 2]).eval()
        tr.randomize_bn_stats(net, seed=2)
        params, stats = ti.import_resnet(net.state_dict(), (2, 2, 2, 2),
                                         bottleneck=False)
        fnet = fb.ResNetTaps(stage_sizes=(2, 2, 2, 2), bottleneck=False)
        with torch.no_grad():
            want = net(image)
        got = fnet.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(to_nhwc(image)), train=False)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), to_nhwc(w), atol=ATOL)


class TestVGGParity:
    def test_vgg16(self, image):
        torch.manual_seed(3)
        net = tr.VGG16Taps().eval()
        params, _ = ti.import_vgg16(net.state_dict())
        fnet = fb.VGG16Taps()
        with torch.no_grad():
            want = net(image)
        got = fnet.apply({"params": params},
                         jnp.asarray(to_nhwc(image)), train=False)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), to_nhwc(w), atol=ATOL)


class TestEncoderParity:
    def test_feature_extractor_resnet(self, image):
        torch.manual_seed(4)
        base = tr.ResNetTaps(tr.Bottleneck, [1, 1, 1, 1])
        enc = tr.FeatureExtractor(base, (2048, 1024, 512, 256, 64),
                                  hidden_size=32).eval()
        tr.randomize_bn_stats(enc, seed=4)
        enc_p, enc_s = ti.import_encoder(enc.state_dict(), "resnet101",
                                         stage_sizes=(1, 1, 1, 1))
        fenc = FlaxEncoder(base_model="resnet101", hidden_size=32)
        with torch.no_grad():
            want = enc(image)
        # our flax encoder builds resnet101 (3,4,23,3); for this test we need
        # the small stage sizes, so apply the backbone params directly
        from rsis_tpu.models.backbones import ResNetTaps as FRes
        import flax.linen as fnn

        class SmallEnc(FlaxEncoder):
            @fnn.compact
            def __call__(self, x, train=False, mode="skip"):
                base = FRes(stage_sizes=(1, 1, 1, 1), bottleneck=True,
                            dtype=self.dtype, name="base")
                taps = base(x, train=train)
                h = self.hidden_size
                widths = (h, h, h // 2, h // 4, h // 8)
                pad = (self.kernel_size - 1) // 2
                outs = []
                for i, (tap, width) in enumerate(zip(taps, widths)):
                    y = fnn.Conv(width,
                                 (self.kernel_size, self.kernel_size),
                                 padding=((pad, pad), (pad, pad)),
                                 dtype=self.dtype, name=f"sk{5 - i}")(tap)
                    y = fnn.BatchNorm(use_running_average=not train,
                                      momentum=0.9, epsilon=1e-5,
                                      dtype=self.dtype,
                                      name=f"bn{5 - i}")(y)
                    outs.append(y)
                return tuple(outs)

        fenc = SmallEnc(base_model="resnet101", hidden_size=32)
        got = fenc.apply({"params": enc_p, "batch_stats": enc_s},
                         jnp.asarray(to_nhwc(image)), train=False)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), to_nhwc(w), atol=ATOL)


class TestDecoderParity:
    def test_decoder_three_steps(self):
        torch.manual_seed(5)
        h = 32
        num_classes = 5
        dec = tr.RSISDecoder(hidden_size=h, num_classes=num_classes).eval()
        dec_p = ti.import_decoder(dec.state_dict())
        fdec = FlaxDecoder(hidden_size=h, num_classes=num_classes)

        # synthetic skip pyramid: (B, C, H, W) torch / NHWC flax
        b = 2
        geoms = [(h, 4, 4), (h, 8, 8), (h // 2, 16, 16), (h // 4, 32, 32),
                 (h // 8, 64, 64)]
        skips_t = [torch.randn(b, c, hh, ww) for (c, hh, ww) in geoms]
        skips_f = [jnp.asarray(to_nhwc(s)) for s in skips_t]

        hidden_t = None
        carry_f = None
        for step in range(3):
            with torch.no_grad():
                m_t, c_t, s_t, hidden_t = dec(skips_t, hidden_t)
            (m_f, c_f, s_f), carry_f = fdec.apply(
                {"params": dec_p}, skips_f, carry_f, train=False)
            np.testing.assert_allclose(
                np.asarray(m_f), to_nhwc(m_t), atol=ATOL,
                err_msg=f"mask mismatch at step {step}")
            np.testing.assert_allclose(
                np.asarray(c_f), c_t.detach().numpy(), atol=ATOL,
                err_msg=f"class mismatch at step {step}")
            np.testing.assert_allclose(
                np.asarray(s_f), s_t.detach().numpy(), atol=ATOL,
                err_msg=f"stop mismatch at step {step}")


class TestConvLSTMParity:
    def test_cell(self):
        torch.manual_seed(6)
        cell_t = tr.ConvLSTMCell(8, 16, 3, 1).eval()
        sd = cell_t.state_dict()
        params = {"gates": {
            "kernel": sd["Gates.weight"].numpy().transpose(2, 3, 1, 0),
            "bias": sd["Gates.bias"].numpy()}}
        from rsis_tpu.models.clstm import ConvLSTMCell as FlaxCell
        cell_f = FlaxCell(hidden=16, kernel_size=3)

        x = torch.randn(2, 8, 10, 10)
        state_t = None
        state_f = None
        for step in range(4):
            with torch.no_grad():
                h_t, c_t = cell_t(x, state_t)
                state_t = (h_t, c_t)
            h_f, state_f = cell_f.apply({"params": params},
                                        jnp.asarray(to_nhwc(x)), state_f)
            np.testing.assert_allclose(np.asarray(h_f), to_nhwc(h_t),
                                       atol=ATOL,
                                       err_msg=f"hidden step {step}")
