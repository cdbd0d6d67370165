"""Parity check of the port's forward against a replica of the reference.

``python -m rsis_tpu_torch.cli.verify_parity encoder.pt decoder.pt``

Counterpart of ``rsis_tpu/cli/verify_parity.py``, with the same flags. It
loads reference-format checkpoints (torch state_dicts, ``.pt``/``.pth``,
or ``.npz`` exports) through ``models/torch_import.py`` and runs the
reference inference forward (encoder, T fixed decode steps, bilinear
upsample, sigmoid) twice on the same images: through the port
(``evals/forward.make_forward``, its kernels included on the card) and
through ``models/torch_ref.py``, a plain-torch replica of the reference
architecture that shares no code with it. It prints the mean mask-IoU
delta, the largest mask, class and stop deltas, and exits 1 when the
delta is above ``-budget`` (1e-3).

Both run in float32 with exact fp32 products (no TF32) on the CPU, or
with ``--device`` on the card (CUDA; without a card it raises, it does
not fall back to the CPU).

Images: seeded random RGB by default; ``-images DIR`` takes the .png and
.jpg files of a directory.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..evals.forward import make_forward
from ..models import torch_ref as tr
from ..models.rsis import build_models
from ..models.torch_import import (load_state_dict_file, merge_encoder_state,
                                   strip_parallel_prefix)

_STAGES = {"resnet34": (3, 4, 6, 3), "resnet50": (3, 4, 6, 3),
           "resnet101": (3, 4, 23, 3)}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="verify_parity",
        description="mean mask-IoU delta of rsis_tpu_torch vs the "
                    "reference replica")
    p.add_argument("encoder", help="encoder.pt / .pth / .npz state_dict")
    p.add_argument("decoder", help="decoder.pt / .pth / .npz state_dict")
    p.add_argument("-base_model", default="resnet101",
                   choices=["resnet34", "resnet50", "resnet101", "vgg16"])
    p.add_argument("-hidden_size", type=int, default=128)
    p.add_argument("-num_classes", type=int, default=21)
    p.add_argument("-kernel_size", type=int, default=3)
    p.add_argument("-skip_mode", default="concat")
    p.add_argument("-maxseqlen", type=int, default=10)
    p.add_argument("-imsize", type=int, default=256)
    p.add_argument("-imsize_w", type=int, default=0,
                   help="width (default 2*imsize like cityscapes eval)")
    p.add_argument("-n_images", type=int, default=2)
    p.add_argument("-budget", type=float, default=1e-3,
                   help="max allowed mean mask-IoU delta")
    p.add_argument("-images", default="",
                   help="directory of images instead of synthetic inputs")
    p.add_argument("--device", action="store_true",
                   help="run both forwards on the card instead of the CPU")
    return p


def _load_images(args) -> np.ndarray:
    """(n_images, H, W, 3) float32, normalised with ImageNet statistics."""
    h = args.imsize
    w = args.imsize_w or 2 * args.imsize
    if args.images:
        from PIL import Image
        files = sorted(
            f for f in os.listdir(args.images)
            if f.lower().endswith((".png", ".jpg", ".jpeg")))[:args.n_images]
        if not files:
            raise SystemExit(f"no images found in {args.images}")
        imgs = []
        for f in files:
            with Image.open(os.path.join(args.images, f)) as im:
                imgs.append(np.asarray(im.convert("RGB").resize(
                    (w, h), Image.BILINEAR), dtype=np.uint8))
        raw = np.stack(imgs)
    else:
        rng = np.random.default_rng(0)
        raw = rng.integers(0, 255, (args.n_images, h, w, 3), dtype=np.uint8)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return ((raw.astype(np.float32) / 255.0) - mean) / std


def load_port_weights(cfg: Config, enc_sd, dec_sd):
    """(encoder, decoder) state_dicts of the port's modules from the
    reference-format dicts: the encoder through ``merge_encoder_state``
    (strict), the decoder as it is."""
    with torch.random.fork_rng(devices=[]):
        encoder, _ = build_models(cfg)
    enc = merge_encoder_state(enc_sd, cfg.base_model, encoder.state_dict())
    dec = {k: torch.as_tensor(v)
           for k, v in strip_parallel_prefix(dec_sd).items()}
    return enc, dec


def _replica_forward(args, enc_sd, dec_sd, x_nhwc: np.ndarray, device):
    """The reference's test-time forward through the replica."""
    if args.base_model == "vgg16":
        base = tr.VGG16Taps()
        skip_dims = (512, 512, 256, 128, 64)
    else:
        block = (tr.BasicBlock if args.base_model == "resnet34"
                 else tr.Bottleneck)
        base = tr.ResNetTaps(block, _STAGES[args.base_model])
        mult = 1 if args.base_model == "resnet34" else 4
        skip_dims = (512 * mult, 256 * mult, 128 * mult, 64 * mult, 64)
    enc = tr.FeatureExtractor(base, skip_dims, args.hidden_size,
                              args.kernel_size).eval()
    dec = tr.RSISDecoder(args.hidden_size, args.num_classes,
                         args.kernel_size, args.skip_mode).eval()
    enc.load_state_dict({k: torch.as_tensor(v) for k, v in
                         strip_parallel_prefix(enc_sd).items()})
    dec.load_state_dict({k: torch.as_tensor(v) for k, v in
                         strip_parallel_prefix(dec_sd).items()})
    enc, dec = enc.to(device), dec.to(device)

    x = torch.from_numpy(np.ascontiguousarray(
        x_nhwc.transpose(0, 3, 1, 2))).to(device)
    masks, clss, stops = [], [], []
    with torch.no_grad():
        feats = enc(x)
        hidden = None
        for _ in range(args.maxseqlen):
            m, c, s, hidden = dec(feats, hidden)
            m = torch.nn.functional.interpolate(
                m, size=x.shape[-2:], mode="bilinear", align_corners=True)
            masks.append(torch.sigmoid(m[:, 0]))
            clss.append(c)
            stops.append(torch.sigmoid(s))
    return tuple(torch.stack(t, 1).cpu().numpy()
                 for t in (masks, clss, stops))


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = resolve_device(None if args.device else "cpu", "verify_parity")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    # exact fp32 products on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(args, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _run(args, device) -> int:
    enc_sd = load_state_dict_file(args.encoder)
    dec_sd = load_state_dict_file(args.decoder)
    cfg = Config(base_model=args.base_model, hidden_size=args.hidden_size,
                 num_classes=args.num_classes, kernel_size=args.kernel_size,
                 skip_mode=args.skip_mode, maxseqlen=args.maxseqlen,
                 imsize=args.imsize, compute_dtype="float32")
    weights = load_port_weights(cfg, enc_sd, dec_sd)

    x = _load_images(args)
    print(f"images: {x.shape}  device: {device}", flush=True)

    fwd = make_forward(cfg, T=args.maxseqlen, device=device)
    m_p, c_p, s_p = (t.float().cpu().numpy() for t in fwd(weights, x))
    m_t, c_t, s_t = _replica_forward(args, enc_sd, dec_sd, x, device)

    # mean mask-IoU delta: 1 - softIoU(port mask, replica mask), averaged
    # over every (image, step) pair
    mp = m_p.reshape(m_p.shape[0], m_p.shape[1], -1).astype(np.float64)
    mt = m_t.reshape(m_t.shape[0], m_t.shape[1], -1).astype(np.float64)
    inter = np.minimum(mp, mt).sum(-1)
    union = np.maximum(mp, mt).sum(-1) + 1e-9
    iou_delta = float(np.mean(1.0 - inter / union))

    print(f"mean mask-IoU delta : {iou_delta:.3e}  (budget {args.budget:g})")
    print(f"max |mask delta|    : {np.abs(m_p - m_t).max():.3e}")
    print(f"max |class delta|   : {np.abs(c_p - c_t).max():.3e}")
    print(f"max |stop delta|    : {np.abs(s_p - s_t).max():.3e}")
    ok = iou_delta <= args.budget
    print("PARITY " + ("OK" if ok else "EXCEEDED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
