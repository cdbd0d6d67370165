"""The reference train step: augmentation, forward, matcher, losses,
backward and the two Adam groups, in fp32 from the raw inputs.

The recipe's semantics (imatge-upc/rsis ``train.py`` with the port's
on-device augmentation draw):

- the uint8 image is normalised with the ImageNet mean and deviation;
  the packed target (B, N, H*W + 3) holds N instance masks, then class
  id, mask weight and class weight;
- with augmentation, a generator on the batch's device seeded as the
  port's step generator draws, in this order, a flip for each image
  (uniform < 0.5), then the rotation, the two translations (times H and
  W), the shear and, where the dataset zooms, the two zooms, each
  uniform in its range; every output pixel takes the nearest source
  pixel of the matrix R @ T @ Sh @ Z about the image centre, the flip
  reflecting the column; the instance masks collapse into one id plane
  (the later slot wins) that moves with the image;
- the encoder runs on batch statistics, the decoder T steps, and every
  step's soft-IoU cost against every ground-truth mask is computed
  without gradient; invalid pairs cost 10; the assignment is exact
  (``lap.py``);
- total = iou_weight * iou + use_class * class_weight * class +
  use_stop * stop_weight * stop (weighted means, the stop loss a
  class-balanced BCE on the mask weights with the class weights);
- Adam with coupled L2 decay on two groups: the backbone (``base.*``,
  lr_cnn) moves only when update_encoder is set, the rest (lr) always.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from . import lap, model
from .precision import Precision, exact_fp32

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def zoom_range(cfg: Mapping):
    """The recipe's zoom: Pascal (zoom, max(2 zoom, 1)), other datasets
    (zoom, 1) with --resize, none without it."""
    if cfg["dataset"] == "pascal":
        return (cfg["zoom"], max(cfg["zoom"] * 2, 1.0))
    if not cfg["resize"]:
        return None
    return (cfg["zoom"], 1.0)


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _mat3(*rows):
    return torch.stack(rows, -1).reshape(-1, 3, 3)


def augment_draw(gen: torch.Generator, b: int, h: int, w: int, cfg):
    """(flip (B,) bool, matrices (B, 3, 3)) drawn as the recipe draws."""
    flip = torch.rand((b,), generator=gen, device=gen.device) < 0.5
    rot, tr, sh = cfg["rotation"], cfg["translation"], cfg["shear"]
    deg = _uniform(gen, (b,), -rot, rot)
    tx = _uniform(gen, (b,), -tr, tr) * h
    ty = _uniform(gen, (b,), -tr, tr) * w
    sdeg = _uniform(gen, (b,), -sh, sh)
    zr = zoom_range(cfg)
    zoom = None if zr is None else _uniform(gen, (b, 2), zr[0], zr[1])
    t = deg * (math.pi / 180.0)
    cos, sin = torch.cos(t), torch.sin(t)
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    m = _mat3(cos, -sin, zero, sin, cos, zero, zero, zero, one)
    m = m @ _mat3(one, zero, tx, zero, one, ty, zero, zero, one)
    st = sdeg * (math.pi / 180.0)
    m = m @ _mat3(one, -torch.sin(st), zero, zero, torch.cos(st), zero,
                  zero, zero, one)
    if zoom is not None:
        m = m @ _mat3(zoom[:, 0], zero, zero, zero, zoom[:, 1], zero,
                      zero, zero, one)
    return flip, m


def source_index(matrices, flip, h: int, w: int):
    """(B, H*W) flat source pixel of every output pixel: nearest (round
    half to even) in the centred frame, clamped, the column reflected on
    a flip."""
    a, t = matrices[:, :2, :2].float(), matrices[:, :2, 2].float()
    cr = torch.tensor(h / 2.0 - 0.5, dtype=torch.float32)
    cc = torch.tensor(w / 2.0 - 0.5, dtype=torch.float32)
    p, q, v, u = (a[:, 0, 0:1], a[:, 0, 1:2], a[:, 1, 0:1], a[:, 1, 1:2])
    m = (t[:, 0:1] + cr) - (a[:, 0, 0:1] * cr + a[:, 0, 1:2] * cc)
    o = (t[:, 1:2] + cc) - (a[:, 1, 0:1] * cr + a[:, 1, 1:2] * cc)
    dev = matrices.device
    r = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(
        h, w).reshape(1, -1)
    c = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(
        h, w).reshape(1, -1)
    ri = torch.clamp(torch.round(p * r + (q * c + m)), 0, h - 1).long()
    ci = torch.clamp(torch.round(v * r + (u * c + o)), 0, w - 1).long()
    ci = torch.where(flip[:, None].to(dev), (w - 1) - ci, ci)
    return ri * w + ci


def unpack(img_u8, tgt_u8):
    """Wire batch -> (x (B, H, W, 3) fp32, y (B, N, HW) uint8, class (B, N)
    int64, mask weight (B, N), class weight (B, N))."""
    mean = torch.tensor(MEAN, device=img_u8.device)
    std = torch.tensor(STD, device=img_u8.device)
    x = (img_u8.float() / 255.0 - mean) / std
    return (x, tgt_u8[:, :, :-3], tgt_u8[:, :, -3].long(),
            tgt_u8[:, :, -2].float(), tgt_u8[:, :, -1].float())


def augment(gen, x, y, cfg):
    b, h, w, _ = x.shape
    n = y.shape[1]
    flip, mats = augment_draw(gen, b, h, w, cfg)
    idx = source_index(mats, flip, h, w)
    lbl = torch.arange(1, n + 1, dtype=torch.uint8, device=y.device)
    ids = torch.amax(y.reshape(b, n, h * w) * lbl[None, :, None], dim=1)
    x = torch.gather(x.reshape(b, h * w, 3), 1,
                     idx[:, :, None].expand(b, h * w, 3)).reshape(b, h, w, 3)
    ids = torch.gather(ids, 1, idx)
    return x, (ids[:, None, :] == lbl[None, :, None]).to(y.dtype)


def soft_iou_cost(target, logits, eps: float = 1e-6):
    out = torch.sigmoid(logits)
    num = torch.sum(out * target, dim=-1)
    den = torch.sum(out + target - out * target, dim=-1) + eps
    return 1.0 - num / den


def _weighted_mean(values, sw, eps: float = 1e-12):
    return torch.sum(values * sw) / (torch.sum(sw) + eps)


def balanced_bce(target, logits, balance: float):
    max_val = torch.clamp(-logits, min=0.0)
    raw = (logits - logits * target + max_val
           + torch.log(torch.exp(-max_val) + torch.exp(-logits - max_val)))
    return (1.0 - balance) * raw * target + balance * raw * (1.0 - target)


def step_loss(cfg, params: Dict[str, torch.Tensor], x, y, y_class, sw_mask,
              sw_class, flags: Mapping, T: int, prec: Precision):
    """Forward, matcher and losses of one step. Returns (total, iou,
    stop, class)."""
    enc = {k[8:]: v for k, v in params.items() if k.startswith("encoder.")}
    dec = {k[8:]: v for k, v in params.items() if k.startswith("decoder.")}
    b, h, w, _ = x.shape
    skips = model.encoder(enc, x.permute(0, 3, 1, 2).contiguous(), prec,
                          True, cfg["base_model"])
    yf = y.float()
    y_sum = yf.sum(-1)
    carry, masks, clss, stops, costs = None, [], [], [], []
    for _ in range(T):
        (mask, cls, stop), carry = model.decoder_step(
            dec, skips, carry, prec, cfg["hidden_size"])
        if tuple(mask.shape[-2:]) != (h, w):
            mask = torch.nn.functional.interpolate(
                mask, size=(h, w), mode="bilinear", align_corners=True)
        flat = mask[:, 0].reshape(b, -1)
        with torch.no_grad():
            out = torch.sigmoid(flat)
            inter = torch.einsum("bh,bnh->bn", out, yf)
            costs.append(1.0 - inter / (out.sum(-1)[:, None] + y_sum
                                        - inter + 1e-6))
        masks.append(flat)
        clss.append(cls)
        stops.append(stop[:, 0])
    with torch.no_grad():
        cost = torch.stack(costs, -1)                          # (B, N, T)
        valid = sw_mask[:, :, None] * sw_mask[:, None, :T]
        cost = cfg["iou_weight"] * cost * valid + (1.0 - valid) * 10.0
        idx = torch.from_numpy(lap.match(cost.cpu().numpy())).to(x.device)
    brange = torch.arange(b, device=x.device)[:, None]
    y_tb = yf[brange, idx].transpose(0, 1)                     # (T, B, HW)
    cls_tb = y_class[brange, idx].transpose(0, 1)              # (T, B)
    swm = sw_mask[:, :T].T
    masks = torch.stack(masks)
    clss = torch.stack(clss)
    stops = torch.stack(stops)
    iou = _weighted_mean(soft_iou_cost(y_tb, masks), swm)
    nll = -torch.gather(torch.log(clss + 1e-12), -1, cls_tb[..., None])[..., 0]
    cls_loss = _weighted_mean(nll, swm)
    stop_loss = _weighted_mean(
        balanced_bce(swm, stops, cfg["stop_balance_weight"]),
        sw_class[:, :T].T)
    total = (cfg["iou_weight"] * iou
             + flags["use_class_loss"] * cfg["class_weight"] * cls_loss
             + flags["use_stop_loss"] * cfg["stop_weight"] * stop_loss)
    return total, iou, stop_loss, cls_loss


def is_param(key: str) -> bool:
    return key.endswith(".weight") or key.endswith(".bias")


def is_backbone(name: str) -> bool:
    return name.startswith("encoder.base.")


def train_steps(cfg: Mapping, enc0: Mapping, dec0: Mapping,
                batches: Sequence, flags: Mapping, T: int, aug_seed: int,
                prec: Precision, half: bool = False) -> dict:
    """Runs len(batches) reference steps from the state_dicts (enc0,
    dec0); none of them is modified.

    half: the fault of a step that leaves out the second half of each
    batch (after the augmentation) and takes its means over the rest.
    Returns {"losses": [[total, iou, stop, class] a step], "grad1": the
    first step's gradient with its L2 decay, as Adam takes it, for every
    leaf Adam moves; "raw_grad1": the same without the decay, for every
    leaf; "params": every leaf after the last step}."""
    for name in ("optim", "optim_cnn"):
        if cfg[name] != "adam":
            raise ValueError(f"the reference trains adam, not {cfg[name]}")
    update_enc = float(flags["update_encoder"]) > 0
    params = {f"encoder.{k}": v.detach().float().clone()
              for k, v in enc0.items() if is_param(k)}
    params.update({f"decoder.{k}": v.detach().float().clone()
                   for k, v in dec0.items() if is_param(k)})
    for k, p in params.items():
        p.requires_grad_(update_enc or not is_backbone(k))
    moving = [k for k in params if update_enc or not is_backbone(k)]
    mu = {k: torch.zeros_like(params[k]) for k in moving}
    nu = {k: torch.zeros_like(params[k]) for k in moving}
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device).manual_seed(aug_seed)
    out: dict = {"losses": []}
    with exact_fp32():
        for count, (img_u8, tgt_u8) in enumerate(batches, start=1):
            x, y, y_class, sw_mask, sw_class = unpack(img_u8, tgt_u8)
            if cfg["augment"]:
                x, y = augment(gen, x, y, cfg)
            if half:
                keep = x.shape[0] // 2
                x, y, y_class, sw_mask, sw_class = (
                    t[:keep] for t in (x, y, y_class, sw_mask, sw_class))
            parts = step_loss(cfg, params, x, y, y_class, sw_mask, sw_class,
                              flags, T, prec)
            grads = torch.autograd.grad(parts[0], [params[k] for k in moving],
                                        allow_unused=True)
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(moving, grads)}
            out["losses"].append([float(t.detach()) for t in parts])
            with torch.no_grad():
                eff = {}
                for k in moving:
                    lr, wd = ((cfg["lr_cnn"], cfg["weight_decay_cnn"])
                              if is_backbone(k)
                              else (cfg["lr"], cfg["weight_decay"]))
                    g = grads[k] + wd * params[k]
                    eff[k] = g
                    mu[k] = ADAM_B1 * mu[k] + (1 - ADAM_B1) * g
                    nu[k] = ADAM_B2 * nu[k] + (1 - ADAM_B2) * g * g
                    step = (mu[k] / (1 - ADAM_B1 ** count)) / (
                        torch.sqrt(nu[k] / (1 - ADAM_B2 ** count))
                        + ADAM_EPS)
                    params[k] -= lr * step
            if count == 1:
                out["grad1"] = eff
                out["raw_grad1"] = grads
            del parts, grads
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double()))
            for k, t in tensors.items()}


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float],
              keys: List[str]) -> Dict[str, float]:
    """For each key, |program norm - reference norm| against the larger
    of the leaf's reference norm and the median leaf's, the median taken
    over the leaves the reference does not leave at zero (a frozen
    backbone's change is zero on both sides and no scale)."""
    if not keys:
        return {"": 0.0}
    nonzero = [reference[k] for k in keys if reference[k] > 0] or [0.0]
    median = float(np.median(nonzero))
    return {k: abs(program[k] - reference[k]) / max(reference[k], median,
                                                    1e-30)
            for k in keys}
