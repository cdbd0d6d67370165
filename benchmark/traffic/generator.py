"""The one traffic generator: a cell's inputs from its mix file and seed.

A mix (``traffic/<name>.json``) is data: the loop (``"infer"``, a
closed loop over forward calls, or ``"train"``, the trainer's step), the
batch and frame size, the decode length T, the ground-truth slots, the
pool of distinct batches made once on the device, the instance-count
distribution and the blob radii. The frames are seeded noise with round
instances painted over it in order, a later instance covering an earlier
one, so the masks are disjoint, as instance annotations are. Each
image's instance count is drawn from the mix's distribution, and the
instances that stay visible are its ground truth, largest first, as the
reference orders them; the slot after the last one is the
end-of-sequence slot (class weight 1, mask weight 0). The wire format is
the train step's: an image (B, H, W, 3) uint8 and a packed target
(B, N, H*W + 3) uint8 (masks, class id, mask weight, class weight).
Everything is made with one ``torch.Generator`` on the device, so the
same seed gives the same inputs.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _instances(gen, mix: Mapping, n_images: int, num_classes: int,
               device):
    """(ids (M, H, W) uint8 painted instance ids, 1-based, 0 background;
    classes (M, slots) int64 in [1, num_classes))."""
    h, w, slots = mix["height"], mix["width"], mix["slots"]
    counts = torch.tensor(mix["instances"]["counts"], device=device)
    weights = torch.tensor(mix["instances"]["weights"], dtype=torch.float64,
                           device=device)
    if int(counts.max()) > slots or int(counts.min()) < 0:
        raise ValueError(f"instance counts must lie in [0, {slots}]")
    k = counts[torch.multinomial(weights, n_images, replacement=True,
                                 generator=gen)]
    r_lo, r_hi = mix["radius"]
    unit = torch.rand((4, n_images, slots), generator=gen, device=device)
    cy = (0.125 + 0.75 * unit[0]) * h
    cx = (0.125 + 0.75 * unit[1]) * w
    rad = (r_lo + (r_hi - r_lo) * unit[2]) * h
    classes = 1 + (unit[3] * (num_classes - 1)).long().clamp_(
        max=num_classes - 2)
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    ids = torch.zeros((n_images, h, w), dtype=torch.uint8, device=device)
    for n in range(slots):
        inside = (((yy - cy[:, n, None, None]) ** 2
                   + (xx - cx[:, n, None, None]) ** 2)
                  <= rad[:, n, None, None] ** 2)
        inside &= (n < k)[:, None, None]
        ids.masked_fill_(inside, n + 1)
    return ids, classes


def _frames(gen, ids, device) -> torch.Tensor:
    """uint8 (M, H, W, 3) frames: noise, each instance tinted."""
    m, h, w = ids.shape
    noise = torch.randint(0, 256, (m, h, w, 3), generator=gen,
                          device=device, dtype=torch.uint8)
    tint = torch.randint(0, 256, (m, 256, 3), generator=gen, device=device,
                         dtype=torch.uint8)
    tint[:, 0] = 0
    painted = torch.gather(tint, 1, ids.reshape(m, -1, 1).long().expand(
        m, h * w, 3)).reshape(m, h, w, 3)
    keep = (ids > 0)[..., None]
    return torch.where(keep, (noise // 4 + painted // 4 * 3), noise)


def _targets(ids, classes, slots: int) -> torch.Tensor:
    """Packed (M, slots, H*W + 3) uint8 targets from the painted ids."""
    m = ids.shape[0]
    flat = ids.reshape(m, 1, -1)
    lbl = torch.arange(1, slots + 1, device=ids.device, dtype=torch.uint8)
    masks = (flat == lbl[None, :, None])                  # (M, N, HW)
    area = masks.sum(-1)
    order = torch.argsort(area, dim=1, descending=True, stable=True)
    masks = torch.gather(masks, 1, order[:, :, None].expand_as(masks))
    area = torch.gather(area, 1, order)
    cls = torch.gather(classes, 1, order)
    visible = area > 0
    n_vis = visible.sum(1)
    slot = torch.arange(slots, device=ids.device)[None, :]
    sw_class = visible | (slot == n_vis[:, None])
    tail = torch.stack([torch.where(visible, cls, 0), visible.long(),
                        sw_class.long()], -1).to(torch.uint8)
    return torch.cat([masks.to(torch.uint8), tail], -1)


def train_pool(mix: Mapping, num_classes: int, seed: int,
               device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``pool_batches`` wire batches (image, packed target) of the mix."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, pool = mix["batch"], mix["pool_batches"]
    out = []
    for _ in range(pool):
        ids, classes = _instances(gen, mix, b, num_classes, device)
        out.append((_frames(gen, ids, device),
                    _targets(ids, classes, mix["slots"])))
    return out


def frame_pool(mix: Mapping, num_classes: int, seed: int,
               device) -> List[torch.Tensor]:
    """``pool_batches`` batches of normalised float32 (B, H, W, 3) frames,
    the forward's input."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    out = []
    for _ in range(mix["pool_batches"]):
        ids, _ = _instances(gen, mix, mix["batch"], num_classes, device)
        img = _frames(gen, ids, device)
        out.append(((img.float() / 255.0 - mean) / std).contiguous())
    return out

