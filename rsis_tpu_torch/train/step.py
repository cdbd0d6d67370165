"""The training step: encoder, T decode steps, matched losses, two updates.

Counterpart of ``rsis_tpu/train/step.py`` (``TrainState``, ``StepFlags``,
``create_train_state``, ``_forward_with_costs``, ``_losses``, ``decode_batch``, ``_resolve_remat``, ``make_train_step``).
One step:

  - the uint8 wire batch is normalised and unpacked on the device;
  - with ``cfg.augment`` (and ``augment_on_device``) the images and masks
    are flipped and warped on the device (``data/device_aug.py``, the warp
    kernel K7), from the step's ``torch.Generator``;
  - the encoder runs once in train mode (BatchNorm on batch statistics,
    running statistics updated as flax does), under bf16 autocast when the
    compute dtype is bf16; parameters stay fp32;
  - the decoder runs exactly T steps. Skip modes concat/sum/none with 3x3
    convolutions go through the kernels (``models/rowmajor_decoder.py``:
    K1 and K2 forward, K4, K5 and K3 in the cells' backward); "mul" and
    other kernel sizes train the plain ``RSISDecoder`` under autograd.
    A training step with a dropout rate above 0 takes the plain decoder,
    whose dropouts draw from the same generator after the augmentation,
    as JAX routes it. Each step's soft-IoU cost column against every GT
    mask is computed without gradient; the outputs stay time-major
    (T, B, ...);
  - the (B, N, T) costs, with invalid pairs set to 10, are solved by the
    batched LAP (K6 on the card) and the GT is gathered in that order;
  - total = iou_weight * iou + use_class_loss * class_weight * class +
    use_stop_loss * stop_weight * stop, one backward pass, and the two
    optimizer groups move (``train/optim.py``); the backbone's parameters
    and optimizer state move only when ``flags.update_encoder`` is set.

There is no jit: the step runs eagerly on its device, which holds the
state, and updates the state's modules and optimizer states in place.

Data parallelism (``group``, ``parallel/mesh.py``; one process a device):
each rank runs the step on its rows of the global batch and computes
what one process computes on the whole global batch, as JAX's sharded
step does. The augmentation's and the dropouts' draws are made at the
global batch's shape from every rank's identically seeded generator and
each rank keeps its rows; BatchNorm normalises with the global batch's
statistics (``models/backbones.BatchNorm2d``); the losses divide by
global denominators (``ops/losses.py``), so the global loss is the sum
of the ranks' losses; the gradients are summed over the ranks, a few
flat buckets at a time, before the update, and the metrics too. The
modules are not wrapped in ``DistributedDataParallel``: the step takes
its gradients with ``torch.autograd.grad``, which DDP's hooks do not
see. No collective runs inside a rematerialised decode step (a
recompute would reorder the ranks' collectives).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.utils.checkpoint

from ..config import Config
from ..data.device_aug import augment_wire_batch, zoom_range_for
from ..device import resolve_device
from ..models.decoder import RSISDecoder
from ..models.encoder import FeatureExtractor
from ..models.rowmajor_decoder import (CHANNEL_SEPARABLE,
                                       _hoist_cells_rowmajor,
                                       init_carry_rowmajor,
                                       rowmajor_decoder_step)
from ..models.rsis import build_models, compute_dtype, init_weights
from ..ops.losses import (masked_bce_loss, masked_nll_loss,
                          soft_iou_cost_matmul, soft_iou_loss)
from ..ops.mask_head import MaskHeadFunction, mask_head_ref
from ..ops.matching import hungarian
from ..ops.upsample import upsample_bilinear_align_corners
from ..parallel.mesh import (all_reduce_tensors_, global_batch_stats,
                             rows_of)
from ..utils.profiling import span
from .optim import init_state, split_params, update_groups

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


@dataclass
class StepFlags:
    """Training-schedule flags, each 0.0 or 1.0."""
    use_class_loss: float
    use_stop_loss: float
    update_encoder: float

    @classmethod
    def from_config(cls, cfg: Config) -> "StepFlags":
        return cls(use_class_loss=float(cfg.use_class_loss),
                   use_stop_loss=float(cfg.use_stop_loss),
                   update_encoder=float(cfg.update_encoder))


@dataclass
class TrainState:
    """Modules (fp32 parameters and BatchNorm statistics, on the step's
    device), the two optimizer states and the step count."""
    encoder: FeatureExtractor
    decoder: RSISDecoder
    enc_opt: dict
    dec_opt: dict
    step: int = 0

    def params(self) -> Dict[str, torch.nn.Parameter]:
        """Every parameter, named ``encoder.*`` / ``decoder.*``."""
        return {f"{name}.{k}": p
                for name, module in (("encoder", self.encoder),
                                     ("decoder", self.decoder))
                for k, p in module.named_parameters()}

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the state in a fixed order: parameters and
        BatchNorm statistics (``encoder.*`` / ``decoder.*``), then the
        optimizer moments (``enc_opt.*`` / ``dec_opt.*``)."""
        out = {f"{name}.{k}": t
               for name, module in (("encoder", self.encoder),
                                    ("decoder", self.decoder))
               for k, t in module.state_dict().items()}
        for name, opt in (("enc_opt", self.enc_opt),
                          ("dec_opt", self.dec_opt)):
            for key in sorted(opt):
                val = opt[key]
                items = (sorted(val.items()) if isinstance(val, dict)
                         else [("", val)])
                out.update({f"{name}.{key}.{k}": t for k, t in items
                            if torch.is_tensor(t)})
        return out


def create_train_state(cfg: Config, weights=None, device=None) -> TrainState:
    """A fresh state on ``device`` (default cuda; raises without a card).

    weights: (encoder state_dict, decoder state_dict) in the reference key
    layout (``models/weights.py``), or None for a fresh model drawn as
    the JAX package draws one (``models/rsis.init_weights``, its generator
    seeded with ``cfg.seed``). Optimizer moments start at zero."""
    device = resolve_device(device, "create_train_state")
    if weights is None:
        weights = init_weights(cfg, torch.Generator().manual_seed(cfg.seed))
    encoder, decoder = build_models(cfg)
    encoder.load_state_dict(weights[0])
    decoder.load_state_dict(weights[1])
    state = TrainState(encoder.to(device), decoder.to(device), {}, {})
    enc_p, dec_p = split_params(state.params())
    state.enc_opt = init_state(cfg.optim_cnn, enc_p, cfg.momentum)
    state.dec_opt = init_state(cfg.optim, dec_p, cfg.momentum)
    return state


def decode_batch(cfg: Config, batch, device):
    """Batch -> (x (B, H, W, 3) in the compute dtype, y_mask (B, N, HW),
    y_class (B, N) int64, sw_mask (B, N) fp32, sw_class (B, N) fp32), on
    ``device``.

    The wire format is (image uint8 (B, H, W, 3), packed target uint8
    (B, N, HW + 3)): the image is normalised on the device, and y_mask
    stays uint8 until a loss reads it. A 5-tuple of those tensors passes
    through with x cast to the compute dtype."""
    dtype = compute_dtype(cfg)
    batch = [torch.as_tensor(t).to(device) for t in batch]
    if len(batch) == 5:
        x, y_mask, y_class, sw_mask, sw_class = batch
        return x.to(dtype), y_mask, y_class.long(), sw_mask, sw_class
    img, target = batch
    if img.dtype == torch.uint8:
        mean = torch.tensor(_MEAN, dtype=dtype, device=device)
        std = torch.tensor(_STD, dtype=dtype, device=device)
        x = (img.to(dtype) / 255.0 - mean) / std
    else:
        x = img.to(dtype)
    return (x, target[:, :, :-3], target[:, :, -3].long(),
            target[:, :, -2].float(), target[:, :, -1].float())


def _resolve_remat(cfg: Config, T: int) -> bool:
    """cfg.remat "auto": rematerialise the decode steps only when their
    saved activations would not fit comfortably. Estimate: h_prev, c_prev
    and x_pad per cell per step over the 5-level pyramid (about twice the
    finest level), W = 2H, 2 bytes each, against 4 GB."""
    if cfg.remat in ("on", "off"):
        return cfg.remat == "on"
    h, w = cfg.imsize // 2, cfg.imsize
    fine_c = max(cfg.hidden_size // 16, 1)
    est = 3 * 2.0 * cfg.batch_size * h * w * fine_c * 2 * T
    return est > 4e9


def _forward_with_costs(cfg: Config, encoder, decoder, x, y_mask, T: int,
                        remat: bool = False, plain: bool = False,
                        rng: torch.Generator | None = None, rows=None):
    """Encoder once and T decode steps, each with its cost column.

    rng feeds the decoder's dropouts when it needs one (training mode,
    a rate above 0); the steps then take the plain decoder. rows: this
    rank's (offset, global batch), for the dropouts' draws. Returns masks
    (T, B, HW) logits in the compute dtype, class_probs (T, B, K) fp32,
    stop_logits (T, B) fp32 and costs (B, N, T) fp32 (no gradient)."""
    dtype = compute_dtype(cfg)
    h, w = x.shape[1], x.shape[2]
    with span("rsis.encoder"):
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=dtype == torch.bfloat16):
            skips = encoder(x.permute(0, 3, 1, 2))
        skips = tuple(s.to(dtype) for s in skips)
    with span("rsis.decode"):
        y_cost = y_mask.to(dtype)
        y_sum = y_mask.sum(dim=-1, dtype=torch.float32)

        def outputs(mask, cls, stop):
            """(B, h, w) mask logits -> the step's stacked outputs."""
            if tuple(mask.shape[-2:]) != (h, w):
                mask = upsample_bilinear_align_corners(mask, h, w)
            mask_flat = mask.reshape(mask.shape[0], -1)
            with torch.no_grad():
                cost_col = soft_iou_cost_matmul(y_sum, y_cost, mask_flat)
            return mask_flat, cls.float(), stop[:, 0].float(), cost_col

        if (cfg.skip_mode in CHANNEL_SEPARABLE and cfg.kernel_size == 3
                and not decoder.needs_generator()):
            with span("rsis.hoist"):
                cells = _hoist_cells_rowmajor(decoder, skips, cfg.skip_mode,
                                              dtype)
            carry = init_carry_rowmajor(skips, decoder.hidden_size, dtype)
            head = mask_head_ref if plain else MaskHeadFunction.apply
            head_w, head_b = decoder.conv_out.weight, decoder.conv_out.bias

            def step(carry):
                (h_fine, cls, stop), carry = rowmajor_decoder_step(
                    decoder, cells, carry, plain=plain)
                mask = head(h_fine, head_w, head_b)[..., 0]
                return outputs(mask, cls, stop), carry
        else:
            carry = None

            def step(carry):
                (mask, cls, stop), carry = decoder(
                    skips, carry, generator=rng, rows=rows)
                return outputs(mask[:, 0], cls, stop), carry

        if remat:
            step = _checkpointed(step, rng if decoder.needs_generator()
                                 else None)
        outs = []
        for _ in range(T):
            out, carry = step(carry)
            outs.append(out)
        masks, clss, stops, costs = zip(*outs)
        return (torch.stack(masks), torch.stack(clss), torch.stack(stops),
                torch.stack(costs, dim=-1))


def _checkpointed(step, rng: torch.Generator | None = None):
    """The decode step under activation checkpointing: its forward runs
    again in the backward (K1 and K2 launch twice per step). With rng (the
    dropouts' generator), the recomputed step draws what the first run
    drew: rng's state before the step is saved and restored for it."""
    def run(carry):
        saved = None if rng is None else rng.get_state()

        def replay(carry):
            if saved is not None:
                rng.set_state(saved)
            return step(carry)
        return torch.utils.checkpoint.checkpoint(replay, carry,
                                                 use_reentrant=False)
    return run


def _losses(cfg: Config, masks, clss, stops, costs, y_mask, y_class,
            sw_mask, sw_class, flags: StepFlags, solver, group=None):
    """Matched losses over the time-major predictions.

    masks (T, B, HW), clss (T, B, K), stops (T, B); costs (B, N, T). The
    GT gather emits (T, B) order directly; the weighted means do not
    depend on the order. solver maps (B, N, T) costs to the (B, N) perm:
    ``hungarian``, the LAP kernel (K6) on CUDA tensors (each rank solves
    its own rows' problems). With a data-parallel group the losses are
    this rank's share of the global batch's (global denominators).
    Returns (total, (iou, stop, class))."""
    T, b = masks.shape[0], masks.shape[1]
    hw = masks.shape[-1]
    num_classes = clss.shape[-1]
    with span("rsis.match"):
        with torch.no_grad():
            # invalid (GT, prediction) pairs cost 10, as in the reference;
            # the column mask reuses sw_mask
            valid = (sw_mask[:, :, None]
                     * sw_mask[:, None, :T]).to(costs.dtype)
            costs = cfg.iou_weight * costs * valid + (1.0 - valid) * 10.0
            perm = solver(costs)                               # (B, N)
        idx = perm[:, :T].T                                    # (T, B)
        brange = torch.arange(b, device=idx.device)[None, :]
        y_mask_tb = y_mask[brange, idx]                        # (T, B, HW)
        y_class_tb = y_class[brange, idx]                      # (T, B)
        swm_tb = sw_mask[:, :T].T
    with span("rsis.losses"):
        loss_iou = soft_iou_loss(y_mask_tb.reshape(-1, hw),
                                 masks.reshape(-1, hw), swm_tb.reshape(-1),
                                 group=group)
        loss_class = masked_nll_loss(y_class_tb.reshape(-1),
                                     clss.reshape(-1, num_classes),
                                     swm_tb.reshape(-1), group=group)
        # the stop head learns "keep going": target the mask sample
        # weight, weighted by the class sample weight
        loss_stop = masked_bce_loss(swm_tb, stops, sw_class[:, :T].T,
                                    cfg.stop_balance_weight, group=group)
        total = (cfg.iou_weight * loss_iou
                 + flags.use_class_loss * cfg.class_weight * loss_class
                 + flags.use_stop_loss * cfg.stop_weight * loss_stop)
    return total, (loss_iou, loss_stop, loss_class)


def loss_and_grads(cfg: Config, state: TrainState, batch, flags: StepFlags,
                   T: int, remat: bool = False, plain: bool = False,
                   device=None, rng: torch.Generator | None = None,
                   group=None):
    """Forward and backward of one train step without the update, on
    ``device`` (default: the state's).

    rng: the step's ``torch.Generator``, needed with device augmentation
    or dropout: the augmentation draws from it first, then the dropouts.
    group: the data-parallel group (``parallel/mesh.py``) whose ranks
    each hold their rows of the global batch in ``batch``, or None.

    Returns (total, (iou, stop, class), grads): grads maps every parameter
    name of ``state.params()`` to its gradient (zeros where the loss does
    not reach it); under a group all three are the global batch's, summed
    over the ranks. Updates the BatchNorm running statistics. plain=True
    replaces every kernel by its plain version (the oracle the kernels are
    held against on the card)."""
    state.encoder.train()
    state.decoder.train()
    if device is None:
        device = next(state.decoder.parameters()).device
    if (cfg.augment and cfg.augment_on_device
            or state.decoder.needs_generator()) and rng is None:
        raise ValueError("device augmentation and dropout draw from the "
                         "step's rng: pass a torch.Generator")
    with span("rsis.input"):
        x, y_mask, y_class, sw_mask, sw_class = decode_batch(cfg, batch,
                                                             device)
        rows = rows_of(group, x.shape[0])
        if cfg.augment and cfg.augment_on_device:
            x, y_mask = augment_wire_batch(
                rng, x, y_mask, cfg.rotation, cfg.translation, cfg.shear,
                zoom_range_for(cfg), plain=plain, rows=rows)
    # one rank keeps F.batch_norm (or what a caller's
    # global_batch_stats asks for)
    with (global_batch_stats(group) if rows is not None
          else contextlib.nullcontext()):
        masks, clss, stops, costs = _forward_with_costs(
            cfg, state.encoder, state.decoder, x, y_mask, T, remat=remat,
            plain=plain, rng=rng, rows=rows)
    total, parts = _losses(cfg, masks, clss, stops, costs, y_mask, y_class,
                           sw_mask, sw_class, flags,
                           functools.partial(hungarian, plain=plain), group)
    params = state.params()
    # the backward's recomputed dropouts rewind rng; leave it where the
    # forward left it
    after_forward = rng.get_state() if remat and rng is not None else None
    with span("rsis.backward"):
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
    if after_forward is not None:
        rng.set_state(after_forward)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    metrics = torch.stack([total.detach(), *(p.detach() for p in parts)])
    if group is not None:
        all_reduce_tensors_(group, list(grads.values()) + [metrics])
    return metrics[0], tuple(metrics[1:]), grads


def make_train_step(cfg: Config, T: Optional[int] = None, device=None,
                    remat: Optional[bool] = None, group=None):
    """Build the train step for a fixed decode length T (default
    cfg.maxseqlen).

    Returns (train_step, eval_step):
      train_step(state, batch, flags, rng=None) -> (state, metrics)
      eval_step(state, batch, flags, rng=None) -> metrics
    with metrics = [total, iou, stop, class] (fp32, on the device), batch
    the uint8 wire pair or the 5-tuple of ``decode_batch``. train_step
    updates ``state`` in place and returns it. rng is the step's
    ``torch.Generator`` (best on the step's device): train_step needs one
    when cfg.augment (on the device) or a dropout rate is set, draws the
    augmentation from it and then the dropouts, and advances it;
    eval_step draws nothing. ``device`` (default cuda; raises without a
    card) is where the batches go and must hold the state. ``remat=None``
    resolves from cfg.remat. group: the data-parallel group
    (``parallel/mesh.py``) of this rank, whose device the step runs on:
    each batch holds this rank's rows of the global batch and both steps
    return the global batch's metrics (train_step: and update by its
    gradients), identical on every rank."""
    device = (group.device if group is not None
              else resolve_device(device, "make_train_step"))
    T = T or cfg.maxseqlen
    if remat is None:
        remat = _resolve_remat(cfg, T)

    def train_step(state: TrainState, batch, flags: StepFlags, rng=None):
        with span("rsis.train_step"):
            total, (loss_iou, loss_stop, loss_class), grads = \
                loss_and_grads(cfg, state, batch, flags, T, remat=remat,
                               device=device, rng=rng, group=group)
            # gate closed: the backbone and its optimizer state stay as
            # they were (its BatchNorm statistics still move)
            with span("rsis.optim"):
                state.enc_opt, state.dec_opt = update_groups(
                    cfg, state.params(), grads, state.enc_opt, state.dec_opt,
                    flags.update_encoder)
            state.step += 1
            return state, torch.stack([total, loss_iou, loss_stop,
                                       loss_class])

    @torch.no_grad()
    def eval_step(state: TrainState, batch, flags: StepFlags, rng=None):
        state.encoder.eval()
        state.decoder.eval()
        x, y_mask, y_class, sw_mask, sw_class = decode_batch(cfg, batch,
                                                             device)
        masks, clss, stops, costs = _forward_with_costs(
            cfg, state.encoder, state.decoder, x, y_mask, T)
        total, parts = _losses(cfg, masks, clss, stops, costs, y_mask,
                               y_class, sw_mask, sw_class, flags, hungarian,
                               group)
        metrics = torch.stack([total, *parts])
        if group is not None:
            all_reduce_tensors_(group, [metrics])
        return metrics

    return train_step, eval_step
