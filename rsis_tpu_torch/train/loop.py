"""Training loop: epochs, the schedule state machine, patience, rollback.

Counterpart of ``rsis_tpu/train/loop.py`` (``init_dataloaders``,
``Trainer``, ``train``), itself the reference's ``trainIters``:

- scheduled flag flips: the encoder update, the class loss and the stop
  loss start at their configured epochs;
- patience escalation: after ``patience`` epochs without a better val
  loss, add the class loss, one more curriculum step, the encoder update
  or the stop loss, and roll back to the best checkpoint where the
  reference does;
- curriculum learning: T starts at 2 and grows by ``steps_cl`` up to
  ``maxseqlen``, with one ``make_train_step`` built and kept per T;
- best-val checkpointing with ``min_delta``, an optional smoothed val
  curve, and the early stop after ``patience_stop`` epochs;
- three ways to start, in the JAX package's order: resume from the model
  directory (its ``args.json`` taking precedence); ``--transfer`` from
  another model's checkpoint (``-transfer_from``), with a fresh
  ``fc_class`` when its dataset differs and fresh optimizer states; or a
  fresh start, its encoder optionally from a pretrained file
  (``-torch_encoder``, ``models/torch_import.py``);
- augmentation in the train step on the device, or with
  ``--host_augment`` in the train loader on the host (``data/augment.py``);
- the log lines of the reference (``Epoch %d:\\ttotal:...\\t(split)``,
  ``iter ...``, ``Saving checkpoint.``, ...), which
  ``utils/plot_curves.py`` parses; they go to the model directory's log
  file unless ``log_term``;
- with ``--visdom``, a mask snapshot of one val sample after each epoch
  (``utils/monitor.py``) and the dashboard on ``-port``
  (``utils/dashboard.py``, left serving after the run, like the JAX
  package's).

Batches cross to the device from pinned host memory without blocking the
host, two batches ahead. One ``torch.Generator`` on the device, seeded
with ``cfg.seed``, feeds every step's device augmentation and dropouts.

Under data parallelism (``group``, ``parallel/mesh.py``; ``cli/train.py``
starts the ranks) every rank's loader yields the identically seeded
global batch and the rank keeps its rows (``shard_batch``); the steps
compute the global batch's metrics and gradients, so every rank takes the
same decisions. The state starts from rank 0's (broadcast after the
init, the resume, ``-torch_encoder`` or ``--transfer``); rank 0 alone
writes the config, checkpoints, ``metrics.jsonl``, the log, snapshots
and the dashboard, and a barrier follows each checkpoint; every rank
reads a checkpoint back (resume, rollback). The other ranks print
nothing. With one rank the loop is the one-process loop.
"""

from __future__ import annotations

import collections
import os
import sys
import time
import traceback
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.base import normalize_image, unpack_target
from ..data.catalogs import get_dataset
from ..data.pipeline import DataLoader
from ..device import resolve_device
from ..evals.forward import make_forward
from ..models.rsis import init_weights as fresh_weights
from ..models.torch_import import init_encoder_from_torch
from ..parallel.mesh import replicate, shard_batch
from ..utils.dashboard import Dashboard
from ..utils.monitor import Monitor
from .checkpoint import (checkpoint_exists, load_checkpoint, load_weights,
                         model_dir, save_checkpoint)
from .step import StepFlags, TrainState, create_train_state, make_train_step

SPLITS = ("train", "val")


def init_dataloaders(cfg: Config):
    """The loaders by split, on the uint8 wire. The train split flips and
    warps on the host when ``cfg.augment`` and not
    ``cfg.augment_on_device``; otherwise the train step augments."""
    host_augment = cfg.augment and not cfg.augment_on_device
    return {split: DataLoader(
                get_dataset(cfg, split=split,
                            augment=host_augment and split == "train"),
                batch_size=cfg.batch_size, shuffle=True, drop_last=True,
                num_workers=cfg.num_workers, seed=cfg.seed)
            for split in SPLITS}


def init_weights(cfg: Config):
    """(encoder, decoder) state_dicts of a fresh model drawn as the JAX
    package draws one (``models/rsis.init_weights``), from a generator
    seeded with ``cfg.seed``."""
    return fresh_weights(cfg, torch.Generator().manual_seed(cfg.seed))


class Trainer:
    """Trains ``cfg``'s model on ``device`` (default cuda; raises without a
    card). weights: (encoder state_dict, decoder state_dict) to start a
    fresh run from, or None for ``init_weights(cfg)``. group: this rank's
    data-parallel group (``parallel/mesh.py``), whose device the run
    takes, or None for one process."""

    def __init__(self, cfg: Config, device=None, weights=None, group=None):
        self.cfg = cfg
        self.group = group
        self.device = (group.device if group is not None
                       else resolve_device(device, "Trainer"))
        self.main = group is None or group.rank == 0
        self.weights = weights
        self._steps: Dict[int, tuple] = {}  # T -> (train_step, eval_step)
        self._forwards: Dict[int, object] = {}  # T -> snapshot forward
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.dashboard = None

    def _get_steps(self, T: int):
        if T not in self._steps:
            self._steps[T] = make_train_step(self.cfg, T=T,
                                             device=self.device,
                                             group=self.group)
        return self._steps[T]

    def current_T(self) -> int:
        cfg = self.cfg
        if cfg.curriculum_learning and cfg.limit_seqlen_to > 0:
            return min(cfg.maxseqlen, cfg.limit_seqlen_to)
        return cfg.maxseqlen

    def _initial_state(self, cfg: Config) -> Tuple[TrainState, Config, int]:
        """(state, config, first epoch) a run starts from: resumed from the
        model directory (its saved config), transferred from
        ``cfg.transfer_from``'s checkpoint, or fresh (``self.weights`` or
        the seeded init, its encoder from ``cfg.torch_encoder`` if set),
        tried in that order. A transfer whose source has no checkpoint
        starts fresh, as the reference does."""
        if cfg.resume and checkpoint_exists(cfg):
            # the template takes the saved model's architecture, so that
            # ``--resume`` needs no other flag (JAX's restore reads shapes
            # from the checkpoint)
            saved_cfg = Config.load(os.path.join(model_dir(cfg),
                                                 "args.json"))
            template = create_train_state(saved_cfg, self.weights,
                                          device=self.device)
            state, saved_cfg = load_checkpoint(cfg, template)
            # the saved config takes precedence, like the reference's
            cfg = saved_cfg.replace(resume=True)
            return state, cfg, cfg.epoch_resume
        if cfg.transfer and checkpoint_exists(cfg, cfg.transfer_from):
            src_cfg = Config.load(os.path.join(
                model_dir(cfg, cfg.transfer_from), "args.json"))
            encoder, decoder = load_weights(cfg, cfg.transfer_from)
            if src_cfg.dataset != cfg.dataset:
                # a fresh class head for the new dataset's classes
                fresh = init_weights(cfg)[1]
                decoder = {**decoder, **{k: v for k, v in fresh.items()
                                         if k.startswith("fc_class.")}}
            return (create_train_state(cfg, (encoder, decoder),
                                       device=self.device), cfg, 0)
        encoder, decoder = self.weights or init_weights(cfg)
        if cfg.torch_encoder:
            encoder = init_encoder_from_torch(cfg.torch_encoder,
                                              cfg.base_model, encoder)
            print("Encoder initialized from", cfg.torch_encoder)
        return (create_train_state(cfg, (encoder, decoder),
                                   device=self.device), cfg, 0)

    def run(self) -> TrainState:
        state, cfg, epoch_resume = self._initial_state(self.cfg)
        self.cfg = cfg
        if self.group is not None:
            replicate(self.group, list(state.tensors().values()))
            # every rank has read what it resumes from before rank 0
            # writes the config
            self.group.barrier()

        if self.main:
            os.makedirs(model_dir(cfg), exist_ok=True)
            cfg.save(os.path.join(model_dir(cfg), "args.json"))

        log_fp = err_fp = None
        if not self.main:
            log_fp = open(os.devnull, "w")
            sys.stdout = log_fp
        elif not cfg.log_term:
            log_path = os.path.join(model_dir(cfg), cfg.log_file)
            print("Training logs will be saved to:", log_path)
            # line-buffered; a resumed run appends to the earlier log
            mode = "a" if cfg.resume else "w"
            log_fp = open(log_path, mode, buffering=1)
            sys.stdout = log_fp
            err_fp = open(os.path.join(model_dir(cfg), "train.err"), mode,
                          buffering=1)
            sys.stderr = err_fp
        try:
            print(cfg.to_dict())
            if cfg.curriculum_learning and epoch_resume == 0:
                cfg = self.cfg = cfg.replace(limit_seqlen_to=2)
            loaders = init_dataloaders(cfg)
            monitor = (Monitor(model_dir(cfg), enable_snapshots=cfg.visdom)
                       if self.main else None)
            if cfg.visdom and self.main:
                # a busy port must not stop the run: monitoring is optional
                try:
                    self.dashboard = Dashboard(model_dir(cfg),
                                               port=cfg.port).start()
                except OSError as e:
                    print(f"Dashboard disabled (port {cfg.port}: {e})")
            try:
                state = self._epochs(state, loaders, monitor, epoch_resume)
            finally:
                if monitor is not None:
                    monitor.close()
        finally:
            if log_fp is not None:
                sys.stdout = sys.__stdout__
                log_fp.close()
            if err_fp is not None:
                sys.stderr = sys.__stderr__
                err_fp.close()
        return state

    def _epochs(self, state: TrainState, loaders, monitor: Monitor,
                epoch_resume: int) -> TrainState:
        cfg = self.cfg
        best_val_loss = cfg.best_val_loss
        acc_patience = 0
        mt_val = -1.0
        start = time.time()
        for e in range(cfg.max_epoch):
            print("Epoch", e + epoch_resume)
            epoch_losses = {s: {"total": [], "iou": [], "stop": [],
                                "class": []} for s in SPLITS}

            # scheduled flag flips
            ep = e + epoch_resume
            if (ep >= cfg.finetune_after and not cfg.update_encoder
                    and cfg.finetune_after != -1):
                print("Starting to update encoder")
                cfg = self.cfg = cfg.replace(update_encoder=True)
                acc_patience = 0
                mt_val = -1.0
            if (ep >= cfg.class_loss_after and not cfg.use_class_loss
                    and cfg.class_loss_after != -1):
                print("Starting to learn class loss")
                cfg = self.cfg = cfg.replace(use_class_loss=True)
                best_val_loss = 1000.0
                acc_patience = 0
                mt_val = -1.0
            if (ep >= cfg.stop_loss_after and not cfg.use_stop_loss
                    and cfg.stop_loss_after != -1):
                if (not cfg.curriculum_learning
                        or cfg.limit_seqlen_to > cfg.min_steps):
                    print("Starting to learn stop loss")
                    cfg = self.cfg = cfg.replace(use_stop_loss=True)
                    best_val_loss = 1000.0
                    acc_patience = 0
                    mt_val = -1.0

            flags = StepFlags.from_config(cfg)
            T = self.current_T()
            train_step, eval_step = self._get_steps(T)

            mt = mi = mc = mx = 0.0
            for split in SPLITS:
                losses = epoch_losses[split]
                for batch_idx, batch in enumerate(
                        self._device_prefetch(loaders[split])):
                    if split == "train":
                        state, metrics = train_step(state, batch, flags,
                                                    self.rng)
                    else:
                        metrics = eval_step(state, batch, flags, self.rng)
                    m = metrics.cpu().numpy()
                    for key, val in zip(("total", "iou", "stop", "class"),
                                        m):
                        losses[key].append(float(val))
                    if monitor is not None:
                        monitor.log(split, ep, batch_idx, m[0], m[1], m[2],
                                    m[3], T=T)

                    if (batch_idx + 1) % cfg.print_every == 0:
                        mt = np.mean(losses["total"])
                        mi = np.mean(losses["iou"])
                        mc = np.mean(losses["class"])
                        mx = np.mean(losses["stop"])
                        te = time.time() - start
                        print("iter %d:\ttotal:%.4f\tclass:%.4f\t"
                              "iou:%.4f\tstop:%.4f\ttime:%.4f"
                              % (batch_idx, mt, mc, mi, mx, te))
                        start = time.time()

                if not losses["total"]:
                    raise RuntimeError(
                        f"no batches produced for split {split!r}")
                if split == "val" and cfg.smooth_curves:
                    cur = float(np.mean(losses["total"]))
                    mt = cur if mt_val == -1 else 0.9 * mt_val + 0.1 * cur
                    mt_val = mt
                else:
                    mt = float(np.mean(losses["total"]))
                mi = float(np.mean(losses["iou"]))
                mc = float(np.mean(losses["class"]))
                mx = float(np.mean(losses["stop"]))
                cfg = self.cfg = cfg.replace(epoch_resume=ep)
                # the absolute epoch, so a resumed run's curve continues
                print("Epoch %d:\ttotal:%.4f\tclass:%.4f\tiou:%.4f\t"
                      "stop:%.4f\t(%s)" % (ep, mt, mc, mi, mx, split))

            if cfg.visdom:
                self._epoch_snapshot(monitor, state, loaders, ep, T)

            # best-val checkpointing
            if mt < (best_val_loss - cfg.min_delta):
                print("Saving checkpoint.")
                best_val_loss = mt
                cfg = self.cfg = cfg.replace(best_val_loss=best_val_loss)
                if self.main:
                    save_checkpoint(cfg, state)
                if self.group is not None:
                    self.group.barrier()
                acc_patience = 0
            else:
                acc_patience += 1

            # patience escalation, rolling back to the best checkpoint
            rollback = False
            if (acc_patience > cfg.patience and not cfg.use_class_loss
                    and cfg.class_loss_after != -1):
                print("Starting to learn class loss")
                acc_patience = 0
                cfg = self.cfg = cfg.replace(use_class_loss=True)
                best_val_loss = 1000.0
                mt_val = -1.0
                rollback = True
            if (acc_patience > cfg.patience and cfg.curriculum_learning
                    and cfg.limit_seqlen_to < cfg.maxseqlen):
                print("Adding one step more:")
                acc_patience = 0
                cfg = self.cfg = cfg.replace(
                    limit_seqlen_to=cfg.limit_seqlen_to + cfg.steps_cl)
                print(cfg.limit_seqlen_to)
                best_val_loss = 1000.0
                mt_val = -1.0
            if (acc_patience > cfg.patience and not cfg.update_encoder
                    and cfg.finetune_after != -1):
                print("Starting to update encoder")
                acc_patience = 0
                cfg = self.cfg = cfg.replace(update_encoder=True)
                best_val_loss = 1000.0
                mt_val = -1.0
                rollback = True
            if (acc_patience > cfg.patience and not cfg.use_stop_loss
                    and cfg.stop_loss_after != -1):
                print("Starting to learn stop loss")
                if (not cfg.curriculum_learning
                        or cfg.limit_seqlen_to > cfg.min_steps):
                    acc_patience = 0
                    cfg = self.cfg = cfg.replace(use_stop_loss=True)
                    best_val_loss = 1000.0
                    mt_val = -1.0
                rollback = True
            if rollback and checkpoint_exists(cfg):
                state, _ = load_checkpoint(cfg, state)

            if acc_patience > cfg.patience_stop:
                break
        return state

    def _epoch_snapshot(self, monitor: Monitor, state: TrainState,
                        loaders, epoch: int, T: int) -> None:
        """Predicted and ground-truth masks of the first sample of a val
        batch, through the inference forward on the trainer's device
        (kernels included); like the JAX package's, it draws a val batch
        (one shuffle of the val loader: every rank draws it, so the ranks'
        loaders stay in step, and rank 0 alone runs the forward and writes)
        and a failure is printed, never raised: snapshots must not stop
        training."""
        try:
            imgs, tgts = next(iter(loaders["val"]))
            if not self.main:
                return
            if T not in self._forwards:
                with torch.random.fork_rng(devices=[]):
                    self._forwards[T] = make_forward(self.cfg, T=T,
                                                     device=self.device)
            x = normalize_image(imgs[:1])
            masks, clss, _ = (t.float().cpu().numpy() for t in
                              self._forwards[T]((state.encoder,
                                                 state.decoder), x))
            y_mask, y_class, _, _ = unpack_target(tgts[:1])
            h, w = x.shape[1], x.shape[2]
            monitor.snapshot(
                epoch, masks[0], y_mask[0, :T].reshape(-1, h, w),
                pred_classes=np.argmax(clss[0], -1),
                true_classes=y_class[0, :T],
                class_names=loaders["val"].dataset.get_classes())
        except Exception as e:  # snapshots must never kill training
            traceback.print_exc()
            print(f"snapshot failed: {e}")

    def _device_prefetch(self, loader, depth: int = 2):
        """Copy ``depth`` batches ahead to the device: each uint8 batch
        (this rank's rows of it under a group) is pinned on the host and
        copied without blocking, so the copy overlaps the running step."""
        pending = collections.deque()
        cuda = self.device.type == "cuda"
        for batch in loader:
            if self.group is not None:
                batch = shard_batch(self.group, batch)
            tensors = [torch.from_numpy(np.ascontiguousarray(a))
                       for a in batch]
            if cuda:
                tensors = [t.pin_memory().to(self.device, non_blocking=True)
                           for t in tensors]
            pending.append(tuple(tensors))
            if len(pending) > depth:
                yield pending.popleft()
        while pending:
            yield pending.popleft()


def train(cfg: Config, device=None, group=None) -> TrainState:
    return Trainer(cfg, device=device, group=group).run()
