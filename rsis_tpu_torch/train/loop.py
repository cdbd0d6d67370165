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
- resume from the model directory, its ``args.json`` taking precedence;
- the log lines of the reference (``Epoch %d:\\ttotal:...\\t(split)``,
  ``iter ...``, ``Saving checkpoint.``, ...), which
  ``utils/plot_curves.py`` of the JAX package parses; they go to the
  model directory's log file unless ``log_term``.

Batches cross to the device from pinned host memory without blocking the
host, two batches ahead. One ``torch.Generator`` on the device, seeded
with ``cfg.seed``, feeds every step's augmentation and dropouts. Not in
the port yet (they raise): ``transfer``, ``torch_encoder``, ``visdom`` and
the host-side augmentation.
"""

from __future__ import annotations

import collections
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..data.catalogs import get_dataset
from ..data.pipeline import DataLoader
from ..device import resolve_device
from ..models.rsis import build_models
from ..utils.monitor import Monitor
from .checkpoint import (checkpoint_exists, load_checkpoint, model_dir,
                         save_checkpoint)
from .step import StepFlags, TrainState, create_train_state, make_train_step

SPLITS = ("train", "val")


def init_dataloaders(cfg: Config):
    """The loaders by split, on the uint8 wire; augmentation happens in the
    train step."""
    return {split: DataLoader(get_dataset(cfg, split=split),
                              batch_size=cfg.batch_size, shuffle=True,
                              drop_last=True, num_workers=cfg.num_workers,
                              seed=cfg.seed)
            for split in SPLITS}


def _unported(cfg: Config) -> None:
    missing = [name for name, on in (
        ("transfer", cfg.transfer), ("torch_encoder", cfg.torch_encoder),
        ("visdom", cfg.visdom),
        ("host augmentation", cfg.augment and not cfg.augment_on_device))
        if on]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: not in the port yet (ROADMAP.md)")


class Trainer:
    """Trains ``cfg``'s model on ``device`` (default cuda; raises without a
    card). weights: (encoder state_dict, decoder state_dict) to start a
    fresh run from, or None for the modules' initialisation under
    ``torch.manual_seed(cfg.seed)``."""

    def __init__(self, cfg: Config, device=None, weights=None):
        _unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device, "Trainer")
        self.weights = weights
        self._steps: Dict[int, tuple] = {}  # T -> (train_step, eval_step)
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _get_steps(self, T: int):
        if T not in self._steps:
            self._steps[T] = make_train_step(self.cfg, T=T,
                                             device=self.device)
        return self._steps[T]

    def current_T(self) -> int:
        cfg = self.cfg
        if cfg.curriculum_learning and cfg.limit_seqlen_to > 0:
            return min(cfg.maxseqlen, cfg.limit_seqlen_to)
        return cfg.maxseqlen

    def _fresh_state(self, cfg: Config) -> TrainState:
        weights = self.weights
        if weights is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(cfg.seed)
                encoder, decoder = build_models(cfg)
            weights = (encoder.state_dict(), decoder.state_dict())
        return create_train_state(cfg, weights, device=self.device)

    def run(self) -> TrainState:
        cfg = self.cfg
        epoch_resume = 0
        state = self._fresh_state(cfg)
        if cfg.resume and checkpoint_exists(cfg):
            state, saved_cfg = load_checkpoint(cfg, state)
            # the saved config takes precedence, like the reference's
            cfg = self.cfg = saved_cfg.replace(resume=True)
            epoch_resume = cfg.epoch_resume

        os.makedirs(model_dir(cfg), exist_ok=True)
        cfg.save(os.path.join(model_dir(cfg), "args.json"))

        log_fp = err_fp = None
        if not cfg.log_term:
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
            monitor = Monitor(model_dir(cfg))
            try:
                state = self._epochs(state, loaders, monitor, epoch_resume)
            finally:
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

            # best-val checkpointing
            if mt < (best_val_loss - cfg.min_delta):
                print("Saving checkpoint.")
                best_val_loss = mt
                cfg = self.cfg = cfg.replace(best_val_loss=best_val_loss)
                save_checkpoint(cfg, state)
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

    def _device_prefetch(self, loader, depth: int = 2):
        """Copy ``depth`` batches ahead to the device: each uint8 batch is
        pinned on the host and copied without blocking, so the copy
        overlaps the running step."""
        pending = collections.deque()
        cuda = self.device.type == "cuda"
        for batch in loader:
            tensors = [torch.from_numpy(a) for a in batch]
            if cuda:
                tensors = [t.pin_memory().to(self.device, non_blocking=True)
                           for t in tensors]
            pending.append(tuple(tensors))
            if len(pending) > depth:
                yield pending.popleft()
        while pending:
            yield pending.popleft()


def train(cfg: Config, device=None) -> TrainState:
    return Trainer(cfg, device=device).run()
