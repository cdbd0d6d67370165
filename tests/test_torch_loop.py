"""The port's train loop, checkpoints, dropouts and augmented step.

- The port's ``Trainer`` against JAX's ``Trainer`` (``pallas="off"``) from
  the same initial weights on a tiny synthetic run (tiny backbone, 32x32,
  B=4, T=2 under curriculum learning, 3 epochs, no augmentation: the two
  frameworks' random draws differ; no dropout; patience 0, so that the
  schedule flips, a checkpoint and a patience escalation with its rollback
  happen): the same event lines, and every loss printed within 1e-4.
- Resume: the run continues from the checkpointed epoch (the reference's
  ``epoch_resume``), not at 0; ``metrics.jsonl`` grows; ``--resume`` with
  no other flag builds the saved model, not the invocation's defaults.
- ``decoder.pt`` read by the JAX package's ``torch_import`` gives the JAX
  arrays it was made from, exactly.
- One CPU step with device augmentation and all three dropouts gives a
  finite loss, draws only from its generator, and gives the same loss and
  gradients with and without rematerialisation.
- Dropout: identity in eval mode; in training mode whole channels of each
  hidden state are dropped."""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu.models.torch_import import import_decoder, load_state_dict_file
from rsis_tpu.train import loop as jax_loop
from rsis_tpu_torch.cli.train import main as train_main
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.data.synthetic import synthetic_wire_batch
from rsis_tpu_torch.models import decoder as port_decoder
from rsis_tpu_torch.models.rsis import build_models
from rsis_tpu_torch.models.weights import (from_jax_variables,
                                           train_state_from_jax)
from rsis_tpu_torch.train import loop as port_loop
from rsis_tpu_torch.train import step as port_step
from rsis_tpu_torch.train.checkpoint import model_dir, save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

RUN = dict(dataset="synthetic", base_model="tiny", hidden_size=16,
           num_classes=3, imsize=32, maxseqlen=3, gt_maxseqlen=5,
           batch_size=4, max_epoch=3, print_every=1, log_term=True,
           num_workers=2, synthetic_length=8, patience=0,
           class_loss_after=100, stop_loss_after=100,
           curriculum_learning=True)


def _events(out: str):
    """(kind, text, numbers) of every log line but the config dump and
    the log-file notice; 'iter' lines without their wall time."""
    events = []
    for line in out.splitlines():
        if not line or line.startswith(("{", "Training logs")):
            continue
        head, _, rest = line.partition(":")
        if line.startswith("iter") or (line.startswith("Epoch") and rest):
            fields = [f for f in rest.split("\t") if f]
            nums = [float(f.split(":")[1]) for f in fields
                    if ":" in f and not f.startswith("time")]
            tail = fields[-1] if line.startswith("Epoch") else ""
            events.append((head, tail, nums))
        else:
            events.append((line, "", []))
    return events


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers on the same weights; their stdout and the port's
    model directory."""
    root = tmp_path_factory.mktemp("loop")
    jcfg = JaxConfig(**RUN, num_devices=1, pallas="off",
                     models_root=str(root / "jax"), model_name="m")
    init = jax.jit(lambda key: jax_rsis.init_variables(jcfg, key, (32, 32)))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(jcfg.seed)))
    cfg = Config(**RUN, models_root=str(root / "port"), model_name="m")
    trainers = {"jax": jax_loop.Trainer(jcfg),
                "port": port_loop.Trainer(
                    cfg, device="cpu",
                    weights=from_jax_variables(variables, "tiny"))}
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "init_variables", lambda cfg, key: variables)
        for name, trainer in trainers.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                trainer.run()
            outs[name] = buf.getvalue()
    return outs, cfg, variables


def test_trainer_matches_jax(runs):
    outs, _, _ = runs
    got, want = _events(outs["port"]), _events(outs["jax"])
    assert [e[:2] for e in got] == [e[:2] for e in want]
    kinds = {e[0] for e in want}
    assert {"Saving checkpoint.", "Starting to update encoder",
            "Starting to learn class loss"} <= kinds
    assert sum(e[0].startswith("Epoch") and e[1] == "(val)"
               for e in want) == 3
    for (kind, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=kind)


def test_resume_continues_from_the_checkpointed_epoch(runs, capsys):
    _, cfg, _ = runs
    d = model_dir(cfg)
    saved = Config.load(os.path.join(d, "args.json"))
    assert saved.epoch_resume >= 1
    with open(os.path.join(d, "metrics.jsonl")) as fp:
        n_before = len(fp.readlines())
    capsys.readouterr()
    port_loop.Trainer(cfg.replace(resume=True), device="cpu").run()
    out = capsys.readouterr().out
    headers = [int(line.split()[1]) for line in out.splitlines()
               if line.startswith("Epoch") and ":" not in line]
    # the saved config (max_epoch 3) takes precedence
    assert headers == [saved.epoch_resume + e for e in range(3)]
    with open(os.path.join(d, "metrics.jsonl")) as fp:
        assert len(fp.readlines()) > n_before


def test_resume_takes_the_architecture_from_the_checkpoint(runs, capsys):
    """``--resume`` with no flag but where the model is: the saved config
    (tiny, 3 classes, --log_term) builds the state, not the invocation's
    defaults (resnet101, 21 classes), as TRAINRUN.md's resumed stages
    run."""
    _, cfg, _ = runs
    start = Config.load(os.path.join(model_dir(cfg),
                                     "args.json")).epoch_resume
    capsys.readouterr()
    state = train_main(["--resume", "-dataset", "synthetic",
                        "-models_root", cfg.models_root,
                        "-model_name", cfg.model_name], device="cpu")
    assert state.decoder.fc_class.out_features == 3
    headers = [int(line.split()[1]) for line in
               capsys.readouterr().out.splitlines()
               if line.startswith("Epoch") and ":" not in line]
    assert headers == [start + e for e in range(3)]


def test_decoder_pt_reads_back_into_jax(runs, tmp_path):
    _, cfg, variables = runs
    state = train_state_from_jax(cfg, variables, device="cpu")
    d = save_checkpoint(cfg.replace(models_root=str(tmp_path)), state)
    got = import_decoder(load_state_dict_file(os.path.join(d,
                                                           "decoder.pt")))
    want = variables["params"]["decoder"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


STEP = Config(base_model="tiny", hidden_size=16, num_classes=4, imsize=32,
              maxseqlen=3, gt_maxseqlen=5, batch_size=2, augment=True,
              dropout=0.2, dropout_cls=0.2, dropout_stop=0.2,
              use_class_loss=True, use_stop_loss=True)


def _fresh(cfg):
    torch.manual_seed(0)
    enc, dec = build_models(cfg)
    return port_step.create_train_state(
        cfg, (enc.state_dict(), dec.state_dict()), device="cpu")


def test_step_with_augmentation_and_dropout():
    batch = synthetic_wire_batch(np.random.default_rng(0), 2, 32, 32, 5, 4)
    flags = port_step.StepFlags.from_config(STEP)
    train_step, _ = port_step.make_train_step(STEP, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        train_step(_fresh(STEP), batch, flags)
    metrics = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        state = _fresh(STEP)
        global_before = torch.random.get_rng_state()
        state, m = train_step(state, batch, flags, gen)
        assert torch.equal(torch.random.get_rng_state(), global_before)
        assert state.step == 1 and torch.isfinite(m).all()
        metrics.append(m)
    assert torch.equal(metrics[0], metrics[1])
    # another generator state: other flips, matrices and dropout masks
    _, m = train_step(_fresh(STEP), batch, flags, gen)
    assert not torch.equal(m, metrics[0])
    # rematerialised steps replay the dropouts they drew
    results = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(3)
        total, _, grads = port_step.loss_and_grads(
            STEP, _fresh(STEP), batch, flags, T=3, remat=remat, rng=gen)
        results.append((total, grads, gen.get_state()))
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][2], results[1][2])
    for k, g in results[0][1].items():
        torch.testing.assert_close(results[1][1][k], g, atol=1e-6, rtol=0)


def test_dropout_is_identity_in_eval_and_channelwise_in_training():
    cfg = Config(base_model="tiny", hidden_size=16, num_classes=4)
    torch.manual_seed(0)
    _, dec0 = build_models(cfg)
    _, dec = build_models(cfg.replace(dropout=0.5, dropout_cls=0.5,
                                      dropout_stop=0.5))
    dec.load_state_dict(dec0.state_dict())
    g = torch.Generator().manual_seed(0)
    skips = [torch.randn(2, c, s, s, generator=g)
             for c, s in zip((16, 16, 8, 4, 2), (2, 4, 8, 16, 32))]
    (want, _), (got, _) = dec0(skips), dec(skips)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    dec.train()
    with pytest.raises(ValueError, match="Generator"):
        dec(skips)
    (mask, _, _), _ = dec(skips, generator=g)
    assert not torch.equal(mask, want[0])
    x = torch.randn(4, 8, 5, 6, generator=g)
    y = port_decoder.dropout(x, 0.5, g, (4, 8, 1, 1))
    kept = (y != 0).flatten(2)
    assert (kept.all(-1) | ~kept.any(-1)).all()          # whole channels
    assert 0 < kept.all(-1).float().mean() < 1
    torch.testing.assert_close(y[kept.all(-1)], 2 * x[kept.all(-1)])
