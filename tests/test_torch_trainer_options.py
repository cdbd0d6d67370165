"""The port's trainer with the options of this slice, against the JAX
package's ``Trainer`` (``pallas="off"``):

- both trainers from the same initial weights on a tiny synthetic run
  (tiny backbone, 32x32, B=4, T=2, 2 epochs, the encoder updated from
  epoch 0, a checkpoint after each epoch) with host-side
  augmentation (``--augment --host_augment``: both packages draw it from
  the dataset's numpy generator at ``seed`` 7, one loader thread) and
  ``--visdom`` (a mask snapshot per epoch, which draws one val batch, and
  the dashboard on an ephemeral port): the same event lines, and every
  loss printed within 1e-4; the dashboard's URL line, whose port differs,
  is left out;
- the port wrote one snapshot per epoch, of the expected grid size, and
  its dashboard serves them and ``metrics.jsonl``;
- ``--transfer`` from that run, its ``args.json`` set to another dataset,
  with ``num_classes=5`` (``tests/test_end_to_end.py::
  test_transfer_swaps_class_head``): the initial state equals the source
  checkpoint in every tensor but ``fc_class``, which has 5 outputs and
  equals a fresh init under ``cfg.seed``; the optimizer states are fresh;
  the transferred run trains; a source without a checkpoint falls
  through to a fresh start."""

import contextlib
import io
import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu.train import loop as jax_loop
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.models.rsis import init_weights
from rsis_tpu_torch.models.weights import from_jax_variables
from rsis_tpu_torch.train import loop as port_loop
from rsis_tpu_torch.train.checkpoint import load_weights, model_dir
from rsis_tpu_torch.utils.monitor import snapshot_size
from torch_threads import one_torch_thread  # noqa: F401

RUN = dict(dataset="synthetic", base_model="tiny", hidden_size=16,
           num_classes=3, imsize=32, resize=True, maxseqlen=2,
           gt_maxseqlen=5, batch_size=4, max_epoch=2, print_every=1,
           log_term=True, num_workers=1, synthetic_length=8, patience=0,
           class_loss_after=100, stop_loss_after=100,
           curriculum_learning=True, augment=True, augment_on_device=False,
           visdom=True, port=0, seed=7)


def _events(out: str):
    """(kind, text, numbers) of every log line but the config dump, the
    log-file notice and the dashboard's URL; 'iter' lines without their
    wall time."""
    events = []
    for line in out.splitlines():
        if not line or line.startswith(("{", "Training logs",
                                        "Dashboard live at")):
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


def _initial_variables(jcfg):
    """Seeded variables of the model's structure (``eval_shape``: no init
    is compiled): conv and dense kernels normal, BatchNorm at its init."""
    shapes = jax.eval_shape(
        lambda k: jax_rsis.init_variables(jcfg, k, (32, 32)),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(jcfg.seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['scale']", "['var']")):
            return np.ones(s.shape, np.float32)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return np.zeros(s.shape, np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers on the same weights: their stdout, the port's config
    and trainer (its dashboard still serving)."""
    root = tmp_path_factory.mktemp("options")
    jcfg = JaxConfig(**RUN, num_devices=1, pallas="off",
                     models_root=str(root / "jax"), model_name="m")
    variables = _initial_variables(jcfg)
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
    yield outs, cfg, trainers["port"]
    trainers["port"].dashboard.stop()


def test_trainer_with_host_augment_and_visdom_matches_jax(runs):
    outs, _, _ = runs
    got, want = _events(outs["port"]), _events(outs["jax"])
    assert [e[:2] for e in got] == [e[:2] for e in want]
    kinds = [e[0] for e in want]
    assert kinds.count("Saving checkpoint.") == 2
    assert "Starting to update encoder" in kinds
    assert not any("snapshot failed" in e[0] for e in got + want)
    assert sum(e[0].startswith("Epoch") and e[1] == "(val)"
               for e in want) == 2
    for (kind, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=kind)
    assert "Dashboard live at http://localhost:" in outs["port"]


def test_snapshots_and_dashboard(runs):
    from PIL import Image
    _, cfg, trainer = runs
    d = model_dir(cfg)
    names = ["masks_epoch0000.png", "masks_epoch0001.png"]
    for name in names:
        with Image.open(os.path.join(d, name)) as im:
            assert im.size == snapshot_size(2, 32, 32)
    base = f"http://localhost:{trainer.dashboard.port}"
    assert json.loads(urllib.request.urlopen(base + "/snapshots").read()) \
        == names
    with open(os.path.join(d, "metrics.jsonl")) as fp:
        want = [json.loads(ln) for ln in fp]
    assert json.loads(urllib.request.urlopen(base + "/metrics").read()) \
        == want
    assert len(want) == 2 * 2 * 2        # 2 epochs x 2 splits x 2 batches


def test_transfer_swaps_the_class_head(runs, capsys):
    _, cfg, _ = runs
    src = Config.load(os.path.join(model_dir(cfg), "args.json"))
    src.replace(dataset="leaves").save(os.path.join(model_dir(cfg),
                                                    "args.json"))
    dst = cfg.replace(model_name="dst", transfer=True, transfer_from="m",
                      num_classes=5, max_epoch=1, visdom=False)
    trainer = port_loop.Trainer(dst, device="cpu")
    state, start_cfg, epoch = trainer._initial_state(dst)
    assert start_cfg is dst and epoch == 0
    enc_src, dec_src = load_weights(cfg, "m")
    enc, dec = state.encoder.state_dict(), state.decoder.state_dict()
    assert list(enc) == list(enc_src) and list(dec) == list(dec_src)
    for k, v in enc_src.items():
        torch.testing.assert_close(enc[k], v, rtol=0, atol=0, msg=k)
    _, fresh = init_weights(dst, torch.Generator().manual_seed(dst.seed))
    for k, v in dec_src.items():
        want = fresh[k] if k.startswith("fc_class.") else v
        torch.testing.assert_close(dec[k], want, rtol=0, atol=0, msg=k)
    assert dec["fc_class.weight"].shape[0] == 5
    assert state.step == 0 and state.enc_opt["count"] == 0
    for opt in (state.enc_opt, state.dec_opt):
        for moments in (opt["mu"], opt["nu"]):
            assert all(not m.any() for m in moments.values())

    final = trainer.run()
    assert final.decoder.fc_class.out_features == 5
    assert Config.load(os.path.join(model_dir(dst),
                                    "args.json")).num_classes == 5
    capsys.readouterr()

    # a source without a checkpoint: the run starts fresh
    fresh_start = dst.replace(transfer_from="no_such_model")
    state, _, _ = port_loop.Trainer(fresh_start, device="cpu") \
        ._initial_state(fresh_start)
    enc_f, dec_f = init_weights(dst, torch.Generator().manual_seed(dst.seed))
    for got, want in ((state.encoder, enc_f), (state.decoder, dec_f)):
        for k, v in want.items():
            torch.testing.assert_close(got.state_dict()[k], v, rtol=0,
                                       atol=0, msg=k)
