"""The repository's nine run recipes (``scripts/*.sh``) through the port
(``rsis_tpu_torch/recipes.py``):

- ``RECIPES`` holds each script's module and argument list, letter for
  letter, with ``rsis_tpu.cli.X`` mapped to ``rsis_tpu_torch.cli.X``;
- each recipe's argv parses to the same value of every field the two
  ``Config``s share, under the port's parser and the JAX package's;
- the reference's ``-ngpus``, ``--cpu`` and ``-server`` land in the same
  fields in both packages, and ``-pallas`` and ``-checkpoint_format``
  stay refused;
- ``run`` appends its flags, passes the device and, asked for none,
  needs a card;
- the CVPPP train recipe (``train_leaves``) on a tiny CVPPP tree, the
  port's trainer against JAX's (``pallas="off"``) from the same weights,
  event by event within 1e-4: tiny backbone, hidden 16, B=4, 2 epochs,
  ``-imsize 40``, whose tiny pyramid is 20/10/5/3/2 (two odd levels, as
  400's resnet101 pyramid 200/100/50/25/13 has); everything else is the
  recipe's (``--resize``, curriculum learning, ``-stop_weight 0.1``,
  ``-class_loss_after -1``, gt_maxseqlen 20, augmentation). The
  augmentation runs on the host (``--host_augment``, one loader thread),
  where the two packages draw the same bytes; on the device their
  generators differ.
"""

import contextlib
import io
import os
import shlex

import jax
import numpy as np
import pytest

from rsis_tpu.config import config_from_args as jax_config_from_args
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu.train import loop as jax_loop
from rsis_tpu_torch import recipes
from rsis_tpu_torch.config import config_from_args
from rsis_tpu_torch.models.weights import from_jax_variables
from rsis_tpu_torch.train import loop as port_loop
from torch_eval_trees import leaves_tree
from torch_threads import one_torch_thread  # noqa: F401

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def _script_command(name):
    """(module, argv) of the ``python -m`` line of ``scripts/<name>.sh``."""
    with open(os.path.join(SCRIPTS, name + ".sh")) as fp:
        text = fp.read().replace("\\\n", " ")
    lines = [ln for ln in text.splitlines() if ln.startswith("python")]
    assert len(lines) == 1, lines
    words = shlex.split(lines[0])
    assert words[:2] == ["python", "-m"]
    return words[2], words[3:]


def test_every_script_has_a_recipe():
    stems = sorted(f[:-3] for f in os.listdir(SCRIPTS)
                   if f.startswith(("train_", "eval_", "display_"))
                   and f.endswith(".sh"))
    assert stems == sorted(recipes.RECIPES)


@pytest.mark.parametrize("name", sorted(recipes.RECIPES))
def test_recipe_equals_its_script(name):
    module, argv = _script_command(name)
    cli, want = recipes.RECIPES[name]
    assert module == "rsis_tpu.cli." + cli
    assert argv == want


def _shared_fields(argv):
    got = config_from_args(argv).to_dict()
    want = jax_config_from_args(argv).to_dict()
    shared = sorted(set(got) & set(want))
    return ({k: got[k] for k in shared}, {k: want[k] for k in shared})


@pytest.mark.parametrize("name", sorted(recipes.RECIPES))
def test_recipe_parses_as_in_jax(name):
    got, want = _shared_fields(recipes.argv(name))
    assert got == want
    # the flags after the recipe's win
    extra = ["-max_epoch", "2", "-models_root", "/tmp/m"]
    cfg = config_from_args(recipes.argv(name, extra))
    assert (cfg.max_epoch, cfg.models_root) == (2, "/tmp/m")


@pytest.mark.parametrize("argv,field,value", [
    (["-ngpus", "4"], "ngpus", 4),
    (["--cpu"], "use_gpu", False),
    (["-server", "http://h"], "server", "http://h")])
def test_compatibility_flags_as_in_jax(argv, field, value):
    got, want = _shared_fields(argv)
    assert got == want and got[field] == value


def test_refused_flags_stay_refused():
    for argv in (["-pallas", "off"], ["-checkpoint_format", "orbax"]):
        with pytest.raises(SystemExit):
            config_from_args(argv)


def test_run_without_device_needs_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        recipes.run("eval_leaves", ["-models_root", str(tmp_path)])


def test_run_passes_the_flags_and_device(monkeypatch):
    from rsis_tpu_torch.cli import eval_leaves
    calls = []
    monkeypatch.setattr(eval_leaves, "main",
                        lambda argv, device=None: calls.append((argv,
                                                                device)))
    recipes.run("eval_leaves", ["-imsize", "64"], device="cpu")
    assert calls == [(recipes.argv("eval_leaves", ["-imsize", "64"]),
                      "cpu")]
    assert recipes.main(["no_such_recipe"]) == 2


def _events(out: str):
    """(kind, text, numbers) of every log line but the config dump; 'iter'
    lines without their wall time."""
    events = []
    for line in out.splitlines():
        if not line or line.startswith("{"):
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


IMSIZE = 40


@pytest.fixture(scope="module")
def leaves_runs(tmp_path_factory):
    """``train_leaves`` at tiny width through both trainers from the same
    weights; their stdout."""
    root = tmp_path_factory.mktemp("recipes")
    # 96 plants train, 4 validate (one batch of 4)
    data = leaves_tree(str(root), n=100, s=46, w=44, seed=3)
    extra = ["-leaves_dir", data, "-base_model", "tiny", "-hidden_size",
             "16", "-batch_size", "4", "-imsize", str(IMSIZE),
             "-max_epoch", "2", "--host_augment", "-num_workers", "1",
             "-seed", "5"]
    argv = recipes.argv("train_leaves", extra)
    jcfg = jax_config_from_args(argv + ["-models_root",
                                        str(root / "jax")]).replace(
        num_devices=1, pallas="off")
    cfg = config_from_args(argv + ["-models_root", str(root / "port")])
    init = jax.jit(lambda k: jax_rsis.init_variables(jcfg, k,
                                                     (IMSIZE, IMSIZE)))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
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
    return outs, cfg


def test_leaves_recipe_trains_as_in_jax(leaves_runs):
    outs, cfg = leaves_runs
    assert (cfg.dataset, cfg.resize, cfg.curriculum_learning,
            cfg.stop_weight, cfg.class_loss_after, cfg.gt_maxseqlen,
            cfg.augment) == ("leaves", True, True, 0.1, -1, 20, True)
    got, want = _events(outs["port"]), _events(outs["jax"])
    assert [e[:2] for e in got] == [e[:2] for e in want]
    kinds = [e[0] for e in want]
    assert "Starting to update encoder" in kinds
    assert "Starting to learn class loss" not in kinds
    assert sum(e[0].startswith("Epoch") and e[1] == "(val)"
               for e in want) == 2
    for (kind, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=kind)
