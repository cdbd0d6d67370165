"""The port's evaluation entry points end to end on the CPU, tiny backbone:
the port's trainer (``cli.train``) writes a checkpoint (concat and mul
skips, 21 classes, synthetic data), then ``cli.eval`` (Pascal scored;
Cityscapes and CVPPP annotated only), ``cli.eval_cityscapes``,
``cli.eval_leaves`` and ``cli.predict`` run with ``device="cpu"`` on
miniature trees (``tests/torch_eval_trees.py``) and write their outputs; ``load_eval_variables`` resolves the same
``Config`` fields as the JAX package's from the same ``args.json``."""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import torch_eval_trees as trees
from rsis_tpu.cli import eval as jax_cli_eval
from rsis_tpu.config import config_from_args as jax_config_from_args
from rsis_tpu_torch.cli import eval as cli_eval
from rsis_tpu_torch.cli import eval_cityscapes, eval_leaves, predict
from rsis_tpu_torch.cli.train import main as train_main
from rsis_tpu_torch.config import Config, config_from_args
from rsis_tpu_torch.data.tools.palettes import pascal_palette
from rsis_tpu_torch.data.tools.pascal_precompute import run as precompute
from rsis_tpu_torch.kernels import mask as maskUtils
from rsis_tpu_torch.train.checkpoint import load_weights
from torch_threads import one_torch_thread  # noqa: F401

SKIPS = ["concat", "mul"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("evalcli"))
    data = {"leaves": trees.leaves_tree(root, n=98, s=40, w=50),
            "cityscapes": trees.cityscapes_tree(root, n=2, s=48, w=96),
            "pascal": trees.pascal_tree(root, pascal_palette(), s=40, w=52)}
    precompute(data["pascal"], "val")
    models = os.path.join(root, "models")
    for skip in SKIPS:
        train_main(["-dataset", "synthetic", "-base_model", "tiny",
                    "-hidden_size", "16", "-num_classes", "21", "-imsize",
                    "32", "-maxseqlen", "2", "-gt_maxseqlen", "4",
                    "-batch_size", "2", "-max_epoch", "1",
                    "-synthetic_length", "4", "-num_workers", "1",
                    "--log_term", "-skip_mode", skip, "-models_root",
                    models, "-model_name", skip], device="cpu")
    return root, models, data


def _argv(models, skip, *extra):
    return ["-model_name", skip, "-models_root", models, "-num_workers",
            "1", "-maxseqlen", "3", "-imsize", "32", *extra]


@pytest.mark.parametrize("skip", SKIPS)
def test_eval_pascal(setup, skip):
    root, models, data = setup
    stdout = sys.stdout
    res = cli_eval.main(_argv(models, skip, "-dataset", "pascal",
                              "-pascal_dir", data["pascal"], "-eval_split",
                              "val", "-batch_size", "2", "-stop_th", "0",
                              "-min_size", "0"), device="cpu")
    assert sys.stdout is stdout       # the log redirect is undone
    with open(os.path.join(models, skip, "eval.log")) as fp:
        log = fp.read()
    assert "Evaluating for 3 images" in log and "Average Precision" in log
    assert res["images"] == 3 and res["forward_s"] > 0
    assert len(res["stats"]) == 12 and np.isfinite(res["stats"]).all()


@pytest.mark.parametrize("dataset", ["leaves", "cityscapes"])
def test_eval_scores_only_pascal(setup, dataset, tmp_path):
    """``cli.eval`` runs the COCO evaluation on Pascal alone (the display
    recipes of Cityscapes and CVPPP run it without --no_run_coco_eval):
    on their trees it annotates as with the flag and returns no stats,
    where the JAX package's ``Evaluator.run_eval`` raises for want of
    ground truth."""
    from rsis_tpu.evals.evaluator import Evaluator as JaxEvaluator
    root, models, data = setup
    argv = _argv(models, "concat", "-dataset", dataset, f"-{dataset}_dir",
                 data[dataset], "-eval_split", "val", "-batch_size", "2",
                 "-stop_th", "0", "-min_size", "0", "--log_term")
    res = cli_eval.main(argv, device="cpu")
    flagged = cli_eval.main(argv + ["--no_run_coco_eval"], device="cpu")
    assert res["stats"] is None and res["annotations"] > 0
    assert res["images"] == flagged["images"] == 2
    assert res["annotations"] == flagged["annotations"]
    # JAX's evaluator, as its cli.eval calls it without the flag
    jax_cfg = jax_config_from_args(argv[:-1] + ["-pascal_dir",
                                                str(tmp_path)])
    ev = types.SimpleNamespace(cfg=jax_cfg, sample_list=["a"],
                               class_names=["bg", "fg"],
                               native_size=lambda name: (4, 4),
                               gt_anns=None)
    with pytest.raises(RuntimeError, match="no ground-truth annotations"):
        JaxEvaluator.run_eval(ev)


def test_eval_pascal_without_ground_truth_raises(setup):
    """Pascal without ``VOCGT_<split>.pkl`` (no precompute for the test
    split) raises as the JAX package's ``Evaluator.run_eval`` does."""
    root, models, data = setup
    assert not os.path.exists(os.path.join(data["pascal"],
                                           "VOCGT_test.pkl"))
    with pytest.raises(RuntimeError, match="no ground-truth annotations"):
        cli_eval.main(_argv(models, "concat", "-dataset", "pascal",
                            "-pascal_dir", data["pascal"], "-eval_split",
                            "test", "-batch_size", "2", "--log_term"),
                      device="cpu")


@pytest.mark.parametrize("skip", SKIPS)
def test_eval_cityscapes(setup, skip):
    root, models, data = setup
    res = eval_cityscapes.main(_argv(models, skip, "-dataset", "cityscapes",
                                     "-cityscapes_dir", data["cityscapes"],
                                     "-eval_split", "val", "-batch_size",
                                     "2", "--log_term"), device="cpu")
    assert [os.path.basename(p) for p in res["written"]] == [
        f"cityA_{i:06d}_000019_leftImg8bit.txt" for i in range(2)]
    for txt in res["written"]:
        with open(txt) as fp:
            lines = fp.read().splitlines()
        assert len(lines) == 3 * 8
        for ln in lines:
            png = os.path.join(os.path.dirname(txt), ln.split()[0])
            assert Image.open(png).size == (96, 48)
    assert 0.0 <= res["ap"]["allAp"] <= 1.0


@pytest.mark.parametrize("skip", SKIPS)
def test_eval_leaves(setup, skip):
    root, models, data = setup
    res = eval_leaves.main(_argv(models, skip, "-dataset", "leaves",
                                 "-leaves_dir", data["leaves"],
                                 "-eval_split", "val", "-batch_size", "2",
                                 "-class_th", "0", "--log_term"),
                           device="cpu")
    assert [os.path.basename(p) for p in res["written"]] == [
        "plant096_label.png", "plant097_label.png"]
    for p in res["written"]:
        assert Image.open(p).size == (50, 40)
    assert res["scores"]["n"] == 2
    assert np.isfinite([res["scores"]["SBD"], res["scores"]["absDiC"]]).all()


@pytest.mark.parametrize("skip", SKIPS)
def test_predict(setup, skip):
    root, models, data = setup
    out = os.path.join(root, f"pred_{skip}")
    images = os.path.join(data["leaves"], "plant00[0-2]_rgb.png")
    res = predict.main(_argv(models, skip, "-predict_input", images,
                             "-predict_output", out, "-batch_size", "2",
                             "--resize", "-stop_th", "-1", "-mask_th",
                             "0.4", "-min_size", "0", "--log_term"),
                       device="cpu")
    assert res["images"] == 3 and res["instances"] > 0
    assert sorted(os.listdir(out)) == [f"plant00{i}_rgb_instances.png"
                                       for i in range(3)] + [
                                           "predictions.json"]
    with open(res["written"]["json"]) as fp:
        anns = json.load(fp)
    assert len(anns) == res["instances"]
    label = np.array(Image.open(os.path.join(out,
                                             "plant000_rgb_instances.png")))
    mine = [a for a in anns if a["image_id"] == "plant000_rgb"]
    assert label.shape == (40, 50) and label.max() == len(mine)
    last = maskUtils.decode(mine[-1]["segmentation"])
    assert (label[last > 0] == len(mine)).all()


def test_load_eval_variables_equal_jax(setup, monkeypatch):
    root, models, data = setup
    argv = _argv(models, "mul", "-dataset", "leaves", "-base_model",
                 "resnet50", "-hidden_size", "64", "-num_classes", "3",
                 "-compute_dtype", "bfloat16", "-dropout", "0.3",
                 "-eval_split", "val", "-mask_th", "0.3", "-batch_size", "5")
    got, weights = cli_eval.load_eval_variables(config_from_args(argv))
    # the JAX function without its model and checkpoint: the config it
    # resolves from the same args.json
    monkeypatch.setattr(jax_cli_eval, "init_variables", lambda c, k: None)
    monkeypatch.setattr(jax_cli_eval, "create_train_state",
                        lambda c, v: None)
    state = types.SimpleNamespace(params=None, batch_stats=None)
    monkeypatch.setattr(jax_cli_eval, "load_checkpoint",
                        lambda c, t: (state, None))
    want, _ = jax_cli_eval.load_eval_variables(jax_config_from_args(argv))
    names = [f.name for f in dataclasses.fields(Config)]
    assert {k: getattr(got, k) for k in names} == {
        k: getattr(want, k) for k in names}
    # the architecture came from args.json, the rest from the invocation
    assert (got.base_model, got.hidden_size, got.num_classes,
            got.skip_mode, got.dropout) == ("tiny", 16, 21, "mul", 0.0)
    assert (got.mask_th, got.batch_size, got.maxseqlen) == (0.3, 5, 3)
    enc, dec = load_weights(got)
    for a, b in zip(weights, (enc, dec)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_make_forward_copies_weights_once(monkeypatch):
    from torch import nn
    from rsis_tpu_torch.evals.forward import HostForward, make_forward
    from rsis_tpu_torch.models.rsis import build_models
    cfg = Config(base_model="tiny", hidden_size=16, num_classes=4,
                 maxseqlen=2)
    torch.manual_seed(3)
    enc, dec = build_models(cfg)
    weights = (enc.state_dict(), dec.state_dict())
    loads = []
    real = nn.Module.load_state_dict

    def spy(self, *a, **k):
        loads.append(type(self).__name__)
        return real(self, *a, **k)

    monkeypatch.setattr(nn.Module, "load_state_dict", spy)
    fn = make_forward(cfg, device="cpu")
    x = np.random.default_rng(4).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    first = fn(weights, x)
    again = fn(weights, x)
    assert loads == ["FeatureExtractor", "RSISDecoder"]
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    # an in-place change to a weight is seen: that module is copied again
    weights[1]["fc_stop.bias"].add_(5.0)
    changed = fn(weights, x)
    assert loads[2:] == ["RSISDecoder"]
    assert not torch.equal(changed[2], first[2])
    # a module's own parameters count as well, and HostForward counts
    host = HostForward(cfg, device="cpu")
    out = host((enc, dec), x)
    assert [o.dtype for o in out] == [np.float32] * 3
    assert host.images == 1 and host.seconds > 0
