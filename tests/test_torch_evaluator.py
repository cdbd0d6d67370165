"""The port's evaluator and exporters against the JAX package's, host
logic only: masks that agree to 1e-4 can still flip at ``mask_th``, so
both sides get the same forward outputs. The JAX side runs its own jitted
forward (tiny model, fp32) and records every batch it saw and returned;
the port's side replays those outputs, after checking that its own
network input is the recorded one (exactly). Then, exactly:

- ``Evaluator.create_annotations`` gives equal annotations and
  ``run_eval`` equal COCO stats (Pascal, crop on);
- ``CityscapesExporter.export`` writes byte-equal files (the .txt indexes
  and every mask PNG) and ``evaluate_exported`` scores them alike;
- ``LeavesExporter.export`` writes byte-equal label PNGs,
  ``predicted_labels`` equal arrays, and ``evaluate_batch`` scores them
  alike;
- ``resize_mask``, ``largest_connected_component`` and
  ``resize_nearest`` equal JAX's on random masks."""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
from PIL import Image

import torch_eval_trees as trees
from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.evals import cityscapes_ap as jax_ap
from rsis_tpu.evals import cvppp as jax_cvppp
from rsis_tpu.evals import evaluator as jax_evaluator
from rsis_tpu.evals import exporters as jax_exporters
from rsis_tpu.models.rsis import init_variables
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.data.tools.palettes import pascal_palette
from rsis_tpu_torch.data.tools.pascal_precompute import run as precompute
from rsis_tpu_torch.evals import cityscapes_ap, cvppp, evaluator, exporters
from torch_threads import one_torch_thread  # noqa: F401

_VARIABLES = {}


def _configs(**kw):
    kw = {**dict(base_model="tiny", hidden_size=16, imsize=32, maxseqlen=3,
                 gt_maxseqlen=4, num_workers=1, seed=5, stop_th=0.0,
                 min_size=0.0), **kw}
    return Config(**kw), JaxConfig(**kw)


def _variables(jcfg):
    key = (jcfg.num_classes, jcfg.skip_mode)
    if key not in _VARIABLES:
        init = jax.jit(lambda k: init_variables(jcfg, k, (32, 32)))
        _VARIABLES[key] = init(jax.random.PRNGKey(0))
    return _VARIABLES[key]


def _record_and_replay(jax_side, port_side):
    """The JAX side's forward records (input, outputs); the port's
    checks its input against the recorded one and returns the outputs."""
    fwd = jax_side.forward
    seen = []

    def record(variables, x):
        out = tuple(np.asarray(a, np.float32) for a in fwd(variables, x))
        seen.append((np.array(x), out))
        return out

    def replay(variables, x):
        want_x, out = seen.pop(0)
        np.testing.assert_array_equal(x, want_x)
        return out

    jax_side.forward = record
    port_side.forward = replay
    return seen


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = trees.pascal_tree(str(tmp_path_factory.mktemp("voc")),
                             pascal_palette(), n=5, s=40, w=52)
    precompute(root, "val")
    return root


def test_evaluator_equal_jax(voc):
    cfg, jcfg = _configs(dataset="pascal", pascal_dir=voc, num_classes=21,
                         batch_size=2, eval_split="val", class_th=0.0)
    jev = jax_evaluator.Evaluator(jcfg, _variables(jcfg))
    pev = evaluator.Evaluator(cfg, None, device="cpu")
    seen = _record_and_replay(jev, pev)
    want = jev.create_annotations()
    assert len(seen) == 3       # 5 images in batches of 2
    got = pev.create_annotations()
    assert not seen
    assert len(got) > 20 and got == want
    assert pev.ignoremasks.keys() == jev.ignoremasks.keys()
    want_stats = _quiet(jev.run_eval)
    got_stats = _quiet(pev.run_eval)
    assert got_stats == want_stats
    assert len(got_stats["stats"]) == 12


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    return trees.cityscapes_tree(str(tmp_path_factory.mktemp("cs")), n=3,
                                 s=48, w=96)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as fp:
                out[os.path.relpath(os.path.join(d, n), root)] = fp.read()
    return out


def test_cityscapes_exporter_equal_jax(tmp_path, cityscapes):
    cfg, jcfg = _configs(dataset="cityscapes", cityscapes_dir=cityscapes,
                         num_classes=9, batch_size=2, eval_split="val",
                         model_name="cs", mask_th=0.45)
    jex = jax_exporters.CityscapesExporter(jcfg, _variables(jcfg))
    pex = exporters.CityscapesExporter(cfg, None, device="cpu")
    _record_and_replay(jex, pex)
    want = jex.export(str(tmp_path / "jax"))
    got = pex.export(str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    got_files = _files(tmp_path / "port")
    want_files = _files(tmp_path / "jax")
    assert len(got_files) == 3 + 3 * 3 * 8
    assert got_files == want_files
    names = [os.path.basename(p) for p in got]
    res = cityscapes_ap.evaluate_exported(str(tmp_path / "port"),
                                          pex.dataset.ins_files, names)
    assert res == jax_ap.evaluate_exported(str(tmp_path / "jax"),
                                           jex.dataset.ins_files, names)


@pytest.fixture(scope="module")
def leaves(tmp_path_factory):
    return trees.leaves_tree(str(tmp_path_factory.mktemp("leaves")), n=99,
                             s=40, w=50)


def test_leaves_exporter_equal_jax(tmp_path, leaves):
    cfg, jcfg = _configs(dataset="leaves", leaves_dir=leaves, num_classes=2,
                         batch_size=2, eval_split="val", class_th=0.45)
    jex = jax_exporters.LeavesExporter(jcfg, _variables(jcfg))
    pex = exporters.LeavesExporter(cfg, None, device="cpu")
    _record_and_replay(jex, pex)
    want = jex.export(str(tmp_path / "jax"))
    got = pex.export(str(tmp_path / "port"))
    assert len(got) == 3
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    want_labels = jex.predicted_labels()
    got_labels = pex.predicted_labels()
    assert got_labels.keys() == want_labels.keys()
    for k in got_labels:
        np.testing.assert_array_equal(got_labels[k], want_labels[k])
    preds = [np.array(Image.open(p)) for p in got]
    gts = [np.array(Image.open(f)) for f in pex.dataset.gt_files]
    assert cvppp.evaluate_batch(preds, gts) == jax_cvppp.evaluate_batch(
        [np.array(Image.open(p)) for p in want], gts)


def test_host_helpers_equal_jax():
    cfg, jcfg = _configs(min_size=0.01)
    rng = np.random.default_rng(9)
    for h, w in ((17, 23), (40, 31)):
        m = rng.random((12, 16)).astype(np.float32)
        ignore = (rng.random((h, w)) < 0.2).astype(np.uint8)
        for ign in (None, ignore):
            assert (evaluator.resize_mask(cfg, m, h, w, ign)
                    == jax_evaluator.resize_mask(jcfg, m, h, w, ign))
        binary = (m > 0.6).astype(np.uint8)
        np.testing.assert_array_equal(
            exporters.largest_connected_component(binary),
            jax_exporters.largest_connected_component(binary))
        np.testing.assert_array_equal(exporters.resize_nearest(m, h, w),
                                      jax_exporters.resize_nearest(m, h, w))
