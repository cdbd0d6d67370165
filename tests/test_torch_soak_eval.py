"""``cli/soak_eval`` against the calls ``scripts/soak_eval.py`` makes.

A tiny model (hidden 16, 5 classes, 64x64, T=4, fp32) trained for 40 JAX
steps (``pallas="off"``) on a synthetic train split, so that its label
maps hold instances, is carried across (``train_state_from_jax``) and
saved as the port's checkpoint. On the val split (8 images, up to 4
instances) the port's ``cli.soak_eval.main(..., device="cpu")`` and JAX's
``LeavesExporter(...).predicted_labels()`` and ``evaluate_batch`` give
identical label maps and SBD / |DiC| within 1e-9, and the printed JSON
line has JAX's keys. (Without a card ``main`` raises unless asked for the
CPU: ``tests/test_torch_port_rules.py``.)"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.data import DataLoader as JaxDataLoader
from rsis_tpu.data import get_dataset as jax_get_dataset
from rsis_tpu.evals.cvppp import evaluate_batch as jax_evaluate_batch
from rsis_tpu.evals.exporters import LeavesExporter as JaxLeavesExporter
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu.train import step as jax_step
from rsis_tpu_torch.cli import soak_eval
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.models.weights import train_state_from_jax
from rsis_tpu_torch.train.checkpoint import save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(dataset="synthetic", base_model="tiny", hidden_size=16,
          num_classes=5, imsize=64, resize=True, maxseqlen=4,
          gt_maxseqlen=6, batch_size=4, synthetic_length=8,
          synthetic_max_instances=4, compute_dtype="float32")
ARGV = ["-dataset", "synthetic", "-synthetic_length", "8",
        "-synthetic_max_instances", "4", "-num_classes", "5", "-imsize",
        "64", "--resize", "-maxseqlen", "4", "-gt_maxseqlen", "6",
        "-batch_size", "4", "-model_name", "m"]
EPOCHS = 20          # 2 batches an epoch: 40 steps


@pytest.fixture(scope="module")
def variables():
    """The JAX model after 40 train steps, numpy leaves."""
    jcfg = JaxConfig(**KW, pallas="off", lr=1e-2, lr_cnn=3e-3,
                     update_encoder=True)
    v = jax.jit(lambda key: jax_rsis.init_variables(jcfg, key))(
        jax.random.PRNGKey(0))
    state = jax_step.create_train_state(jcfg, v)
    train_step, _ = jax_step.make_train_step(jcfg, donate=False)
    flags = jax_step.StepFlags(jnp.float32(1), jnp.float32(1),
                               jnp.float32(1))
    ds = jax_get_dataset(jcfg, split="train", wire_dtype="uint8")
    for epoch in range(EPOCHS):
        for batch in JaxDataLoader(ds, batch_size=4, num_workers=1,
                                   seed=epoch):
            state, _ = train_step(state, batch, flags,
                                  jax.random.PRNGKey(epoch))
    return jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})


def _jax_soak_eval(variables):
    """scripts/soak_eval.py's calls on the same variables: (labels,
    scores)."""
    jcfg = JaxConfig(**KW, pallas="off")
    ds = jax_get_dataset(jcfg, split="val", augment=False)
    labels = JaxLeavesExporter(jcfg, variables, dataset=ds) \
        .predicted_labels()
    preds = [labels[os.path.basename(n)] for n in ds.get_sample_list()]
    gts = [np.asarray(ds.get_raw_sample(i)[1]) for i in range(len(preds))]
    return labels, jax_evaluate_batch(preds, gts)


def test_soak_eval_matches_jax(variables, tmp_path, capsys):
    cfg = Config(**KW, models_root=str(tmp_path), model_name="m")
    save_checkpoint(cfg, train_state_from_jax(cfg, variables, device="cpu"))
    got = soak_eval.main(ARGV + ["-models_root", str(tmp_path)],
                         device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["SBD", "absDiC", "n", "forward_s", "n_images"]
    assert {k: got[k] for k in line} == line

    want_labels, want = _jax_soak_eval(variables)
    assert sorted(got["labels"]) == sorted(want_labels)
    for name, lab in want_labels.items():
        np.testing.assert_array_equal(got["labels"][name], lab,
                                      err_msg=name)
    # the maps hold instances: the comparison is not of empty images
    assert sum(len(np.unique(v)) - 1 for v in want_labels.values()) >= 8
    assert line["n"] == line["n_images"] == 8
    for key in ("SBD", "absDiC"):
        assert abs(line[key] - want[key]) <= 1e-9, key
    assert line["SBD"] > 0
