"""The port's data-parallel train step (two gloo ranks on the CPU) against
the JAX package's sharded step, and against its own one-process step.

JAX's ``make_train_step(cfg, T, mesh=create_mesh(2))`` on the virtual CPU
mesh of ``tests/conftest.py`` computes what one device computes on the
whole global batch; the port's world-2 step, each rank on its 2 rows of
the B=4 batch (``tests/torch_dist_worker.py``), must do the same. The
setup is ``tests/test_torch_train_step.py``'s (tiny, 64x64, T=3, N=5,
hidden 16, pallas="off", SGD lr 1 without momentum history or decay, both
loss flags on) and so are the limits: metrics atol 1e-5, parameters 1e-4,
BatchNorm statistics 1e-5. Cases: both encoder gates, the eval step, and
the stop loss without ``stop_balance_weight`` (the global positive
fraction). After a step both ranks hold bit-identical parameters and
statistics. With device augmentation and the three dropouts on, the
world-2 step equals the port's world-1 step on the global batch (the same
generator seed: the draws are made at the global shape). With a resnet50
backbone (BatchNorm in every block) the world-2 step equals the world-1
step whose BatchNorm runs the same global-batch arithmetic
(``GlobalBatchNorm`` at one rank, under ``global_batch_stats``): at B=4
and 64x64 the backbone's deepest gradients are ill-conditioned, and two
BatchNorm implementations differ there by far more than the sharding
does. ``GlobalBatchNorm`` itself matches ``F.batch_norm`` at one rank on
well-conditioned input, and the float64 witness shows why the resnet50
gradients need the same arithmetic: in float64 the two BatchNorms give
the same step, while in fp32 each moves the backbone's gradients by
hundreds of thousandths of their max away from the float64 step, the
decoder's by under one. Last,
``cli.train.main([... "-num_devices", "2"], device="cpu")`` trains two
epochs whose ``metrics.jsonl`` losses match a one-process run's and
writes one checkpoint."""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu.parallel.mesh import create_mesh as jax_create_mesh
from rsis_tpu.train import step as jax_step
from rsis_tpu_torch.cli import train as port_cli
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.data.synthetic import synthetic_wire_batch
from rsis_tpu_torch.models.backbones import BatchNorm2d
from rsis_tpu_torch.models.rsis import build_models
from rsis_tpu_torch.models.weights import from_jax_variables
from rsis_tpu_torch.parallel.mesh import Group, global_batch_stats
from rsis_tpu_torch.train import step as port_step
from torch_dist_worker import join, start
from torch_threads import one_thread

T = 3
COMMON = dict(base_model="tiny", hidden_size=16, num_classes=4, imsize=64,
              maxseqlen=T, gt_maxseqlen=5, batch_size=4, optim="sgd",
              optim_cnn="sgd", lr=1.0, lr_cnn=1.0, momentum=0.9,
              weight_decay=0.0, weight_decay_cnn=0.0, update_encoder=True,
              use_class_loss=True, use_stop_loss=True)
NO_SBW = dict(COMMON, stop_balance_weight=None)
AUG = dict(COMMON, augment=True, dropout=0.2, dropout_cls=0.2,
           dropout_stop=0.2)
R50 = dict(AUG, base_model="resnet50")
CASES = [{"name": "gate1", "cfg": COMMON, "gate": 1.0},
         {"name": "gate0", "cfg": COMMON, "gate": 0.0},
         {"name": "nosbw", "cfg": NO_SBW, "gate": 1.0},
         {"name": "eval", "cfg": COMMON, "gate": 1.0, "eval": True},
         {"name": "aug", "cfg": AUG, "gate": 1.0, "seed": 7},
         {"name": "r50", "cfg": R50, "gate": 1.0, "seed": 7}]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded steps in this process; the port's two ranks in two
    worker processes on the same weights and global batch."""
    root = tmp_path_factory.mktemp("ddp")
    jcfg = JaxConfig(**COMMON, pallas="off")
    variables = _np_tree(jax.jit(lambda key: jax_rsis.init_variables(
        jcfg, key, (64, 64)))(jax.random.PRNGKey(0)))
    batch = synthetic_wire_batch(np.random.default_rng(0), 4, 64, 64, 5, 4)
    enc, dec = from_jax_variables(variables, "tiny")
    _save(root / "inputs.npz", batch, enc, dec)
    torch.manual_seed(0)
    r50 = tuple(m.state_dict() for m in build_models(Config(**R50)))
    _save(root / "r50.npz", batch, *r50)
    cases = [dict(c, inputs=str(root / "r50.npz")) if c["name"] == "r50"
             else c for c in CASES]
    # the ranks run while JAX compiles
    ranks = start({"world": 2, "mode": "step",
                   "inputs": str(root / "inputs.npz"), "cases": cases}, root)

    mesh = jax_create_mesh(2)
    want = {}
    rng = jax.random.PRNGKey(1)
    for cfg_kw, names in ((COMMON, (("gate1", 1.0), ("gate0", 0.0))),
                          (NO_SBW, (("nosbw", 1.0),))):
        jc = JaxConfig(**cfg_kw, pallas="off")
        train_step, eval_step = jax_step.make_train_step(
            jc, T=T, mesh=mesh, donate=False)
        for name, gate in names:
            flags = jax_step.StepFlags(use_class_loss=jnp.float32(1),
                                       use_stop_loss=jnp.float32(1),
                                       update_encoder=jnp.float32(gate))
            state = jax_step.create_train_state(jc, variables)
            new, metrics = train_step(state, batch, flags, rng)
            want[name] = (np.asarray(metrics), _np_tree(
                {"params": new.params, "batch_stats": new.batch_stats}))
            if name == "gate1":
                want["eval"] = np.asarray(eval_step(state, batch, flags,
                                                    rng))
    join(ranks)
    port = {c["name"]: [dict(np.load(root / f"{c['name']}_rank{r}.npz"))
                        for r in range(2)] for c in CASES}
    return {"port": port, "jax": want, "batch": batch,
            "weights": (enc, dec), "r50": r50}


def _save(path, batch, enc, dec):
    np.savez(path, img=batch[0], tgt=batch[1],
             **{f"enc.{k}": v.numpy() for k, v in enc.items()},
             **{f"dec.{k}": v.numpy() for k, v in dec.items()})


def _compare(got: dict, want_vars):
    enc_want, dec_want = from_jax_variables(want_vars, "tiny")
    for prefix, want in (("enc", enc_want), ("dec", dec_want)):
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            stat = key.endswith(("running_mean", "running_var"))
            np.testing.assert_allclose(
                got[f"{prefix}.{key}"], w.numpy(),
                atol=1e-5 if stat else 1e-4, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", ["gate1", "gate0", "nosbw"])
def test_world2_step_matches_jax_sharded_step(runs, name):
    want_metrics, want_vars = runs["jax"][name]
    got = runs["port"][name][0]
    np.testing.assert_allclose(got["metrics"], want_metrics, atol=1e-5,
                               rtol=0)
    _compare(got, want_vars)


def test_world2_eval_step_matches_jax(runs):
    np.testing.assert_allclose(runs["port"]["eval"][0]["metrics"],
                               runs["jax"]["eval"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_ranks_bit_identical_after_the_step(runs, name):
    r0, r1 = runs["port"][name]
    assert r0.keys() == r1.keys()
    for key in r0:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


@pytest.mark.parametrize("name", ["aug", "r50"])
def test_world2_matches_world1_with_augmentation_and_dropout(runs, name):
    """Device augmentation (K7's plain version here) and the three
    dropouts draw at the global batch's shape: the world-2 step is the
    world-1 step on the global batch (for resnet50, with its BatchNorm's
    arithmetic)."""
    cfg = Config(**(R50 if name == "r50" else AUG))
    weights = runs["r50"] if name == "r50" else runs["weights"]
    state = port_step.create_train_state(cfg, weights, device="cpu")
    train_step, _ = port_step.make_train_step(cfg, T=T, device="cpu")
    rng = torch.Generator().manual_seed(7)
    with (global_batch_stats(Group(0, 1, torch.device("cpu")))
          if name == "r50" else contextlib.nullcontext()):
        state, metrics = train_step(state, runs["batch"],
                                    port_step.StepFlags(1.0, 1.0, 1.0), rng)
    got = runs["port"][name][0]
    np.testing.assert_allclose(got["metrics"], metrics.numpy(), atol=1e-5,
                               rtol=0)
    for prefix, module in (("enc", state.encoder), ("dec", state.decoder)):
        for key, want in module.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            stat = key.endswith(("running_mean", "running_var"))
            np.testing.assert_allclose(
                got[f"{prefix}.{key}"], want.numpy(),
                atol=1e-5 if stat else 1e-4, rtol=0, err_msg=key)


def test_global_batch_norm_at_one_rank_matches_f_batch_norm():
    """GlobalBatchNorm alone (a one-rank group) against F.batch_norm:
    output, running statistics and the three cotangents."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 6, 5, 7, generator=gen) * 2.0 + 0.5
    dy = torch.randn(4, 6, 5, 7, generator=gen)
    weight = torch.rand(6, generator=gen) + 0.5
    bias = torch.rand(6, generator=gen) - 0.5
    outs = []
    for group in (None, Group(0, 1, torch.device("cpu"))):
        bn = BatchNorm2d(6).train()
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        xi = x.clone().requires_grad_()
        with (global_batch_stats(group) if group is not None
              else contextlib.nullcontext()):
            y = bn(xi)
        y.backward(dy)
        outs.append([y.detach(), bn.running_mean, bn.running_var, xi.grad,
                     bn.weight.grad, bn.bias.grad])
    for want, got in zip(*outs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)


def _units(got: dict, want: dict, keys) -> float:
    """The largest distance between two gradient dicts over ``keys``, in
    thousandths of each tensor's largest float64 magnitude (floored at
    1e-3 of the largest of all: the skip convs' biases feed BatchNorm and
    their true gradient is zero)."""
    top = max(w.abs().max().item() for w in want.values())
    return max((got[k].double() - want[k]).abs().max().item()
               / (1e-3 * max(want[k].abs().max().item(), 1e-3 * top))
               for k in keys)


def test_r50_batch_norm_arithmetics_against_a_float64_step(monkeypatch):
    """The r50 step of the world-2 tests (augmentation and dropouts on) at
    one rank, one thread, with F.batch_norm and with GlobalBatchNorm, in
    fp32 and in float64. Float64: the two BatchNorms give the same loss
    and gradients (1e-9 of each tensor's max), so GlobalBatchNorm's
    backward is F.batch_norm's. Fp32 against float64: the losses within
    1e-6 (relative) and the gradients outside the backbone within one
    thousandth of their max, but the backbone's within 0.4 of it (about
    0.26 for F.batch_norm, 0.10 for GlobalBatchNorm here): at B=4 its
    deepest gradients amplify any rounding, so a world-2 step is held to
    the world-1 step with its own arithmetic."""
    cfg = Config(**R50)
    torch.manual_seed(0)
    weights = tuple(m.state_dict() for m in build_models(cfg))
    batch = synthetic_wire_batch(np.random.default_rng(0), 4, 64, 64, 5, 4)
    got = {}
    with one_thread():
        for dtype in (torch.float64, torch.float32):
            monkeypatch.setattr(port_step, "compute_dtype",
                                lambda cfg, dtype=dtype: dtype)
            for name, group in (("f", None),
                                ("g", Group(0, 1, torch.device("cpu")))):
                state = port_step.create_train_state(cfg, weights,
                                                     device="cpu")
                state.encoder.to(dtype)
                state.decoder.to(dtype)
                with (global_batch_stats(group) if group is not None
                      else contextlib.nullcontext()):
                    total, _, grads = port_step.loss_and_grads(
                        cfg, state, batch, port_step.StepFlags(1.0, 1.0, 1.0),
                        T, rng=torch.Generator().manual_seed(7))
                assert {g.dtype for g in grads.values()} == {dtype}
                got[name, dtype] = (total.item(), grads)
    want_total, want = got["f", torch.float64]
    backbone = [k for k in want if k.startswith("encoder.base.")]
    rest = [k for k in want if k not in backbone]
    total64, g64 = got["g", torch.float64]
    assert abs(total64 - want_total) <= 1e-12 * abs(want_total)
    assert _units(g64, want, want) <= 1e-6
    for name in ("f", "g"):
        total32, g32 = got[name, torch.float32]
        dist = {part: _units(g32, want, keys)
                for part, keys in (("backbone", backbone), ("rest", rest))}
        print(f"fp32 {name}: loss {abs(total32 - want_total):.3e}, "
              f"gradients (thousandths of their max) {dist}")
        assert abs(total32 - want_total) <= 1e-6 * abs(want_total), name
        assert dist["rest"] <= 1.0, name
        assert dist["backbone"] <= 400.0, name


def _losses(path):
    with open(path) as fp:
        recs = [json.loads(line) for line in fp]
    return np.array([[r["total"], r["iou"], r["stop"], r["class"]]
                     for r in recs]), [(r["split"], r["epoch"], r["batch"])
                                       for r in recs]


def test_cli_train_num_devices_2_matches_one_process(tmp_path, monkeypatch):
    """Two epochs through ``cli.train`` on two CPU ranks against one
    process. SGD, not the default Adam: the skip convolutions' biases
    have a true gradient of zero (BatchNorm follows them), so each run's
    is rounding noise of its own arithmetic, which Adam scales to about lr
    a step; through the BatchNorm running means that moves the val losses
    by about 1e-5 within two epochs in any two correct runs
    (``tests/test_torch_step_variants.py`` bounds those biases by lr).
    SGD moves them by lr times the noise. Each process computes with one
    intra-op thread (``tests/torch_threads.py``): the spawned ranks read
    ``OMP_NUM_THREADS``."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["-dataset", "synthetic", "-base_model", "tiny", "-hidden_size",
            "16", "-num_classes", "3", "-imsize", "32", "-maxseqlen", "2",
            "-gt_maxseqlen", "5", "-batch_size", "4", "-max_epoch", "2",
            "-synthetic_length", "8", "-num_workers", "1", "-print_every",
            "1", "--log_term", "-class_loss_after", "0", "-stop_loss_after",
            "0", "-optim", "sgd", "-optim_cnn", "sgd", "-models_root",
            str(tmp_path)]
    with one_thread():
        port_cli.main(argv + ["-model_name", "one"], device="cpu")
        assert port_cli.main(argv + ["-model_name", "two", "-num_devices",
                                     "2"], device="cpu") is None
    one, events_one = _losses(tmp_path / "one" / "metrics.jsonl")
    two, events_two = _losses(tmp_path / "two" / "metrics.jsonl")
    assert events_two == events_one and len(events_one) == 8
    np.testing.assert_allclose(two, one, atol=1e-5, rtol=0)
    files = sorted(os.listdir(tmp_path / "two"))
    assert files == ["args.json", "decoder.pt", "encoder.pt",
                     "metrics.jsonl", "optim.pt"], files
