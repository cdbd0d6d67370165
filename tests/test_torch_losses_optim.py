"""The port's losses (rsis_tpu_torch/ops/losses.py) against
rsis_tpu/ops/losses.py, and its optimizers (rsis_tpu_torch/train/optim.py)
against the optax chains of rsis_tpu/train/optim.py::make_optimizer.

- every loss on the same numpy inputs, fp32 (atol 1e-6), bf16 logits for
  the ones the step feeds bf16 (atol 1e-5: fp32 sums in another order);
- adam, sgd (with and without momentum) and rmsprop with L2 decay, three
  steps on random tensors, atol 1e-6;
- the update_encoder gate over three steps (closed, open, closed): the
  backbone's parameters and optimizer state stay while it is closed, as
  the JAX step's where-select keeps them, while the rest moves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsis_tpu.ops import losses as jl
from rsis_tpu.train.optim import make_optimizer
from rsis_tpu.train.optim import split_params as jax_split
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.ops import losses as tl
from rsis_tpu_torch.train import optim as topt
from torch_threads import one_torch_thread  # noqa: F401


def _loss_inputs(seed=0, b=6, n=3, hw=50, k=4):
    rng = np.random.default_rng(seed)
    return {
        "target": (rng.random((b, hw)) > 0.6).astype(np.float32),
        "logits": (rng.normal(size=(b, hw)) * 2).astype(np.float32),
        "y_stack": (rng.random((b, n, hw)) > 0.6).astype(np.uint8),
        "probs": np.array(jax.nn.softmax(rng.normal(size=(b, k))),
                          dtype=np.float32),
        "idx": rng.integers(0, k, size=b).astype(np.int32),
        "balance": rng.random(k).astype(np.float32),
        "stop_target": (rng.random(b) > 0.5).astype(np.float32),
        "stop_logits": rng.normal(size=b).astype(np.float32),
        "sw": (rng.random(b) > 0.3).astype(np.float32),
    }


def _pair(a):
    return torch.from_numpy(np.asarray(a)), jnp.asarray(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_soft_iou_costs_match_jax(dtype):
    d = _loss_inputs()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-5
    t_tgt, j_tgt = _pair(d["target"])
    t_log, j_log = _pair(d["logits"])
    np.testing.assert_allclose(
        tl.soft_iou_cost(t_tgt, t_log.to(tdt)).numpy(),
        np.asarray(jl.soft_iou_cost(j_tgt, j_log.astype(jdt))), atol=tol)
    # the matcher's cost column: GT stack in the compute dtype, counts fp32
    t_y, j_y = _pair(d["y_stack"])
    got = tl.soft_iou_cost_matmul(t_y.sum(-1, dtype=torch.float32),
                                  t_y.to(tdt), t_log.to(tdt))
    want = jl.soft_iou_cost_matmul(jnp.sum(j_y, -1, dtype=jnp.float32),
                                   j_y.astype(jdt), j_log.astype(jdt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    np.testing.assert_allclose(
        tl.soft_iou_loss(t_tgt, t_log.to(tdt), _pair(d["sw"])[0]).numpy(),
        np.asarray(jl.soft_iou_loss(j_tgt, j_log.astype(jdt),
                                    jnp.asarray(d["sw"]))), atol=tol)


@pytest.mark.parametrize("balance", [False, True])
def test_nll_matches_jax(balance):
    d = _loss_inputs(1)
    bw = d["balance"] if balance else None
    t_bw = None if bw is None else torch.from_numpy(bw)
    j_bw = None if bw is None else jnp.asarray(bw)
    np.testing.assert_allclose(
        tl.masked_nll(torch.from_numpy(d["idx"]),
                      torch.from_numpy(d["probs"]), t_bw).numpy(),
        np.asarray(jl.masked_nll(jnp.asarray(d["idx"]),
                                 jnp.asarray(d["probs"]), j_bw)), atol=1e-6)
    np.testing.assert_allclose(
        tl.masked_nll_loss(torch.from_numpy(d["idx"]),
                           torch.from_numpy(d["probs"]),
                           torch.from_numpy(d["sw"]), t_bw).numpy(),
        np.asarray(jl.masked_nll_loss(jnp.asarray(d["idx"]),
                                      jnp.asarray(d["probs"]),
                                      jnp.asarray(d["sw"]), j_bw)),
        atol=1e-6)


@pytest.mark.parametrize("balance_weight", [None, 0.5, 0.2])
def test_bce_matches_jax(balance_weight):
    d = _loss_inputs(2)
    tgt, logits, sw = d["stop_target"], d["stop_logits"], d["sw"]
    np.testing.assert_allclose(
        tl.balanced_bce(torch.from_numpy(tgt), torch.from_numpy(logits),
                        balance_weight).numpy(),
        np.asarray(jl.balanced_bce(jnp.asarray(tgt), jnp.asarray(logits),
                                   balance_weight)), atol=1e-6)
    np.testing.assert_allclose(
        tl.masked_bce_loss(torch.from_numpy(tgt), torch.from_numpy(logits),
                           torch.from_numpy(sw), balance_weight).numpy(),
        np.asarray(jl.masked_bce_loss(jnp.asarray(tgt), jnp.asarray(logits),
                                      jnp.asarray(sw), balance_weight)),
        atol=1e-6)


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


@pytest.mark.parametrize("name,momentum", [("adam", 0.9), ("sgd", 0.9),
                                           ("sgd", 0.0), ("rmsprop", 0.9)])
def test_optimizer_matches_optax(name, momentum):
    lr, wd = 1e-2, 1e-3
    p_np = _params(0)
    tx = make_optimizer(name, lr, wd, momentum)
    p_j = {k: jnp.asarray(v) for k, v in p_np.items()}
    s_j = tx.init(p_j)
    p_t = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    s_t = topt.init_state(name, p_t, momentum)
    for step in range(3):
        g_np = _params(10 + step)
        upd, s_j = tx.update({k: jnp.asarray(v) for k, v in g_np.items()},
                             s_j, p_j)
        p_j = jax.tree.map(lambda p, u: p + u, p_j, upd)
        s_t = topt.apply_updates(name, lr, wd, momentum, p_t,
                                 {k: torch.from_numpy(v)
                                  for k, v in g_np.items()}, s_t)
        for k in p_np:
            np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{name} step {step} {k}")


def test_split_params_matches_jax():
    """The backbone alone is the encoder group; the skip convolutions and
    their BatchNorms train with the decoder."""
    port_names = ["encoder.base.conv0.weight", "encoder.sk5.weight",
                  "encoder.bn5.bias", "decoder.fc_stop.weight"]
    enc, dec = topt.split_params({k: torch.zeros(1) for k in port_names})
    tree = {"encoder": {"base": {"conv0": 0}, "sk5": 0, "bn5": 0},
            "decoder": {"fc_stop": 0}}
    j_enc, j_dec = jax_split(tree)
    assert list(enc) == ["encoder.base.conv0.weight"]
    assert list(j_enc["encoder"]) == ["base"] and "decoder" not in j_enc
    assert sorted(dec) == sorted(port_names[1:])
    assert sorted(j_dec["encoder"]) == ["bn5", "sk5"]


@pytest.mark.parametrize("optim_cnn", ["adam", "sgd"])
def test_update_encoder_gate_matches_jax(optim_cnn):
    cfg = Config(optim="adam", optim_cnn=optim_cnn, lr=1e-2, lr_cnn=1e-1,
                 weight_decay=1e-3, weight_decay_cnn=1e-2, momentum=0.9)
    enc_tx = make_optimizer(cfg.optim_cnn, cfg.lr_cnn, cfg.weight_decay_cnn,
                            cfg.momentum)
    dec_tx = make_optimizer(cfg.optim, cfg.lr, cfg.weight_decay,
                            cfg.momentum)
    start = {"encoder.base.w": _params(0)["w"], "encoder.sk5.w":
             _params(1)["w"], "decoder.fc.b": _params(2)["b"]}
    p_t = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    enc_t, dec_t = topt.split_params(p_t)
    s_enc = topt.init_state(cfg.optim_cnn, enc_t, cfg.momentum)
    s_dec = topt.init_state(cfg.optim, dec_t, cfg.momentum)
    p_j = {k: jnp.asarray(v) for k, v in start.items()}

    def groups(p):
        enc = {k: v for k, v in p.items() if k.startswith("encoder.base.")}
        return enc, {k: v for k, v in p.items() if k not in enc}

    enc_j, dec_j = groups(p_j)
    o_enc, o_dec = enc_tx.init(enc_j), dec_tx.init(dec_j)
    for step, gate in enumerate((0.0, 1.0, 0.0)):
        g_np = {k: np.random.default_rng(20 + step).normal(
            size=v.shape).astype(np.float32) for k, v in start.items()}
        # the JAX step's update (rsis_tpu/train/step.py:375-388)
        enc_g, dec_g = groups({k: jnp.asarray(v) for k, v in g_np.items()})
        enc_j, dec_j = groups(p_j)
        du, o_dec = dec_tx.update(dec_g, o_dec, dec_j)
        eu, o_enc_new = enc_tx.update(enc_g, o_enc, enc_j)
        enc_new = jax.tree.map(lambda p, u: p + u, enc_j, eu)
        enc_j = jax.tree.map(lambda a, b: gate * a + (1.0 - gate) * b,
                             enc_new, enc_j)
        o_enc = jax.tree.map(lambda a, b: jnp.where(gate > 0, a, b),
                             o_enc_new, o_enc)
        p_j = {**enc_j, **jax.tree.map(lambda p, u: p + u, dec_j, du)}

        before = p_t["encoder.base.w"].clone()
        s_enc, s_dec = topt.update_groups(
            cfg, p_t, {k: torch.from_numpy(v) for k, v in g_np.items()},
            s_enc, s_dec, gate)
        if not gate:
            assert torch.equal(p_t["encoder.base.w"], before)
        for k in start:
            np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"step {step} {k}")
    if optim_cnn == "adam":   # one open step: the count moved once
        assert s_enc["count"] == 1
