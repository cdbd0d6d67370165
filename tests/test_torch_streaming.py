"""The port's H-sharded streaming forward (``evals/streaming.py``) against
the JAX package's unsharded forward, as ``tests/test_streaming.py`` holds
JAX's sharded one: tiny backbone, hidden 16, 3 classes, T=2, concat skips
(the kernels' decode: K1 cells, K2 head) and mul skips (the plain decode:
K8 cells, K2 on the NCHW state), at world 2 (64x128) and world 4
(128x128), each rank a gloo process (``tests/torch_dist_worker.py``);
limit 1e-4, the one ``tests/test_torch_forward.py`` holds the unsharded
port forward to. Each rank returns its own rows of the masks and the
replicated class and stop scores. resnet50 (the stem's 7x7/s2 conv, the
max pool and the bottlenecks' strided convs, each reading halo rows) at
world 2 against the port's own unsharded forward on the same weights, and
so an odd width (64x99: the masks are resized to the input's width after
the head, rows and all) and a vgg16 backbone with 5x5 gates (its 2x2 max
pools; the plain decode with two halo rows a side, the 5x5 head's
upsample and conv on the slab) at 128x64. An H that world x 32 does not
divide raises."""

import os

import jax
import numpy as np
import pytest
import torch

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.models import rsis as jax_rsis
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.evals.streaming import make_streaming_forward
from rsis_tpu_torch.models.rsis import build_models, forward
from rsis_tpu_torch.models.weights import from_jax_variables
from rsis_tpu_torch.parallel.mesh import Group
from torch_dist_worker import join, start
from torch_threads import one_torch_thread  # noqa: F401

T = 2
BASE = dict(base_model="tiny", hidden_size=16, num_classes=3, maxseqlen=T,
            imsize=64)
# (world, H, W, skip_mode)
CASES = [(2, 64, 128, "concat"), (2, 64, 128, "mul"),
         (4, 128, 128, "concat"), (4, 128, 128, "mul")]
R50 = dict(base_model="resnet50", hidden_size=16, num_classes=3,
           maxseqlen=T, skip_mode="concat")
K5 = dict(base_model="vgg16", hidden_size=16, num_classes=3, maxseqlen=T,
          skip_mode="concat", kernel_size=5)


def _name(world, h, w, mode):
    return f"w{world}_{h}x{w}_{mode}"


def _save(path, x, enc, dec):
    np.savez(path, x=x, **{f"enc.{k}": v.numpy() for k, v in enc.items()},
             **{f"dec.{k}": v.numpy() for k, v in dec.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("streaming")
    inputs, want, variables = {}, {}, {}
    for world, h, w, mode in CASES:
        name = _name(world, h, w, mode)
        jcfg = JaxConfig(**BASE, skip_mode=mode, pallas="off")
        if mode not in variables:   # the weights' shapes do not depend on HW
            variables[mode] = jax.tree.map(np.asarray, jax.jit(
                lambda k, jcfg=jcfg: jax_rsis.init_variables(
                    jcfg, k, (64, 64)))(jax.random.PRNGKey(0)))
        v = variables[mode]
        x = np.random.default_rng(world).normal(size=(2, h, w, 3)).astype(
            np.float32)
        _save(root / f"{name}.npz", x, *from_jax_variables(v, "tiny"))
        inputs[name] = (jcfg, v, x)
    torch.manual_seed(0)
    enc, dec = build_models(Config(**R50))
    x50 = np.random.default_rng(5).normal(size=(1, 64, 96, 3)).astype(
        np.float32)
    _save(root / "r50.npz", x50, enc.state_dict(), dec.state_dict())
    odd = Config(**BASE, skip_mode="concat")
    enc_o, dec_o = build_models(odd)
    x_odd = np.random.default_rng(6).normal(size=(2, 64, 99, 3)).astype(
        np.float32)
    _save(root / "odd.npz", x_odd, enc_o.state_dict(), dec_o.state_dict())
    enc_k, dec_k = build_models(Config(**K5))
    x_k5 = np.random.default_rng(7).normal(size=(1, 128, 64, 3)).astype(
        np.float32)
    _save(root / "k5.npz", x_k5, enc_k.state_dict(), dec_k.state_dict())

    ranks = []
    for world in (2, 4):
        cases = [{"name": _name(*c), "cfg": dict(BASE, skip_mode=c[3]),
                  "T": T, "inputs": str(root / f"{_name(*c)}.npz")}
                 for c in CASES if c[0] == world]
        if world == 2:
            cases.append({"name": "r50", "cfg": R50, "T": T,
                          "inputs": str(root / "r50.npz")})
            cases.append({"name": "odd", "cfg": dict(BASE,
                                                     skip_mode="concat"),
                          "T": T, "inputs": str(root / "odd.npz")})
            cases.append({"name": "k5", "cfg": K5, "T": T,
                          "inputs": str(root / "k5.npz")})
        sub = root / f"w{world}"
        os.makedirs(sub)
        ranks.append((world, sub, start(
            {"world": world, "mode": "streaming", "cases": cases}, sub)))

    # the unsharded forwards while the ranks run
    for name, (jcfg, v, x) in inputs.items():
        want[name] = [np.asarray(t) for t in jax.jit(
            lambda v, x, jcfg=jcfg: jax_rsis.forward(jcfg, v, x, T=T))(v, x)]
    want["r50"] = [t.numpy() for t in forward(
        Config(**R50), enc, dec,
        torch.from_numpy(x50).permute(0, 3, 1, 2).contiguous(), T=T)]
    want["odd"] = [t.numpy() for t in forward(
        odd, enc_o, dec_o,
        torch.from_numpy(x_odd).permute(0, 3, 1, 2).contiguous(), T=T)]
    want["k5"] = [t.numpy() for t in forward(
        Config(**K5), enc_k, dec_k,
        torch.from_numpy(x_k5).permute(0, 3, 1, 2).contiguous(), T=T)]

    got = {}
    for world, sub, procs in ranks:
        join(procs)
        for name in os.listdir(sub):
            if name.endswith("_rank0.npz"):
                case = name[:-len("_rank0.npz")]
                got[case] = [dict(np.load(sub / f"{case}_rank{r}.npz"))
                             for r in range(world)]
    return got, want


@pytest.mark.parametrize("case", CASES, ids=[_name(*c) for c in CASES])
def test_streaming_matches_jax_unsharded_forward(runs, case):
    got, want = runs
    name = _name(*case)
    masks = np.concatenate([r["masks"] for r in got[name]], axis=2)
    assert masks.shape == want[name][0].shape == (2, T) + case[1:3]
    np.testing.assert_allclose(masks, want[name][0], atol=1e-4)
    for r in got[name]:
        np.testing.assert_allclose(r["clss"], want[name][1], atol=1e-4)
        np.testing.assert_allclose(r["stops"], want[name][2], atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=[_name(*c) for c in CASES])
def test_each_rank_returns_its_own_rows(runs, case):
    got, want = runs
    world, h = case[0], case[1]
    rows = h // world
    for rank, r in enumerate(got[_name(*case)]):
        assert r["masks"].shape == (2, T, rows, case[2])
        np.testing.assert_allclose(
            r["masks"], want[_name(*case)][0][:, :, rank * rows:
                                              (rank + 1) * rows], atol=1e-4)
        # the scores are replicated: every rank's are rank 0's
        np.testing.assert_array_equal(r["clss"], got[_name(*case)][0]["clss"])


@pytest.mark.parametrize("name", ["r50", "odd", "k5"])
def test_matches_the_ports_unsharded_forward(runs, name):
    got, want = runs
    masks = np.concatenate([r["masks"] for r in got[name]], axis=2)
    assert masks.shape == want[name][0].shape
    np.testing.assert_allclose(masks, want[name][0], atol=1e-4)
    for r in got[name]:
        np.testing.assert_allclose(r["clss"], want[name][1], atol=1e-4)
        np.testing.assert_allclose(r["stops"], want[name][2], atol=1e-4)


@pytest.mark.parametrize("world,h", [(2, 96), (4, 64), (1, 48)])
def test_height_not_divisible_by_world_x_32_raises(world, h):
    cfg = Config(**BASE)
    enc, dec = build_models(cfg)
    run = make_streaming_forward(cfg, Group(0, world, torch.device("cpu")),
                                 T=T)
    with pytest.raises(ValueError, match="divisible"):
        run((enc, dec), np.zeros((1, h, 64, 3), np.float32))
