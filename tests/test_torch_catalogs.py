"""The port's file-backed catalogs against the JAX package's, on miniature
trees (``tests/torch_eval_trees.py``):

- ``pascal_precompute`` writes byte-equal ``ProcMasks/*.npy`` files and an
  equal ``VOCGT_<split>.pkl``;
- ``PascalVOC``, ``CityScapes`` and ``LeavesDataset`` give equal raw
  samples (image, instance map, class map) and equal network inputs with
  the crop on: the port's uint8 image normalised is JAX's float image and
  its uint8 packed target is JAX's float target, exactly, sample after
  sample from one seeded generator on each side;
- the Cityscapes remapping (caravan and trailer dropped, a crowd region
  dropped, ids renumbered densely) equals JAX's."""

import os
import pickle
import shutil

import numpy as np
import pytest
from PIL import Image

import torch_eval_trees as trees
from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.data import catalogs as jax_catalogs
from rsis_tpu.data.tools.pascal_precompute import run as jax_precompute
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.data import catalogs
from rsis_tpu_torch.data.base import normalize_image
from rsis_tpu_torch.data.tools.palettes import pascal_palette
from rsis_tpu_torch.data.tools.pascal_precompute import run as precompute
from torch_threads import one_torch_thread  # noqa: F401


def _pair(**kw):
    kw = dict(gt_maxseqlen=5, seed=7, **kw)
    return Config(**kw), JaxConfig(**kw)


def _same_samples(port, jax_ds, n):
    assert len(port) == len(jax_ds) == n
    assert port.get_sample_list() == jax_ds.get_sample_list()
    assert port.get_classes() == jax_ds.get_classes()
    for i in range(n):
        img, ins, seg = port.get_raw_sample(i)
        jimg, jins, jseg = jax_ds.get_raw_sample(i)
        np.testing.assert_array_equal(img, np.asarray(jimg))
        np.testing.assert_array_equal(ins, jins)
        np.testing.assert_array_equal(seg, jseg)
    for i in range(n):   # one generator each: crops drawn in this order
        img, tgt = port[i]
        jimg, jtgt = jax_ds[i]
        assert img.dtype == np.uint8 and jimg.dtype == np.float32
        np.testing.assert_array_equal(normalize_image(img), jimg)
        np.testing.assert_array_equal(tgt.astype(np.float32), jtgt)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """Two copies of one VOC tree, precomputed by each package."""
    root = tmp_path_factory.mktemp("voc")
    mine = trees.pascal_tree(str(root), pascal_palette(), s=40, w=52)
    theirs = str(root / "voc_jax")
    shutil.copytree(mine, theirs)
    return mine, precompute(mine, "val"), theirs, jax_precompute(theirs,
                                                                 "val")


def test_pascal_precompute_equal_jax(voc):
    mine, pkl, theirs, jax_pkl = voc
    names = sorted(os.listdir(os.path.join(theirs, "ProcMasks")))
    assert names == sorted(os.listdir(os.path.join(mine, "ProcMasks")))
    assert len(names) == 3
    for n in names:
        with open(os.path.join(mine, "ProcMasks", n), "rb") as a, \
                open(os.path.join(theirs, "ProcMasks", n), "rb") as b:
            assert a.read() == b.read()
    with open(pkl, "rb") as a, open(jax_pkl, "rb") as b:
        got, want = pickle.load(a), pickle.load(b)
    assert got == want
    assert any(ann.get("ignore") == 1 for ann in got)
    assert os.path.basename(pkl) == "VOCGT_val.pkl"


@pytest.mark.parametrize("resize", [False, True])
def test_pascal_samples_equal_jax(voc, resize):
    cfg, jcfg = _pair(dataset="pascal", pascal_dir=voc[0], batch_size=2,
                      imsize=24, resize=resize)
    port = catalogs.get_dataset(cfg, "val")
    assert port.crop
    _same_samples(port, jax_catalogs.get_dataset(jcfg, "val"), 3)


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    return trees.cityscapes_tree(str(tmp_path_factory.mktemp("cs")), n=3,
                                 s=48, w=96)


@pytest.mark.parametrize("crop", [True, False])
def test_cityscapes_samples_equal_jax(cityscapes, crop):
    cfg, jcfg = _pair(dataset="cityscapes", cityscapes_dir=cityscapes,
                      batch_size=2, imsize=32, crop=crop)
    port = catalogs.get_dataset(cfg, "val")
    _same_samples(port, jax_catalogs.get_dataset(jcfg, "val"), 3)


def test_cityscapes_remapping(cityscapes):
    cfg, _ = _pair(dataset="cityscapes", cityscapes_dir=cityscapes,
                   imsize=32)
    ds = catalogs.get_dataset(cfg, "val")
    for i in range(len(ds)):
        raw = np.asarray(Image.open(ds.ins_files[i]))
        _, ins, seg = ds.get_raw_sample(i)
        # persons (24) -> 1 and cars (26) -> 3 keep their pixels; the
        # caravan (29), the trailer (30) and the crowd region become 0
        np.testing.assert_array_equal(seg[raw == 24000], 1)
        np.testing.assert_array_equal(seg[raw == 26003], 3)
        for dropped in (29001, 30000, 24):
            assert not ins[raw == dropped].any()
            assert not seg[raw == dropped].any()
        kept = [v for v in (24000, 26003) if (raw == v).any()]
        assert sorted(np.unique(ins)) == list(range(len(kept) + 1))


@pytest.fixture(scope="module")
def leaves(tmp_path_factory):
    return trees.leaves_tree(str(tmp_path_factory.mktemp("leaves")), n=99,
                             s=40, w=50)


@pytest.mark.parametrize("split,resize", [("val", False), ("val", True),
                                          ("test", False)])
def test_leaves_samples_equal_jax(leaves, split, resize):
    test_dir = leaves if split == "test" else "/nonexistent"
    cfg, jcfg = _pair(dataset="leaves", leaves_dir=leaves,
                      leaves_test_dir=test_dir, batch_size=2, imsize=24,
                      resize=resize)
    port = catalogs.get_dataset(cfg, split)
    jax_ds = jax_catalogs.get_dataset(jcfg, split)
    assert port.gt_files == jax_ds.gt_files
    _same_samples(port, jax_ds, 3 if split == "val" else 99)
