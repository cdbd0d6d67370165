"""The port's host-side augmentation (``--host_augment``) against the JAX
package's, byte for byte on the same numpy generator's draws:

- the rotation, translation, shear and zoom matrices;
- ``affine_warp`` in nearest (float and uint8) and bilinear mode;
- ``RandomAffine`` on an image and its two maps, draw after draw;
- the fixed transforms and the random-choice family (the cases of
  ``tests/test_data.py``, their values drawn from a list);
- the datasets' ``__getitem__`` with augmentation: ``SyntheticBlobs``
  through ``get_dataset`` at ``seed != 0`` (JAX's ``wire_dtype="uint8"``
  samples), with and without resize and with Pascal's zoom range, and
  the file-backed CVPPP and Cityscapes catalogs with their crops, so the
  flip -> crop -> affine order of the draws is held too.

Every comparison is exact (``assert_array_equal``)."""

import numpy as np
import pytest

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.data import augment as jax_aug
from rsis_tpu.data import catalogs as jax_catalogs
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.data import augment as port_aug
from rsis_tpu_torch.data import catalogs as port_catalogs

from tests.torch_eval_trees import cityscapes_tree, leaves_tree


def _draws(seed, n):
    return np.random.default_rng(seed).uniform(-30.0, 30.0, n)


def test_matrices_equal_jax():
    a, b, c, d, e = _draws(0, 5)
    for name, args in (("rotation_matrix", (a,)),
                       ("translation_matrix", (b, c)),
                       ("shear_matrix", (d,)),
                       ("zoom_matrix", (1 + e / 100, 1 - e / 100))):
        got = getattr(port_aug, name)(*args)
        want = getattr(jax_aug, name)(*args)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("mode,dtype,shape", [
    ("nearest", np.float32, (3, 17, 23)), ("nearest", np.uint8, (3, 17, 23)),
    ("nearest", np.int64, (17, 23)), ("bilinear", np.float32, (3, 17, 23)),
    ("bilinear", np.float64, (16, 20))])
def test_affine_warp_equal_jax(mode, dtype, shape):
    rng = np.random.default_rng(1)
    x = (rng.random(shape) * 200).astype(dtype)
    deg, tx, ty, sh = _draws(2, 4)
    m = (jax_aug.rotation_matrix(deg) @ jax_aug.translation_matrix(tx / 10,
                                                                   ty / 10)
         @ jax_aug.shear_matrix(sh / 3) @ jax_aug.zoom_matrix(0.8, 1.3))
    got = port_aug.affine_warp(x, m, mode)
    want = jax_aug.affine_warp(x, m, mode)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="interpolation"):
        port_aug.affine_warp(x, m, "cubic")


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_random_affine_equal_jax(interp):
    kw = dict(rotation_range=30, translation_range=(0.1, 0.2),
              shear_range=8, zoom_range=(0.7, 1.4), interp=interp)
    port = port_aug.RandomAffine(**kw, rng=np.random.default_rng(7))
    ref = jax_aug.RandomAffine(**kw, rng=np.random.default_rng(7))
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (3, 24, 20)).astype(np.float32)
    ins = rng.integers(0, 4, (24, 20))
    seg = rng.integers(0, 9, (24, 20))
    for _ in range(4):
        for got, want in zip(port(img, ins, seg), ref(img, ins, seg)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.rng.random(3), ref.rng.random(3))


def test_flip_and_crop_equal_jax():
    rng = np.random.default_rng(4)
    arrays = [rng.random((3, 40, 60)), rng.integers(0, 5, (40, 60))]
    for got, want in zip(port_aug.horizontal_flip(arrays),
                         jax_aug.horizontal_flip(arrays)):
        assert got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
    for _ in range(3):
        got = port_aug.random_crop(arrays, (32, 32),
                                   np.random.default_rng(9))
        want = jax_aug.random_crop(arrays, (32, 32),
                                   np.random.default_rng(9))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_fixed_and_random_choice_family_equal_jax():
    img = np.random.default_rng(0).normal(size=(3, 20, 24)).astype(
        np.float32)
    mask = (img[0] > 0).astype(np.int64)
    fixed = [("Rotate", (7.0,)), ("Translate", (0.1, -0.05)),
             ("Shear", (4.0,)), ("Zoom", (0.8,)), ("Zoom", (0.9, 1.2))]
    for name, args in fixed:
        for interp in ("bilinear", "nearest"):
            got = getattr(port_aug, name)(*args, interp=interp)(img, mask)
            want = getattr(jax_aug, name)(*args, interp=interp)(img, mask)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=name)
    choices = [("RandomChoiceRotate", [7.0, -12.0, 30.0]),
               ("RandomChoiceTranslate", [(0.1, -0.05), 0.2, (0.0, 0.3)]),
               ("RandomChoiceShear", [4.0, -9.0]),
               ("RandomChoiceZoom", [0.8, (0.9, 1.2), 1.3])]
    for name, values in choices:
        port = getattr(port_aug, name)(values, rng=np.random.default_rng(5))
        ref = getattr(jax_aug, name)(values, rng=np.random.default_rng(5))
        for _ in range(5):
            np.testing.assert_array_equal(port(img), ref(img),
                                          err_msg=name)
    # a choice equals its fixed transform at the drawn value
    np.testing.assert_array_equal(
        port_aug.RandomChoiceRotate([7.0])(img), port_aug.Rotate(7.0)(img))


def _same_samples(port, ref, n=None):
    """Every sample in index order (the generator is shared), uint8 and
    byte-equal; returns how many samples changed under augmentation."""
    assert len(port) == len(ref)
    for i in range(n or len(port)):
        for got, want in zip(port[i], ref[i]):
            assert got.dtype == np.uint8 and want.dtype == np.uint8
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


SYN = dict(imsize=40, gt_maxseqlen=6, num_classes=5, synthetic_length=6,
           synthetic_max_instances=4, seed=11, rotation=15,
           translation=0.15, shear=0.2, zoom=0.6)


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_get_dataset_augmented_at_seed_11(split):
    cfg = Config(dataset="synthetic", resize=True, **SYN)
    port = port_catalogs.get_dataset(cfg, split, augment=True)
    ref = jax_catalogs.get_dataset(JaxConfig(dataset="synthetic",
                                             resize=True, **SYN),
                                   split, augment=True, wire_dtype="uint8")
    assert port.affine.params.zoom_range == (0.6, 1.0)
    _same_samples(port, ref)
    # the augmentation moved the samples away from the plain ones
    plain = port_catalogs.get_dataset(cfg, split)
    assert any(not np.array_equal(port[i][0], plain[i][0])
               for i in range(len(plain)))


@pytest.mark.parametrize("dataset,resize,zoom", [
    ("synthetic", False, None), ("pascal", False, (0.6, 1.2)),
    ("leaves", True, (0.6, 1.0))])
def test_synthetic_blobs_zoom_ranges(dataset, resize, zoom):
    kw = dict(SYN, dataset=dataset, resize=resize)
    port = port_catalogs.SyntheticBlobs(
        Config(**kw), split="train", augment=True, imsize=40,
        resize=resize, seed=11, length=5)
    ref = jax_catalogs.SyntheticBlobs(
        JaxConfig(**kw), split="train", augment=True, imsize=40,
        resize=resize, seed=11, length=5, wire_dtype="uint8")
    assert port.affine.params.zoom_range == zoom
    _same_samples(port, ref)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug_trees")
    return {"leaves": leaves_tree(str(root), n=6, s=48, w=64, seed=3),
            "cityscapes": cityscapes_tree(str(root), n=3, s=48, w=72,
                                          seed=4)}


@pytest.mark.parametrize("dataset,split", [("leaves", "train"),
                                           ("cityscapes", "val")])
def test_file_datasets_crop_and_augment_equal_jax(trees, dataset, split):
    """Images larger than imsize (no square resize) so the crop draws a
    nonzero offset between the coin and the affine."""
    kw = dict(dataset=dataset, imsize=32, gt_maxseqlen=5, batch_size=2,
              crop=True, seed=13, leaves_dir=trees["leaves"],
              cityscapes_dir=trees["cityscapes"])
    port = port_catalogs.get_dataset(Config(**kw), split, augment=True)
    ref = jax_catalogs.get_dataset(JaxConfig(**kw), split, augment=True,
                                   wire_dtype="uint8")
    assert port.crop and port.affine is not None
    _same_samples(port, ref)
    assert port[0][0].shape == (32, 32, 3)
