"""The port's host data path and config against the JAX package's.

- ``SyntheticBlobs`` uint8 wire samples (image and packed target) byte-equal
  to JAX's ``SyntheticBlobs(..., wire_dtype="uint8")``, both splits;
- ``DataLoader`` batches (order, ``drop_last``) equal to JAX's over two
  epochs;
- ``sequence_from_masks`` equal to the JAX package's native packer,
  equal areas included; ``resize_image``, ``resize_masks_nearest``,
  ``normalize_image`` and ``unpack_target`` equal to JAX's;
- ``Config`` defaults and ``config_from_args`` on one argv equal to JAX's
  for every field the port has; JAX-only flags are refused."""

import dataclasses

import numpy as np
import pytest

from rsis_tpu.config import Config as JaxConfig
from rsis_tpu.config import config_from_args as jax_config_from_args
from rsis_tpu.data import base as jax_base
from rsis_tpu.data import catalogs as jax_catalogs
from rsis_tpu.data.pipeline import DataLoader as JaxDataLoader
from rsis_tpu.kernels._binding import pack_target
from rsis_tpu_torch.config import Config, config_from_args
from rsis_tpu_torch.data import base as port_base
from rsis_tpu_torch.data.catalogs import SyntheticBlobs, get_dataset
from rsis_tpu_torch.data.pipeline import DataLoader
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(dataset="synthetic", imsize=48, gt_maxseqlen=6, num_classes=5,
          synthetic_length=7, synthetic_max_instances=5, seed=3)


def _datasets(split):
    port = get_dataset(Config(**KW), split)
    jax_ds = jax_catalogs.get_dataset(JaxConfig(**KW), split,
                                      wire_dtype="uint8")
    return port, jax_ds


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_wire_samples_byte_equal(split):
    port, jax_ds = _datasets(split)
    assert isinstance(port, SyntheticBlobs) and len(port) == len(jax_ds)
    assert port.get_classes() == jax_ds.get_classes()
    for i in range(len(port)):
        for got, want in zip(port[i], jax_ds[i]):
            assert got.dtype == np.uint8 and want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)


def test_dataloader_batches_equal_jax():
    port, jax_ds = _datasets("train")
    loaders = [DataLoader(port, batch_size=3, num_workers=2, seed=3),
               JaxDataLoader(jax_ds, batch_size=3, num_workers=2, seed=3)]
    assert len(loaders[0]) == len(loaders[1]) == 2     # 7 // 3, drop_last
    for _ in range(2):                                 # two epochs
        got, want = (list(loader) for loader in loaders)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_dataloader_stops_its_producer_on_break():
    port, _ = _datasets("train")
    loader = DataLoader(port, batch_size=1, num_workers=1, prefetch=1)
    for batch in loader:
        break
    # a second pass starts afresh
    assert len(list(loader)) == len(port)


def test_sequence_from_masks_matches_native_packer():
    rng = np.random.default_rng(0)
    ins = np.zeros((12, 16), np.int64)
    ins[0:2, 0:4] = 3         # area 8
    ins[4:6, 0:4] = 1         # area 8: ties with id 3
    ins[8:12, 8:16] = 2       # area 32
    ins[2, 10] = 5            # area 1
    seg = rng.integers(1, 7, ins.shape) * (ins > 0)
    for max_seq in (3, 6):
        got = port_base.sequence_from_masks(ins, seg, max_seq)
        want = pack_target(ins, seg, max_seq)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        # the JAX package's numpy packer where no areas tie
        if max_seq == 6:
            ins_u = np.where(ins == 3, 6, ins)
            ins_u[0, 0] = 0
            np.testing.assert_array_equal(
                port_base.sequence_from_masks(ins_u, seg, max_seq),
                jax_base.sequence_from_masks(ins_u, seg, max_seq,
                                             native=False).astype(np.uint8))


def test_resizes_match_jax():
    from PIL import Image
    img = np.random.default_rng(1).integers(0, 255, (30, 40, 3), np.uint8)
    for square in (False, True):
        want = np.asarray(jax_base.resize_image(Image.fromarray(img), 24,
                                                square), np.uint8)
        np.testing.assert_array_equal(
            port_base.resize_image(img, 24, square), want)
    assert port_base.resize_image(img, 30, False) is img
    mask = np.arange(30 * 40).reshape(30, 40)
    np.testing.assert_array_equal(port_base.resize_masks_nearest(mask, 17, 23),
                                  jax_base.resize_masks_nearest(mask, 17, 23))


def test_normalize_and_unpack_match_jax():
    img = np.random.default_rng(2).integers(0, 256, (5, 7, 3), np.uint8)
    np.testing.assert_array_equal(port_base.normalize_image(img),
                                  jax_base.normalize_image(img))
    port, _ = _datasets("val")
    tgt = np.stack([port[i][1] for i in range(2)])
    for got, want in zip(port_base.unpack_target(tgt),
                         jax_base.unpack_target(tgt)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_config_defaults_and_flags_equal_jax():
    names = [f.name for f in dataclasses.fields(Config)]
    jax_names = {f.name for f in dataclasses.fields(JaxConfig)}
    assert set(names) <= jax_names
    port_d, jax_d = Config().to_dict(), JaxConfig().to_dict()
    assert {k: port_d[k] for k in names} == {k: jax_d[k] for k in names}
    argv = ["-dataset", "synthetic", "--augment", "--host_augment",
            "-rotation", "5", "-zoom", "0.8", "-dropout", "0.2",
            "-dropout_cls", "0.1", "--curriculum_learning", "-steps_cl", "2",
            "-max_epoch", "3", "-patience", "0", "--resume",
            "-models_root", "/tmp/m", "-model_name", "x", "--log_term",
            "-compute_dtype", "bfloat16", "-base_model", "tiny",
            "--smooth_curves", "-min_delta", "0.01", "-synthetic_length",
            "32", "--update_encoder", "-finetune_after", "-1"]
    got = config_from_args(argv).to_dict()
    want = jax_config_from_args(argv).to_dict()
    assert {k: got[k] for k in names} == {k: want[k] for k in names}
    assert got["augment"] and not got["augment_on_device"]
    with pytest.raises(SystemExit):
        config_from_args(["-pallas", "off"])
