"""The port's Pascal VOC + SBD merge (``rsis_tpu_torch/data/tools/
pascalplus_gen.py``) against the JAX package's, byte for byte.

A miniature SBD tree (``inst/<name>.mat`` written with
``scipy.io.savemat``: a ``GTinst`` struct whose fields 0 and 2 are the
instance map and the categories; one image with 25 instances, past the
loop's break at instance 20; one name also in VOC's val list, which the
merge keeps out of train and val) and a small VOC tree go through both
packages' ``run``; every file of the two outputs (palette PNGs, split
files, copied trees) is equal, and so are the counts. The port's ``main``
with ``--nocopy`` writes the same PNGs and splits as JAX's ``run``."""

import filecmp
import os

import numpy as np
import pytest
from PIL import Image
from scipy.io import savemat

from rsis_tpu.data.tools import pascalplus_gen as jax_gen
from rsis_tpu_torch.data.tools import pascalplus_gen as port_gen
from torch_threads import one_torch_thread  # noqa: F401


def _lines(path, items):
    path.write_text("".join(f"{i}\n" for i in items))


@pytest.fixture()
def trees(tmp_path):
    rng = np.random.default_rng(0)
    contours = tmp_path / "sbd"
    (contours / "inst").mkdir(parents=True)
    (contours / "img").mkdir()
    names = {"train": ["2008_000001", "2008_000002", "2008_000005"],
             "val": ["2008_000003", "2008_000004"]}
    n_inst = {"2008_000002": 25}
    for split, items in names.items():
        _lines(contours / f"{split}.txt", items)
        for name in items:
            h, w = 24, 32
            n = n_inst.get(name, 3)
            seg = np.zeros((h, w), np.uint8)
            for i in range(1, n + 1):   # a band of rows a few columns wide
                r, c = divmod(i - 1, 5)
                seg[4 * r:4 * r + 4, 6 * c:6 * c + 5] = i
            cats = rng.integers(1, 21, size=(n, 1)).astype(np.uint8)
            savemat(contours / "inst" / f"{name}.mat",
                    {"GTinst": {"Segmentation": seg,
                                "Boundaries": np.zeros((1, n), object),
                                "Categories": cats}})
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
                contours / "img" / f"{name}.jpg")
    voc = tmp_path / "voc"
    sets = voc / "ImageSets" / "Segmentation"
    sets.mkdir(parents=True)
    _lines(sets / "train.txt", ["2007_000032", "2007_000039"])
    _lines(sets / "val.txt", ["2007_000033", "2008_000004"])
    for sub in ("SegmentationClass", "SegmentationObject", "JPEGImages"):
        (voc / sub).mkdir()
        for name in ("2007_000032", "2007_000033", "2007_000039"):
            ext = "jpg" if sub == "JPEGImages" else "png"
            Image.fromarray(rng.integers(0, 21, (16, 16), np.uint8)).save(
                voc / sub / f"{name}.{ext}")
    return contours, voc, tmp_path


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _same_trees(a, b):
    files = _tree(a)
    assert files == _tree(b)
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f
    return files


def test_run_byte_equal_to_jax(trees):
    contours, voc, root = trees
    got = port_gen.run(str(contours), str(voc), str(root / "port"))
    want = jax_gen.run(str(contours), str(voc), str(root / "jax"))
    assert got == want == {"train": 5, "val": 1, "test": 2}
    files = _same_trees(root / "port", root / "jax")
    assert "SegmentationObject/2008_000002.png" in files
    assert "JPEGImages/2008_000003.jpg" in files
    # the 25-instance image: instance 20 drawn, those past it background
    ins = np.asarray(Image.open(root / "port" / "SegmentationObject" /
                                "2008_000002.png"))
    assert ins[12:16, 24:29].any() and not ins[16:20].any()
    split = (root / "port" / "ImageSets" / "Segmentation")
    kept = (split / "train.txt").read_text().split() + (
        split / "val.txt").read_text().split()
    assert "2008_000004" not in kept


def test_main_nocopy_matches_jax_run(trees, capsys):
    contours, voc, root = trees
    port_gen.main(["--contours_dir", str(contours), "--voc_dir", str(voc),
                   "--vocplus_dir", str(root / "port"), "--nocopy"])
    assert "All done." in capsys.readouterr().out
    jax_gen.run(str(contours), str(voc), str(root / "jax"), copy=False)
    files = _same_trees(root / "port", root / "jax")
    assert not any(f.startswith("JPEGImages/") for f in files)
