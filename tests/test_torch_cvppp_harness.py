"""The port's LSC contest harness (``rsis_tpu_torch/evals/cvppp_harness.py``):
the five cases of ``tests/test_cvppp_harness.py`` on the port, and every
file it writes byte-equal to the JAX package's ``lsc_evaluation`` on the
same tree (grey, RGB and resized predictions, nested folders, a
participant without predictions), with equal returned rows."""

import filecmp
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from rsis_tpu.evals import cvppp_harness as jax_harness
from rsis_tpu_torch.evals.cvppp import fgbg_dice, symmetric_best_dice
from rsis_tpu_torch.evals.cvppp_harness import (lsc_evaluation,
                                                parse_result_csv,
                                                score_experiment,
                                                _nearest, _to_label_image)
from torch_threads import one_torch_thread  # noqa: F401


def _save_label(path, lab):
    Image.fromarray(lab.astype(np.uint8), mode="L").save(path)


@pytest.fixture()
def contest(tmp_path):
    """GT: A1 with 2 plants, A2 with 1. Participants: 'alice' predicts A1
    only (one perfect, one half-shifted); 'bob' submits nothing."""
    gt = tmp_path / "gt"
    for e in ("A1", "A2"):
        (gt / e).mkdir(parents=True)
    rng = np.random.default_rng(0)

    labs = {}
    for e, nums in (("A1", (1, 2)), ("A2", (7,))):
        for n in nums:
            lab = np.zeros((24, 24), np.uint8)
            lab[2:10, 2:10] = 1
            lab[14:22, 4 + n:12 + n] = 2
            labs[(e, n)] = lab
            _save_label(gt / e / f"plant{n:03d}_label.png", lab)

    inp = tmp_path / "submissions"
    alice = inp / "alice" / "A1"
    alice.mkdir(parents=True)
    _save_label(alice / "plant001.png", labs[("A1", 1)])  # perfect
    shifted = np.roll(labs[("A1", 2)], 4, axis=1)
    _save_label(alice / "plant002.png", shifted)
    (inp / "bob").mkdir()
    del rng
    return inp, gt, labs


class TestHarness:
    def test_scores_and_tables(self, contest):
        inp, gt, labs = contest
        results = lsc_evaluation(str(inp), str(gt))

        assert set(results) == {"alice", "bob"}
        # alice: A1 rows scored, A2 filled in as zero-label
        a = results["alice"]
        assert [r["experiment"] for r in a] == [1, 1, 2]
        assert a[0]["SymmetricBestDice"] == pytest.approx(1.0)
        assert a[0]["AbsDiffFGLabels"] == 0
        shifted = np.roll(labs[("A1", 2)], 4, axis=1)
        assert a[1]["SymmetricBestDice"] == pytest.approx(
            symmetric_best_dice(shifted, labs[("A1", 2)]))
        assert a[1]["FGBGDice"] == pytest.approx(
            fgbg_dice(shifted, labs[("A1", 2)]))
        # missing A2 prediction scores as all-zero label
        assert a[2]["SymmetricBestDice"] == 0.0
        assert a[2]["AbsDiffFGLabels"] == 2

        # bob: everything zero-label
        assert all(r["SymmetricBestDice"] == 0.0 for r in results["bob"])

        # files written: per-experiment, overall, latex
        for f in ("alice_A1_results.csv", "alice_A2_results.csv",
                  "alice_all_results.csv", "alice_results.tex",
                  "bob_all_results.csv", "bob_results.tex"):
            assert os.path.exists(os.path.join(str(inp), f)), f

        # CSV round-trips through the parser with identical values
        rows = parse_result_csv(os.path.join(str(inp),
                                             "alice_A1_results.csv"))
        assert len(rows) == 2
        assert rows[0]["SymmetricBestDice"] == pytest.approx(
            a[0]["SymmetricBestDice"], abs=1e-6)

        # stats block present (mean/std/median/max/min)
        text = open(os.path.join(str(inp), "alice_all_results.csv")).read()
        for stat in ("mean,", "std,", "median,", "max,", "min,"):
            assert stat in text

        tex = open(os.path.join(str(inp), "alice_results.tex")).read()
        assert "\\begin{tabular}" in tex and "\\bf{all}" in tex

    def test_existing_csv_is_reused(self, contest):
        inp, gt, _ = contest
        lsc_evaluation(str(inp), str(gt))
        # tamper with alice's A1 CSV; a re-run must trust the file
        p = os.path.join(str(inp), "alice_A1_results.csv")
        text = open(p).read().replace("1.000000", "0.500000")
        open(p, "w").write(text)
        results = lsc_evaluation(str(inp), str(gt))
        assert results["alice"][0]["SymmetricBestDice"] == pytest.approx(0.5)


class TestLabelConversion:
    def test_gray_passthrough_and_rgb(self):
        lab = np.array([[0, 1], [2, 2]], np.uint8)
        assert (_to_label_image(lab) == lab).all()
        # 24-bit grey
        rgb = np.stack([lab, lab, lab], -1)
        assert (_to_label_image(rgb) == lab).all()
        # colored: permutation-invariant labels, black -> 0
        col = np.zeros((2, 2, 3), np.uint8)
        col[0, 1] = (255, 0, 0)
        col[1] = (0, 255, 0)
        out = _to_label_image(col)
        assert out[0, 0] == 0
        assert out[0, 1] != 0 and out[1, 0] != 0
        assert out[0, 1] != out[1, 0]
        assert out[1, 0] == out[1, 1]

    def test_nearest_resize(self):
        lab = np.arange(16).reshape(4, 4)
        out = _nearest(lab, (2, 2))
        assert out.shape == (2, 2)
        assert (out == lab[::2, ::2]).all()
        same = _nearest(lab, (4, 4))
        assert same is lab

    def test_zero_label_experiment_scores(self, contest):
        inp, gt, labs = contest
        rows = score_experiment("A1", str(gt), None)
        assert len(rows) == 2
        assert all(r["SymmetricBestDice"] == 0.0 for r in rows)
        assert rows[0]["DiffFGLabels"] == -2


def test_files_byte_equal_to_jax(contest, tmp_path):
    inp, gt, labs = contest
    # more kinds of predictions: RGB colours, a resized label image and a
    # nested folder, for a third participant
    carol = inp / "carol" / "run1" / "A2"
    carol.mkdir(parents=True)
    lab = labs[("A2", 7)]
    rgb = np.zeros(lab.shape + (3,), np.uint8)
    rgb[lab == 1] = (200, 10, 10)
    rgb[lab == 2] = (10, 200, 10)
    Image.fromarray(rgb).save(carol / "plant_007.png")
    big = np.repeat(np.repeat(labs[("A1", 1)], 2, 0), 2, 1)
    _save_label(inp / "carol" / "A1_plant1.png", big)
    jax_in = tmp_path / "jax_submissions"
    shutil.copytree(inp, jax_in)
    got = lsc_evaluation(str(inp), str(gt))
    want = jax_harness.lsc_evaluation(str(jax_in), str(gt))
    assert got == want
    written = sorted(f for f in os.listdir(inp) if f.endswith((".csv",
                                                               ".tex")))
    assert written == sorted(f for f in os.listdir(jax_in)
                             if f.endswith((".csv", ".tex")))
    assert len(written) == 12, written   # 3 x (A1, A2, all, LaTeX)
    for f in written:
        assert filecmp.cmp(inp / f, jax_in / f, shallow=False), f
