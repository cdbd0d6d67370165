"""CVPPP Leaf Segmentation Challenge multi-participant scoring harness.

Counterpart of ``rsis_tpu/evals/cvppp_harness.py``: a copy over the port's
``evals/cvppp.py``, whose CSV and LaTeX files are byte-equal to JAX's.

Python re-design of the contest organiser's MATLAB harness
(reference: src/CVPPP/LSC_Evaluation.m:1-448): given a folder of
participant subfolders (each holding predicted label PNGs) and the ground
truth folder (subfolders ``A1``/``A2``/``A3`` with ``plant%03d_label.png``
images), it scores every prediction with SymmetricBestDice / FGBGDice /
AbsDiffFGLabels / DiffFGLabels (evals/cvppp — the same kernels
``evaluation.m`` uses), writes one CSV score table per participant and
experiment plus an overall table and a LaTeX summary, and fills in
zero-label scores for missing predictions so all participants are ranked
over the same image set.

File conventions (reference: LSC_Evaluation.m:72-84):
  - a prediction's experiment is the unique 'A1'/'A2'/'A3' (case
    insensitive) substring in its path;
  - the LAST number in the file name is the plant number;
  - ground truth lives in ``gtpath/Ae/plant%03d_label.png``.

Deviations from the MATLAB (documented, intentional):
  - predictions are collected recursively per participant into ONE table
    (the MATLAB recursion re-wrote the same CSV per nested folder);
  - RGB label images map unique colours to indices with black forced to
    background (rgb2ind's palette order is unspecified anyway and every
    metric is label-permutation invariant).
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cvppp import (abs_diff_fg_labels, diff_fg_labels, fgbg_dice,
                    symmetric_best_dice)

EXPERIMENTS = ("A1", "A2", "A3")
_NUM_RE = re.compile(r"(\d+)")


def _last_number(name: str) -> Optional[int]:
    nums = _NUM_RE.findall(name)
    return int(nums[-1]) if nums else None


def _experiment_of(path: str) -> Optional[str]:
    lower = path.lower()
    for e in EXPERIMENTS:
        if e.lower() in lower:
            return e
    return None


def _to_label_image(arr: np.ndarray) -> np.ndarray:
    """Color/gray prediction -> index image (LSC_Evaluation.m:232-246)."""
    if arr.ndim == 2:
        return arr.astype(np.int64)
    rgb = arr[..., :3].astype(np.int64)
    if (np.abs(rgb[..., 0] - rgb[..., 1]).max(initial=0) +
            np.abs(rgb[..., 0] - rgb[..., 2]).max(initial=0)) <= 0:
        return rgb[..., 0]  # 24-bit grey
    flat = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    colors, inverse = np.unique(flat, return_inverse=True)
    lab = inverse.reshape(flat.shape) + 1
    lab[flat == 0] = 0  # black is background
    return lab.astype(np.int64)


def _read_label(path: str) -> np.ndarray:
    from PIL import Image
    return _to_label_image(np.asarray(Image.open(path)))


def _nearest(lab: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """imresize(..., 'nearest') twin (LSC_Evaluation.m:258-261)."""
    if lab.shape == shape:
        return lab
    h, w = shape
    ri = (np.arange(h) * lab.shape[0] / h).astype(np.int64)
    ci = (np.arange(w) * lab.shape[1] / w).astype(np.int64)
    return lab[ri][:, ci]


def _find_predictions(folder: str) -> Dict[str, Dict[int, str]]:
    """experiment -> plant number -> png path, recursive."""
    out: Dict[str, Dict[int, str]] = {e: {} for e in EXPERIMENTS}
    for root, _dirs, files in os.walk(folder):
        for f in sorted(files):
            if not f.lower().endswith(".png"):
                continue
            full = os.path.join(root, f)
            e = _experiment_of(os.path.relpath(full, os.path.dirname(folder)))
            n = _last_number(f)
            if e is not None and n is not None:
                out[e].setdefault(n, full)
    return out


def _gt_files(gtpath: str, experiment: str) -> List[Tuple[int, str]]:
    d = os.path.join(gtpath, experiment)
    if not os.path.isdir(d):
        return []
    out = []
    for f in sorted(os.listdir(d)):
        if f.lower().endswith(".png"):
            n = _last_number(f)
            if n is not None:
                out.append((n, os.path.join(d, f)))
    return out


def score_experiment(experiment: str, gtpath: str,
                     preds: Optional[Dict[int, str]] = None) -> List[dict]:
    """Score one experiment's GT set against available predictions
    (missing ones score as all-zero labels, LSC_Evaluation.m:247-253)."""
    rows = []
    for n, gt_file in _gt_files(gtpath, experiment):
        gt = _read_label(gt_file)
        pred_path = (preds or {}).get(n)
        if pred_path is None:
            pred = np.zeros_like(gt)
        else:
            pred = _nearest(_read_label(pred_path), gt.shape)
        rows.append({
            "number": n,
            "SymmetricBestDice": symmetric_best_dice(pred, gt),
            "FGBGDice": fgbg_dice(pred, gt),
            "AbsDiffFGLabels": abs_diff_fg_labels(pred, gt),
            "DiffFGLabels": diff_fg_labels(pred, gt),
            "experiment": int(experiment[1]),
        })
    return rows


_COLS = ("SymmetricBestDice", "FGBGDice", "AbsDiffFGLabels", "DiffFGLabels")


def _std(v) -> float:  # MATLAB std is the sample std
    return float(np.std(v, ddof=1)) if len(v) > 1 else 0.0


def write_result_table(result_name: str, save_folder: str, username: str,
                       rows: Sequence[dict],
                       with_experiment: bool = False) -> str:
    """CSV layout of writeResultTable (LSC_Evaluation.m:275-311)."""
    path = os.path.join(save_folder,
                        f"{username}_{result_name}_results.csv")
    with open(path, "w", newline="") as fp:
        w = csv.writer(fp, delimiter=",")
        fp.write(f"Results for images: {result_name}\n\n")
        header = ["number"] + list(_COLS)
        if with_experiment:
            header.append("experiment")
        fp.write(", ".join(header) + "\n")
        for r in rows:
            vals = [str(r["number"]),
                    f"{r['SymmetricBestDice']:f}", f"{r['FGBGDice']:f}",
                    str(int(r["AbsDiffFGLabels"])),
                    str(int(r["DiffFGLabels"]))]
            if with_experiment:
                vals.append(str(r["experiment"]))
            fp.write(", ".join(vals) + "\n")
        fp.write("\n")
        cols = {c: [r[c] for r in rows] for c in _COLS}
        for stat, fn in (("mean", np.mean), ("std", _std),
                         ("median", np.median), ("max", np.max),
                         ("min", np.min)):
            if rows:
                vals = [f"{float(fn(cols[c])):f}" for c in _COLS]
            else:
                vals = ["0.000000"] * len(_COLS)
            fp.write(f"{stat}, " + ", ".join(vals) + "\n")
        del w
    return path


def parse_result_csv(path: str) -> List[dict]:
    """parseResultCSV twin (LSC_Evaluation.m:402-415)."""
    rows = []
    with open(path) as fp:
        lines = [ln.strip() for ln in fp]
    for ln in lines[3:]:
        if not ln:
            break
        parts = [p.strip() for p in ln.split(",")]
        rows.append({"number": int(parts[0]),
                     "SymmetricBestDice": float(parts[1]),
                     "FGBGDice": float(parts[2]),
                     "AbsDiffFGLabels": int(parts[3]),
                     "DiffFGLabels": int(parts[4]),
                     "experiment": int(parts[5]) if len(parts) > 5 else 0})
    return rows


def write_latex_table(save_folder: str, username: str,
                      rows: Sequence[dict]) -> str:
    """writeLaTeXTable twin (LSC_Evaluation.m:417-448)."""
    path = os.path.join(save_folder, f"{username}_results.tex")
    with open(path, "w") as fp:
        fp.write("\\begin{tabular}{|l||c|c|c|c|}\n\\hline\n")
        fp.write(" & \\bf{BestDice [\\%]} & \\bf{FGBGDice [\\%]} & "
                 "\\bf{AbsDiffFGLabels} & \\bf{DiffFGLabels}\\\\\n")
        fp.write("\\hline\n\\hline\n")

        def line(tag, sel):
            if not sel:
                return
            sbd = [r["SymmetricBestDice"] for r in sel]
            fg = [r["FGBGDice"] for r in sel]
            ad = [r["AbsDiffFGLabels"] for r in sel]
            dd = [r["DiffFGLabels"] for r in sel]
            fp.write(
                f"\\bf{{{tag}}} & {np.mean(sbd) * 100:.1f} "
                f"($\\pm${_std(sbd) * 100:.1f}) & "
                f"{np.mean(fg) * 100:.1f} ($\\pm${_std(fg) * 100:.1f}) & "
                f"{np.mean(ad):.1f} ($\\pm${_std(ad):.1f}) & "
                f"{np.mean(dd):.1f} ($\\pm${_std(dd):.1f}) \\\\ \n")
            fp.write("\\hline\n")

        for e in (1, 2, 3):
            line(f"A{e}", [r for r in rows if r["experiment"] == e])
        line("all", list(rows))
        fp.write("\\end{tabular}\n")
    return path


def lsc_evaluation(inpath: str, gtpath: str) -> Dict[str, List[dict]]:
    """Top-level contest run (LSC_Evaluation.m:51-65): score every
    participant subfolder of ``inpath`` against ``gtpath``, writing the
    per-experiment CSVs, the per-participant overall CSV + LaTeX table.
    Returns {username: all-experiment rows} for programmatic use."""
    if not os.path.isdir(inpath):
        raise FileNotFoundError(inpath)
    participants = sorted(
        d for d in os.listdir(inpath)
        if os.path.isdir(os.path.join(inpath, d)) and not d.startswith("."))
    results: Dict[str, List[dict]] = {}
    for user in participants:
        print(f"Processing {os.path.join(inpath, user)} ...", flush=True)
        preds = _find_predictions(os.path.join(inpath, user))
        all_rows: List[dict] = []
        for e in EXPERIMENTS:
            csv_path = os.path.join(inpath, f"{user}_{e}_results.csv")
            if os.path.exists(csv_path):
                rows = parse_result_csv(csv_path)
                for r in rows:
                    r["experiment"] = int(e[1])
            else:
                rows = score_experiment(e, gtpath, preds[e])
                if rows:
                    write_result_table(e, inpath, user, rows)
            all_rows.extend(rows)
        write_result_table("all", inpath, user, all_rows,
                           with_experiment=True)
        write_latex_table(inpath, user, all_rows)
        results[user] = all_rows
    return results


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="cvppp_harness",
        description="CVPPP LSC contest scoring (LSC_Evaluation.m twin)")
    p.add_argument("inpath", help="folder of participant subfolders")
    p.add_argument("gtpath", help="ground truth folder with A1/A2/A3")
    args = p.parse_args(argv)
    lsc_evaluation(args.inpath, args.gtpath)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
