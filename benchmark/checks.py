"""The numbers that decide ``correct`` and their limits.

Each cell's limits are data, ``limits/<cell>.json``: for each number
compared, its limit and the two readings it was set from (the largest
of the program's sound runs over a dozen seeds or more, and the smallest
of the control's, computed one precision below the configuration's, or
of a planted fault). A cell compares the numbers its limits name; a
number is within its limit when it is at most the limit, and a limit
without its number fails.

The readings (``loops.py``), program against the plain reference:

- inference, over the window's batches drawn from the seed: the largest
  gap of any mask pixel (``mask_gap``), the worst answer's (image and
  step) mean mask gap (``mask_answer_gap``), the mean gaps of the class
  probabilities (``class_mean_gap``) and stop scores
  (``stop_mean_gap``);
- training, over the checked first steps: the largest relative gap of a
  step's total loss (``loss_gap``) and of the first step's
  (``loss1_gap``); the first step's gradient as Adam takes it and the
  parameters' change after the checked steps, by leaf: the gap between
  the program's leaf norm and the reference's, against the larger of
  the reference's norm of that leaf and of the median leaf that moves;
  the worst leaf (``grad_gap``, ``change_gap``), the median leaf's
  change (``change_median_gap``) and the gradient's norm over all
  leaves at once (``grad_total_gap``). Leaves whose reference gradient
  is under a thousandth of the median leaf's (a bias before a
  BatchNorm) move under Adam by round-off alone and are left out of
  the change.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Tuple

ROOT = Path(__file__).resolve().parent


def load_limits(cell: str) -> Dict[str, float]:
    path = ROOT / "limits" / f"{cell}.json"
    if not path.exists():
        return {}
    with open(path) as fp:
        return {k: float(v["limit"]) for k, v in json.load(fp).items()}


def verdict(numbers: Dict[str, float],
            limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}) over the cell's limits: the
    numbers compared are those its limits name; a cell without limits is
    not correct."""
    table = {}
    ok = bool(limits)
    for name in sorted(limits):
        value = numbers.get(name)
        limit = limits.get(name)
        table[name] = {"value": value, "limit": limit}
        if (value is None or limit is None or not math.isfinite(value)
                or value > limit):
            ok = False
    return ok, table
