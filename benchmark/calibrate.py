"""The readings a cell's limits are set from, many seeds in one process.

    python -m benchmark.calibrate --workload <cell> --seeds 11 12 ...
        [--fault-seeds 3] [--out FILE]

For each seed, on the card at the cell's own size:

- ``program``: the numbers of ``checks.py`` as a run computes them (the
  run's own path with a window of one call or step);
- ``control``: the same numbers with the reference, computed one
  precision below the configuration's, in the program's place: fp8 for a
  bf16 configuration, TF32 for fp32 with TF32 off
  (``reference/precision.py``); ``--precision`` puts another precision
  there (the configuration's own: how far its rounding alone moves each
  number);
- for a train cell, on the first ``--fault-seeds`` seeds, ``half``: the
  reference with half of each batch left out, the mean taken over the
  rest, in the program's place.

A state left unchanged by the step reads 1 on ``change_gap`` by its
definition and is not run. One JSON line a seed, then the summary: the
largest program reading and the smallest control and fault reading of
each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import loops, run
from .reference import infer as ref_infer
from .reference import train as ref_train
from .reference.precision import Precision

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def control_precision(cell) -> str:
    c = cell.config
    if c["compute_dtype"] == "float32" and c["tf32"] is not False:
        return "bf16"
    return CONTROL[c["compute_dtype"]]


def infer_readings(cell, seed, device, prec_name) -> dict:
    mix, c = cell.mix, cell.config
    enc, dec, pool = loops.inputs(cell, seed, device)
    readings = []
    for idx in loops.check_indices(mix, seed):
        x = pool[idx % len(pool)]
        ref = ref_infer.forward(enc, dec, x, mix["T"], c["hidden_size"],
                                Precision("fp32"), base_model=c["base_model"])
        low = ref_infer.forward(enc, dec, x, mix["T"], c["hidden_size"],
                                Precision(prec_name),
                                base_model=c["base_model"])
        readings.append(loops.compare_infer(low, ref))
    return {k: max(r[k] for r in readings) for k in readings[0]}


def train_readings(cell, seed, device, prec_name, half=False) -> dict:
    mix, c = cell.mix, cell.config
    enc, dec, pool = loops.inputs(cell, seed, device)
    batches = pool[:mix["check_steps"]]
    aug_seed = loops.sub_seed(seed, 3)
    ref = ref_train.train_steps(c, enc, dec, batches, mix["flags"], mix["T"],
                                aug_seed, Precision("fp32"))
    low = ref_train.train_steps(c, enc, dec, batches, mix["flags"], mix["T"],
                                aug_seed, Precision(prec_name), half=half)
    numbers, _ = loops.compare_train(
        low["losses"], ref_train.leaf_norms(low["grad1"]),
        loops.change_norms(low["params"], enc, dec), ref, enc, dec)
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--precision", default="",
                   help="the reference's precision in the program's place "
                        "(default: the control's); the configuration's own "
                        "precision gives a witness of its rounding")
    args = p.parse_args(argv)
    manifest = run.load_json(run.MANIFEST)
    cell = run.load_cell(manifest, args.workload)
    return calibrate(cell, args.seeds, args.fault_seeds, args.device,
                     args.out, args.precision)


def calibrate(cell, seeds, fault_seeds, device, out_path="",
              precision="") -> int:
    prec = precision or control_precision(cell)
    train = cell.mix["loop"] == "train"
    rows = []
    sink = open(out_path, "a") if out_path else None
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        outcome = loops.run(cell, seed, 0.0, False, device, t0)
        row = {"workload": cell.name, "seed": seed,
               "program": outcome.numbers, "notes": outcome.notes}
        with loops.tf32_setting(None):
            if train:
                row["control"] = train_readings(cell, seed, device, prec)
                if n < fault_seeds:
                    row["half"] = train_readings(cell, seed, device, "fp32",
                                                 half=True)
            else:
                row["control"] = infer_readings(cell, seed, device, prec)
        row["control_precision"] = prec
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        loops.free(device)
    summary = {"workload": cell.name, "seeds": len(rows), "summary": {}}
    for key in rows[0]["program"]:
        entry = {"program_max": max(r["program"][key] for r in rows),
                 "control_min": min(r["control"][key] for r in rows)}
        halves = [r["half"][key] for r in rows if "half" in r]
        if halves:
            entry["half_min"] = min(halves)
        summary["summary"][key] = entry
    line = json.dumps(summary)
    print(line, flush=True)
    if sink:
        sink.write(line + "\n")
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
