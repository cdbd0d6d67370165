"""Tiny cells for the CPU tests: the real cells' configurations and
mixes at a small width, frame and batch, run through the harness with
``device="cpu"`` (the port's kernels take their plain versions)."""

from __future__ import annotations

import argparse
import copy
import io
import json

from benchmark import loops, run

MANIFEST = run.load_json(run.MANIFEST)
TRAIN_CELL = "pascal-train-t10-fp32"
AUG_CELL = "cityscapes-train-t20-b32"
INFER_CELL = "cityscapes-infer-512x1024-b32"
# cells the tests drive that BENCHMARK.json does not hold, for the
# reference's device augmentation: (configuration, traffic)
KEPT = {AUG_CELL: ("rsis-cityscapes-bf16", "train-t20-b32-street")}


def load(name: str) -> loops.Cell:
    if name not in KEPT:
        return run.load_cell(MANIFEST, name)
    config, traffic = KEPT[name]
    return loops.Cell(
        name=name,
        config=run.load_json(run.ROOT / "configs" / f"{config}.json"),
        mix=run.load_json(run.ROOT / "traffic" / f"{traffic}.json"),
        limits={})


def cell(name: str, compute_dtype: str = "float32", limits=None, **mix):
    c = load(name)
    c.config = dict(c.config, hidden_size=16, base_model="resnet50",
                    compute_dtype=compute_dtype)
    if compute_dtype == "float32":
        c.config["tf32"] = False
    small = dict(batch=2, height=64, width=64, T=2, pool_batches=3)
    if c.mix["loop"] == "infer":
        small.update(warmup_calls=1, check_batches=1, check_from_first=2,
                     trace_batches=1)
    else:
        small.update(slots=6, check_steps=3, trace_steps=1,
                     instances={"counts": [1, 2, 3],
                                "weights": [0.3, 0.4, 0.3]})
    small.update(mix)
    c.mix = dict(copy.deepcopy(c.mix), **small)
    if limits is not None:
        c.limits = limits
    return c


def run_tiny(c, seed: int = 2**31 + 11, trace: int = 0,
             seconds: float = 0.2):
    """(exit code, parsed last line, stdout text) of one run."""
    out = io.StringIO()
    args = argparse.Namespace(workload=c.name, seed=seed, seconds=seconds,
                              trace=trace)
    rc = run.run_cell(MANIFEST, args, "cpu", 0.0, cell=c, stdout=out)
    text = out.getvalue()
    lines = text.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), text
