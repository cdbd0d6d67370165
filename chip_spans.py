"""The port's spans on the card: where a bf16 step goes, their coverage
in a benchmark cell, and what they cost against a checkout without them.

    python3 chip_spans.py [--seed N] [--steps 4]
    python3 chip_spans.py --cell NAME [--seed N] [--seconds 35]
    python3 chip_spans.py --compare DIR --cell NAME --seeds A,B,...
        [--seconds 10]

1. (default) ``--steps`` T=20 Cityscapes bf16 train steps
   (``rsis-cityscapes-bf16``, the ``train-t20-b32-street`` mix, driven as
   the benchmark drives a train cell: each step's metrics read to the
   host) under ``utils.profiling.trace``, after three steps of warm-up:
   the span table with host and device ms, the idle gaps by span, the
   kernels by span (from the spans' mirrors on the device's lane) and
   the host operations by self time.
2. ``--cell``: one run of a benchmark cell with ``--trace 1``, as the
   benchmark makes it (``benchmark.run.run_cell``), then the profiled
   window's span table and coverage (``benchmark.spans.coverage``), and
   every collection of the garbage collector in the run that took 1 ms
   or more, with its generation and its place against the window; then
   the host us a span costs under a profiler session with the card idle,
   beside a ``record_function`` range alone.
3. ``--compare DIR``: the cell with ``--trace 1`` on each seed, run by
   ``python3 -m benchmark.run`` in DIR (another checkout, e.g. the
   parent commit's) and in this one, in turns (DIR first on the even
   seeds, this checkout first on the odd): each run's per-layer metrics,
   traced window's ms a step or batch beside the untraced window's
   median, and idle gaps.

Prints one JSON line (and writes it to ``--out``), with the card's name
and power limit. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import io
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

from benchmark import loops
from benchmark import run as bench
from benchmark import spans as span_reader
from benchmark import trace as tracing
from rsis_tpu_torch.utils import profiling

HERE = Path(__file__).resolve().parent
BF16_CELL = ("cityscapes-train-t20-b32", "rsis-cityscapes-bf16",
             "train-t20-b32-street")


def table(records) -> dict:
    return {name: row._asdict()
            for name, row in profiling.span_table(records).items()}


def kernels_by_span(prof, top: int = 6) -> dict:
    """Device ms of the kernels (grouped as the benchmark's breakdown
    groups them) under the innermost ``rsis.*`` span mirrored on the
    device's lane that holds each kernel's middle; the ``top`` largest
    groups a span."""
    import numpy as np
    cuda = torch.autograd.DeviceType.CUDA
    spans, kernels = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        item = (ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
        if not ev.is_user_annotation():
            kernels.append(item)
        elif item[2].startswith("rsis."):
            spans.append(item)
    starts = np.array([sp[0] for sp in spans], dtype=np.int64)
    ends = np.array([sp[1] for sp in spans], dtype=np.int64)
    by = defaultdict(lambda: defaultdict(float))
    for s, e, name in kernels:
        mid = (s + e) // 2
        idx = np.flatnonzero((starts <= mid) & (ends >= mid))
        label = (spans[min(idx, key=lambda i: ends[i] - starts[i])][2]
                 if idx.size else "(no span)")
        by[label][tracing.kernel_group(name)[:60]] += (e - s) / 1e6
    return {label: sorted(([k, v] for k, v in groups.items()),
                          key=lambda kv: -kv[1])[:top]
            for label, groups in by.items()}


def bf16_steps(seed: int, steps: int, device, logdir: str) -> dict:
    """T=20 bf16 train steps under ``profiling.trace``."""
    from rsis_tpu_torch.train.step import create_train_state, make_train_step
    name, config, traffic = BF16_CELL
    cell = loops.Cell(
        name=name, limits={},
        config=bench.load_json(bench.ROOT / "configs" / f"{config}.json"),
        mix=bench.load_json(bench.ROOT / "traffic" / f"{traffic}.json"))
    mix = cell.mix
    with loops.tf32_setting(cell.config["tf32"]):
        cfg = loops.port_config(cell)
        enc, dec, pool = loops.inputs(cell, seed, device)
        state = create_train_state(cfg, weights=(enc, dec), device=device)
        train_step, _ = make_train_step(cfg, T=mix["T"], device=device)
        rng = torch.Generator(device=device).manual_seed(
            loops.sub_seed(seed, 3))
        flags = loops.train_flags(mix)
        for k in range(3):
            state, m = train_step(state, pool[k % len(pool)], flags, rng)
            m.cpu()
        host = []
        with profiling.trace(logdir) as prof:
            for k in range(steps):
                a = time.perf_counter()
                state, m = train_step(state, pool[(3 + k) % len(pool)],
                                      flags, rng)
                m.cpu()
                host.append((time.perf_counter() - a) * 1e3)
    records = profiling.span_records()
    device_ev, host_ev = tracing._events(prof)
    tops = [h for h in host_ev if h[2] == "rsis.train_step"]
    window = (min(h[0] for h in tops), max(h[1] for h in tops))
    tr = tracing.Trace(window, device_ev, host_ev)
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"cell": name, "steps": steps, "step_ms_host_clock": host,
            "table": table(records),
            "coverage": span_reader.coverage(records, window[1] - window[0]),
            "busy_s": tr.busy_s(), "idle_gaps": tr.idle_gaps(10),
            "kernels_by_span": kernels_by_span(prof),
            "host_ops_self_ms": [[e.key, e.count,
                                  e.self_cpu_time_total / 1e3]
                                 for e in ops[:15]]}


def cell_spans(name: str, seed: int, seconds: float) -> dict:
    """One traced run of a cell as the benchmark makes it, then its
    spans, their coverage and the collector's pauses."""
    pauses, started = [], {}

    def watch(phase, info):
        if phase == "start":
            started["ns"] = time.time_ns()
        else:
            pauses.append((started.pop("ns", time.time_ns()),
                           time.time_ns(), info["generation"]))
    manifest = bench.load_json(bench.MANIFEST)
    args = bench.parse_args(["--workload", name, "--seed", str(seed),
                             "--seconds", str(seconds), "--trace", "1"])
    profiling.clear_spans()
    out = io.StringIO()
    gc.callbacks.append(watch)
    try:
        rc = bench.run_cell(manifest, args, "cuda", time.perf_counter(),
                            stdout=out)
    finally:
        gc.callbacks.remove(watch)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    records = profiling.span_records()
    tops = [r for r in records if r.parent is None]
    lo = min(r.host_start_ns for r in tops)
    hi = max(r.host_end_ns for r in tops)
    return {"cell": name, "seed": seed, "rc": rc,
            "correct": line["correct"], "metrics": line["metrics"],
            "device": line["device"], "breakdown": line.get("breakdown"),
            "table": table(records),
            "coverage": span_reader.coverage(
                records, int(line["device"]["window_s"] * 1e9)),
            "gc_pauses_ms": [
                {"generation": g, "ms": (e - s) / 1e6,
                 "in_window": s < hi and e > lo}
                for s, e, g in pauses if e - s >= 1_000_000],
            "span_cost_us": span_cost_us()}


def span_cost_us(n: int = 2000) -> dict:
    """Host us a span, and a ``record_function`` range alone, under a
    profiler session (CPU and CUDA activities), the card idle."""
    from torch.profiler import ProfilerActivity, profile, record_function
    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for name, make in (("span", profiling.span),
                           ("record_function", record_function)):
            reps = []
            for _ in range(3):
                torch.cuda.synchronize()
                a = time.perf_counter_ns()
                for _ in range(n):
                    with make("rsis.cost"):
                        pass
                reps.append((time.perf_counter_ns() - a) / n / 1e3)
            out[name] = reps
    profiling.span_records()
    return out


def bench_run(checkout: str, name: str, seed: int, seconds: float) -> dict:
    """``python3 -m benchmark.run`` with ``--trace 1`` in a checkout: the
    result line and the untraced window's median ms a step or batch."""
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", "1"],
        cwd=checkout, capture_output=True, text=True, timeout=1800)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines else {}
    median = re.search(r"^window: .* median ([0-9.]+)", proc.stderr,
                       re.MULTILINE)
    return {"checkout": checkout, "seed": seed, "rc": proc.returncode,
            "correct": line.get("correct"),
            "metrics": {k: v["value"]
                        for k, v in line.get("metrics", {}).items()},
            "device": line.get("device"),
            "idle_gaps": (line.get("breakdown") or {}).get("idle_gaps"),
            "untraced_median_ms": (float(median.group(1)) if median
                                   else None),
            "stderr_tail": proc.stderr[-600:] if proc.returncode else ""}


def compare(other: str, name: str, seeds, seconds: float) -> dict:
    """The cell traced in ``other`` and in this checkout, in turns."""
    manifest = bench.load_json(bench.MANIFEST)
    cell = bench.load_cell(manifest, name)
    per = cell.mix.get("trace_steps") or cell.mix.get("trace_batches")
    runs = []
    for k, seed in enumerate(seeds):
        pair = [other, str(HERE)]
        for checkout in (pair if k % 2 == 0 else pair[::-1]):
            r = bench_run(checkout, name, seed, seconds)
            r["side"] = "this" if checkout == str(HERE) else "other"
            if r["device"]:
                r["traced_ms_per"] = 1e3 * r["device"]["window_s"] / per
            runs.append(r)
            print(json.dumps({k: r[k] for k in ("side", "seed", "rc")}),
                  file=sys.stderr, flush=True)
    return {"cell": name, "other": other, "runs": runs}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=2**31 + 101)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--cell", default="")
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--compare", default="", metavar="DIR")
    p.add_argument("--seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_spans.py needs a CUDA device", file=sys.stderr)
        return 2
    out = {"card": card()}
    if args.compare:
        seeds = [int(s) for s in args.seeds.split(",") if s]
        out["compare"] = compare(os.path.abspath(args.compare), args.cell,
                                 seeds, args.seconds or 10.0)
    elif args.cell:
        out["cell"] = cell_spans(args.cell, args.seed, args.seconds or 35.0)
    else:
        out["bf16_t20"] = bf16_steps(args.seed, args.steps, "cuda",
                                     "build/spans_trace")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
