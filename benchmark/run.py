"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cell's card. The
cell's entry names its configuration (``configs/<config>.json``) and its
traffic mix (``traffic/<traffic>.json``, whose ``loop`` says how the
port is driven: ``loops.py``); every metric is read by its own file,
``metrics/<name>.py``. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (a profiled
window after the measured one), the device's busy and window seconds and
a breakdown. Every run checks the timed path's outputs against the plain
reference (``checks.py``) and prints each number compared beside its
limit, as the last lines on standard error and as the line's last key.

Exits 2 without a result where CUDA or the cell's cards are missing, 3
where JAX or the JAX package was loaded, 1 on any other failure.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
MANIFEST = ROOT.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "rsis_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(manifest: dict, name: str):
    from .checks import load_limits
    from .loops import Cell
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return Cell(name=name, config=load_json(ROOT.parent / conf["file"]),
                mix=load_json(ROOT / "traffic" / f"{entry['traffic']}.json"),
                limits=load_limits(name))


def metric_reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Readings:
    """What a metric reader reads: the cell and the run's outcome, with
    the arithmetic several readers share."""

    def __init__(self, cell, outcome):
        self.cell = cell
        self.outcome = outcome

    def model_flops_per_image(self) -> float:
        from .counts.flops import model_flops
        mix, c = self.cell.mix, self.cell.config
        train = mix["loop"] == "train"
        frozen = train and not float(mix["flags"]["update_encoder"])
        return model_flops(c["base_model"], c["hidden_size"],
                           c["num_classes"], 1, mix["height"], mix["width"],
                           mix["T"], train=train, train_backbone=not frozen)

    def mfu_percent(self):
        from .counts.peaks import mfu_peak
        o = self.outcome
        if not o.images or o.window_s <= 0:
            return None
        rate = self.model_flops_per_image() * o.images / o.window_s
        return 100.0 * rate / mfu_peak(self.cell.config["compute_dtype"])

    def idle_percent(self):
        tr = self.outcome.trace
        if tr is None:
            return None
        window = (tr.window[1] - tr.window[0]) / 1e9
        busy = tr.busy_s()
        return 100.0 * (1.0 - busy / window) if busy > 0 else None

    def roofline_percent(self, kernel: str, counter: str, names):
        """Summed bound over summed device time of a decode-cell kernel's
        launches in the profiled window, or None where it did not run."""
        from .counts.flops import cell_geometries
        from .counts.kernels import step_bound_s
        tr = self.outcome.trace
        calls = self.outcome.counters.get(counter)
        if tr is None or not calls or calls % 5:
            return None
        seconds = tr.device_seconds(names)
        if seconds <= 0:
            return None
        mix, c = self.cell.mix, self.cell.config
        geoms = cell_geometries(mix["height"], mix["width"],
                                c["hidden_size"])
        bound = (calls // 5) * step_bound_s(kernel, mix["batch"], geoms,
                                            c["compute_dtype"])
        return 100.0 * bound / seconds


def read_metrics(manifest: dict, cell, outcome, trace: bool) -> dict:
    kind = "per_layer" if trace else "end_to_end"
    ctx = Readings(cell, outcome)
    out = {}
    for entry in manifest[kind]:
        if not applies(entry, cell.name):
            continue
        value = metric_reader(entry["name"])(ctx)
        if value is not None:
            out[entry["name"]] = {"value": float(value),
                                  "unit": entry["unit"]}
    return out


def forbidden_loaded() -> list:
    return sorted(name for name in sys.modules
                  if name.split(".")[0] in FORBIDDEN)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    manifest = load_json(MANIFEST)
    entry = next((w for w in manifest["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        print(f"the cell needs {entry['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return run_cell(manifest, args, "cuda", _T0)


def run_cell(manifest: dict, args, device, t_start: float, cell=None,
             stdout=None) -> int:
    """The run after the look for a card: set-up, window, check, result
    line. Returns the exit code. cell: the workload's ``loops.Cell``,
    loaded by name from the manifest when None."""
    import torch

    from . import checks, loops
    stdout = stdout or sys.stdout
    cell = cell or load_cell(manifest, args.workload)
    outcome = loops.run(cell, args.seed, args.seconds, bool(args.trace),
                          device, t_start)
    found = forbidden_loaded()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    correct, table = checks.verdict(outcome.numbers, cell.limits)
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1,
        "memory_peak_bytes": outcome.memory_peak_bytes,
    }
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed,
            "metrics": read_metrics(manifest, cell, outcome,
                                    bool(args.trace)),
            "device": device_info}
    if args.trace and outcome.trace is not None:
        tr = outcome.trace
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = (tr.window[1] - tr.window[0]) / 1e9
        line["breakdown"] = {"device_ops": tr.top_ops(10),
                             "idle_gaps": tr.idle_gaps(10)}
    line["checks"] = table
    for note in outcome.notes:
        print(note, file=sys.stderr)
    for name, value in sorted(outcome.numbers.items()):
        if name not in table:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
