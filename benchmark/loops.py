"""The two ways a cell drives the port, each as one run: set-up, the
measured window, an optional profiled window, then the check.

- ``infer``: one client in a closed loop. Each call of
  ``rsis_tpu_torch.evals.forward.make_forward``'s function runs one batch
  of the pool, and the loop waits for its outputs before the next call.
- ``train``: ``rsis_tpu_torch.train.step.make_train_step``'s step driven
  as ``train/loop.Trainer`` drives it: one ``train_step`` on one batch,
  then its metrics read to the host. Set-up builds the train state,
  drives it through the mix's checked steps (the first of them builds
  the kernels) and hands that same state to the window.

Nothing compiles inside the window: the port builds its kernels on their
first use (into ``build/rsis_tpu_torch/`` inside the checkout) and every
shape of the cell runs before the window opens.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import trace as tracing
from . import weights
from .reference import infer as ref_infer
from .reference import train as ref_train
from .reference.precision import Precision
from .traffic import generator

ADAM_B1 = 0.9
# the port's launch counters (module, function): each entry point counts
# its launches in ``<function>.launches``
COUNTERS = {
    "k1_launches": ("rsis_tpu_torch.ops.fused_cell", "fused_cell_rowmajor"),
    "k4_launches": ("rsis_tpu_torch.ops.fused_cell_vjp",
                    "cell_backward_dgates"),
}


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict


@dataclass
class Outcome:
    """What one run measured and checked."""
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    images: int = 0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[tracing.Trace] = None
    counters: Dict[str, Optional[int]] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    numbers: Dict[str, float] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)


def sub_seed(seed: int, stream: int) -> int:
    """A 62-bit seed for one of the run's streams (weights, traffic,
    augmentation, sampling), from any whole-number run seed."""
    words = np.random.SeedSequence([abs(int(seed)), int(seed < 0),
                                    stream]).generate_state(2, np.uint32)
    return (int(words[0]) << 30) ^ int(words[1])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def read_counters() -> Dict[str, Optional[int]]:
    out = {}
    for name, (module, fn) in COUNTERS.items():
        try:
            out[name] = int(getattr(importlib.import_module(module),
                                    fn).launches)
        except (ImportError, AttributeError):
            out[name] = None
    return out


def counter_delta(before, after) -> Dict[str, Optional[int]]:
    return {k: (None if before[k] is None or after[k] is None
                else after[k] - before[k]) for k in before}


def window_note(what: str, seconds: List[float]) -> str:
    q = np.percentile(np.array(seconds) * 1e3, [10, 50, 90])
    return (f"window: {len(seconds)} {what}es, ms p10 {q[0]:.3f} median "
            f"{q[1]:.3f} p90 {q[2]:.3f}, first {1e3 * seconds[0]:.3f}")


def port_config(cell: Cell):
    from rsis_tpu_torch.config import Config
    return Config.from_dict(cell.config)


@contextlib.contextmanager
def tf32_setting(value):
    """The configuration's TF32 setting for the port's side: None leaves
    PyTorch's defaults, a bool sets cuDNN's and cuBLAS's flags alike."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if value is not None:
        torch.backends.cuda.matmul.allow_tf32 = bool(value)
        torch.backends.cudnn.allow_tf32 = bool(value)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _record(name: str):
    return torch.profiler.record_function(name)


def inputs(cell: Cell, seed: int, device):
    """(encoder weights, decoder weights, pool of batches) of a run, drawn
    from its seed: what the port and the reference are both given."""
    c, mix = cell.config, cell.mix
    enc, dec = weights.draw(c["base_model"], c["hidden_size"],
                            c["num_classes"], sub_seed(seed, 0), device)
    make = (generator.frame_pool if mix["loop"] == "infer"
            else generator.train_pool)
    return enc, dec, make(mix, c["num_classes"], sub_seed(seed, 1), device)


def check_indices(mix: dict, seed: int) -> List[int]:
    """The window's batches whose outputs are checked, drawn from the
    seed among the first ``check_from_first``."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    return sorted(int(i) for i in rng.choice(
        mix["check_from_first"], mix["check_batches"], replace=False))


def run_infer(cell: Cell, seed: int, seconds: float, trace: bool, device,
              t_start: float) -> Outcome:
    from rsis_tpu_torch.evals.forward import make_forward
    mix, c = cell.mix, cell.config
    out = Outcome()
    with tf32_setting(c["tf32"]):
        cfg = port_config(cell)
        enc, dec, pool = inputs(cell, seed, device)
        fn = make_forward(cfg, T=mix["T"], device=device)
        wts = (enc, dec)
        for i in range(mix["warmup_calls"]):
            fn(wts, pool[i % len(pool)])
            sync(device)
        check_at = check_indices(mix, seed)
        out.setup_s = time.perf_counter() - t_start

        kept, host, lat = {}, [], []
        t0 = time.perf_counter()
        i = 0
        while True:
            a = time.perf_counter()
            res = fn(wts, pool[i % len(pool)])
            b = time.perf_counter()
            sync(device)
            done = time.perf_counter()
            host.append(b - a)
            lat.append(done - a)
            if i in check_at:
                kept[i] = res
            i += 1
            if done - t0 >= seconds and i > check_at[-1]:
                break
        out.window_s = done - t0
        out.attempted = i
        out.images = i * mix["batch"]
        out.spans = {"forward_call": host, "batch": lat}
        out.notes.append(window_note("batch", lat))
        del res

        if trace:
            before = read_counters()

            def traced():
                for j in range(mix["trace_batches"]):
                    with _record("bench.forward"):
                        fn(wts, pool[(i + j) % len(pool)])
                    with _record("bench.wait"):
                        sync(device)
            out.trace = tracing.profile(traced)
            out.counters = counter_delta(before, read_counters())
        out.memory_peak_bytes = memory_peak(device)
        del fn
        free(device)

    readings = []
    for idx, port in sorted(kept.items()):
        ref = ref_infer.forward(enc, dec, pool[idx % len(pool)], mix["T"],
                                c["hidden_size"], Precision("fp32"),
                                base_model=c["base_model"])
        readings.append(compare_infer(port, ref))
        del ref
    gaps = {k: max(r[k] for r in readings) for k in readings[0]}
    out.numbers = gaps
    return out


def compare_infer(port, ref) -> Dict[str, float]:
    """One batch's readings, program against reference: the largest
    gap of any mask pixel; the worst answer's (image and step) mean mask
    gap; the mean gaps of the class probabilities and stop scores."""
    masks, clss, stops = (t.float() for t in port)
    dm = (masks - ref[0]).abs()
    return {"mask_gap": float(dm.max()),
            "mask_answer_gap": float(dm.flatten(2).mean(-1).max()),
            "class_mean_gap": float((clss - ref[1]).abs().mean()),
            "stop_mean_gap": float((stops - ref[2]).abs().mean())}


def first_gradient_norms(state) -> Dict[str, float]:
    """The first step's gradient as Adam takes it (with its L2 decay),
    worked out from the optimizer state after one step, mu / (1 - b1),
    for every leaf of a group that moved; a leaf norm each."""
    norms = {}
    for opt in (state.enc_opt, state.dec_opt):
        if opt.get("count", 0) == 1:
            for key, mu in opt["mu"].items():
                norms[key] = float(torch.linalg.vector_norm(
                    mu.double() / (1.0 - ADAM_B1)))
    return norms


def change_norms(params, enc0, dec0) -> Dict[str, float]:
    """Leaf norms of the change from the drawn weights."""
    out = {}
    for key, p in params.items():
        part, leaf = key.split(".", 1)
        start = (enc0 if part == "encoder" else dec0)[leaf]
        out[key] = float(torch.linalg.vector_norm(
            p.detach().double() - start.double()))
    return out


def train_flags(mix):
    from rsis_tpu_torch.train.step import StepFlags
    f = mix["flags"]
    return StepFlags(use_class_loss=float(f["use_class_loss"]),
                     use_stop_loss=float(f["use_stop_loss"]),
                     update_encoder=float(f["update_encoder"]))


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device,
              t_start: float) -> Outcome:
    from rsis_tpu_torch.train.step import create_train_state, make_train_step
    mix, c = cell.mix, cell.config
    out = Outcome()
    aug_seed = sub_seed(seed, 3)
    checked = mix["check_steps"]
    with tf32_setting(c["tf32"]):
        cfg = port_config(cell)
        enc, dec, pool = inputs(cell, seed, device)
        if len(pool) < checked:
            raise ValueError("the pool holds fewer batches than the checked "
                             "steps")
        state = create_train_state(cfg, weights=(enc, dec), device=device)
        train_step, _ = make_train_step(cfg, T=mix["T"], device=device)
        rng = torch.Generator(device=device).manual_seed(aug_seed)
        flags = train_flags(mix)
        losses = []
        for k in range(checked):
            state, m = train_step(state, pool[k], flags, rng)
            losses.append([float(v) for v in m.cpu()])
            if k == 0:
                grad1 = first_gradient_norms(state)
        change = change_norms(state.params(), enc, dec)
        out.setup_s = time.perf_counter() - t_start

        host, whole = [], []
        t0 = time.perf_counter()
        j = checked
        while True:
            a = time.perf_counter()
            state, m = train_step(state, pool[j % len(pool)], flags, rng)
            b = time.perf_counter()
            m.cpu()
            done = time.perf_counter()
            host.append(b - a)
            whole.append(done - a)
            j += 1
            if done - t0 >= seconds:
                break
        out.window_s = done - t0
        out.attempted = j - checked
        out.images = out.attempted * mix["batch"]
        out.spans = {"train_step_call": host, "step": whole}
        out.notes.append(window_note("step", whole))

        if trace:
            before = read_counters()

            def traced():
                nonlocal state
                for n in range(mix["trace_steps"]):
                    with _record("bench.train_step"):
                        state, met = train_step(
                            state, pool[(j + n) % len(pool)], flags, rng)
                    with _record("bench.metrics_read"):
                        met.cpu()
            out.trace = tracing.profile(traced)
            out.counters = counter_delta(before, read_counters())
        out.memory_peak_bytes = memory_peak(device)
        del state, train_step, m
        free(device)

    ref = ref_train.train_steps(c, enc, dec, pool[:checked], mix["flags"],
                                mix["T"], aug_seed, Precision("fp32"))
    out.numbers, notes = compare_train(losses, grad1, change, ref, enc, dec)
    out.notes += notes
    return out


def total_gap(program: Dict[str, float], reference: Dict[str, float],
              keys) -> float:
    """The relative gap of the norm over all the keys' leaves at once."""
    a = float(np.sqrt(sum(program.get(k, 0.0) ** 2 for k in keys)))
    b = float(np.sqrt(sum(reference[k] ** 2 for k in keys)))
    return abs(a - b) / b if b > 0 else 0.0


def compare_train(losses, grad1, change, ref, enc, dec):
    """The train step's readings against the reference's (see
    ``checks.py``; a cell compares those its limits name). Returns
    (readings, notes naming the worst leaves)."""
    loss_gap = max(abs(p[0] - r[0]) / abs(r[0])
                   for p, r in zip(losses, ref["losses"]))
    loss1_gap = abs(losses[0][0] - ref["losses"][0][0]) / abs(
        ref["losses"][0][0])
    ref_grad = ref_train.leaf_norms(ref["grad1"])
    keys = sorted(set(ref_grad) & set(grad1))
    missing = sorted(set(ref_grad) ^ set(grad1))
    grad = ref_train.leaf_gaps(grad1, ref_grad, keys)
    raw = ref_train.leaf_norms(ref["raw_grad1"])
    median_raw = float(np.median(list(raw.values())))
    dropped = sorted(k for k, v in raw.items() if v < 1e-3 * median_raw)
    ref_change = change_norms(ref["params"], enc, dec)
    ckeys = sorted(k for k in ref_change if k not in dropped)
    moved = ref_train.leaf_gaps(change, ref_change, ckeys)
    grad_gap, grad_leaf = max((v, k) for k, v in grad.items())
    if missing:
        grad_gap, grad_leaf = float("inf"), f"unmatched leaves {missing[:3]}"
    change_gap, change_leaf = max((v, k) for k, v in moved.items())
    readings = {
        "loss_gap": loss_gap, "loss1_gap": loss1_gap,
        "grad_gap": grad_gap,
        "grad_total_gap": total_gap(grad1, ref_grad, keys),
        "change_gap": change_gap,
        "change_median_gap": float(np.median(list(moved.values()))),
    }
    notes = [f"losses program {[round(p[0], 6) for p in losses]} reference "
             f"{[round(r[0], 6) for r in ref['losses']]}",
             f"grad_gap worst leaf {grad_leaf}",
             f"change_gap worst leaf {change_leaf}; left out (reference "
             f"gradient under 1e-3 of the median leaf's): {dropped}"]
    return readings, notes


LOOPS = {"infer": run_infer, "train": run_train}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Outcome:
    return LOOPS[cell.mix["loop"]](cell, seed, seconds, trace, device,
                                       t_start)

