#!/usr/bin/env python3
"""K5 (the weight gradient) per cell and the bench-geometry train step,
timed on one GPU, for comparing two trees of the port in one call.

Runs the ``rsis_tpu_torch`` package beside it (run a copy of this script
from the root of another tree to time that tree), with ``chip_smoke.py``'s
inputs, timers and bounds:

- --k5: ``weight_grad_rowmajor`` at the train step's five cells (256x512
  input, hidden 128, bf16) for each --k5-batch: device ms of one launch
  (CUDA-graph replay), its bound, ``torch.nn.grad.conv2d_weight`` on NCHW
  copies of the same inputs, and the error against ``weight_grad_ref``;
- --sweep: every tensor-core plan of K5 at those cells and batches
  (``weight_grad_plan`` replaced for the call), each checked against the
  plain version, the fastest beside the chosen one;
- --step: the train step at --batch, --steps (resnet101, device
  augmentation on, bf16): a warm-up step, then --iters steps each timed
  by the host clock around a synchronised step; with --profile, device
  time by kernel over one more step and K5's share of it.

Prints one JSON object as its last line (and writes it to --out).
Usage: python3 chip_k5_step.py [--k5] [--k5-batch 32 8] [--sweep] [--step]
                               [--batch 32] [--steps 20] [--iters 5]
                               [--profile] [--seed 0] [--out FILE]
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def _short(kernel: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0]


def time_k5(cs, b: int, gen) -> list:
    from rsis_tpu_torch.models.decoder import decoder_widths
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    widths = decoder_widths(128)
    rows = []
    for i, ch in enumerate(widths):
        hh, ww = cs.TRAIN_HW[0] // 2 ** (5 - i), cs.TRAIN_HW[1] // 2 ** (5 - i)
        cx = widths[i - 1] if i else 0
        ops, (dh, dc) = cs.bwd_inputs((hh, ww, ch, cx), b, torch.bfloat16,
                                      gen)
        h_prev, x_pad = ops[0], ops[1]
        kw = {"cx": cx, "ch": ch}
        dg = fcv.cell_backward_dgates_ref(*ops, dh, dc, **kw)[0]
        want = fcv.weight_grad_ref(h_prev, x_pad, dg, **kw)
        got = fcv.weight_grad_rowmajor(h_prev, x_pad, dg, **kw)
        err = cs.max_err(got, want) / (
            cs.BF16_ULP * want.float().abs().max().item())
        xh = torch.cat([t.permute(0, 2, 1, 3).contiguous() for t in
                        ([x_pad[:, 1:-1, :, 1:-1]] if cx else [])
                        + [h_prev]], dim=1)
        dg_nchw = dg.permute(0, 2, 1, 3).contiguous()
        ms = cs.graph_ms(lambda: fcv.weight_grad_rowmajor(h_prev, x_pad, dg,
                                                          **kw), iters=20)
        lms = cs.graph_ms(lambda: torch.nn.grad.conv2d_weight(
            xh, (4 * ch, cx + ch, 3, 3), dg_nchw, padding=1), iters=20)
        bms, by = cs.bound_ms(cs.nbytes(h_prev, x_pad, dg, ops[4]),
                              2.0 * 4 * ch * 9 * (cx + ch) * b * hh * ww,
                              torch.bfloat16)
        rows.append({"cell": i, "geom": [hh, ww, ch, cx], "batch": b,
                     "ms": ms, "library_ms": lms, "bound_ms": bms,
                     "bound_by": by, "err_ulps": err})
        print(f"K5 cell{i} ({hh}, {ww}, {ch}, {cx}) B={b}: {ms:.4f} ms "
              f"(conv2d_weight {lms:.4f}, bound {bms:.4f} by {by}; error "
              f"{err:.3f} bf16 ulps of the max)", flush=True)
    print(f"K5 B={b}: {sum(r['ms'] for r in rows):.4f} ms a decode step "
          f"(conv2d_weight {sum(r['library_ms'] for r in rows):.4f}, bound "
          f"{sum(r['bound_ms'] for r in rows):.4f})", flush=True)
    return rows


def sweep_k5(cs, b: int, gen, top: int = 5) -> dict:
    """Every tensor-core plan of K5 (warp tile, warps, unit, ring, one or
    more blocks an SM) at the train step's five cells, timed like time_k5
    and checked against the plain version; returns each cell's fastest
    plans beside the one weight_grad_plan chooses."""
    import dataclasses
    import itertools
    from rsis_tpu_torch.models.decoder import decoder_widths
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    chosen = fcv.weight_grad_plan
    widths = decoder_widths(128)
    out = {}
    for i, ch in enumerate(widths):
        hh, ww = cs.TRAIN_HW[0] // 2 ** (5 - i), cs.TRAIN_HW[1] // 2 ** (5 - i)
        cx = widths[i - 1] if i else 0
        ops, (dh, dc) = cs.bwd_inputs((hh, ww, ch, cx), b, torch.bfloat16,
                                      gen)
        h_prev, x_pad, kw = ops[0], ops[1], {"cx": cx, "ch": ch}
        dg = fcv.cell_backward_dgates_ref(*ops, dh, dc, **kw)[0]
        want = fcv.weight_grad_ref(h_prev, x_pad, dg, **kw)
        tol = cs.BF16_ULP * want.float().abs().max().item()
        m, cn = 4 * ch, cx + ch
        rows = []
        for wa, wc, wm, wcn, r, tw, st in itertools.product(
                (1, 2), (1, 2), range(1, 9), range(1, 9), (2, 4, 8),
                (16, 32, 64, 128), (2, 3)):
            mb, cb = 16 * wa * wm, 8 * wc * wcn
            if (not 4 <= wm * wcn <= 8 or m % mb or cn % cb or r > hh
                    or tw > -(-ww // 16) * 16):
                continue
            plan = fcv.WeightGradPlan(True, 1, wa, wc, wm, wcn, r, tw, st)
            smem = plan.smem_bytes()
            if smem > fcv.SMEM_LIMIT:
                continue
            per_sm = 2 if wa * wc < 4 and smem <= 113 * 1024 else 1
            for blocks in sorted({1, per_sm}):
                plan = dataclasses.replace(plan, chunks=max(1, min(
                    plan.units(b, hh, ww), blocks * fcv.SM_COUNT
                    // ((m // mb) * (cn // cb)))))
                fcv.weight_grad_plan = lambda *a, plan=plan: plan
                try:
                    err = cs.max_err(fcv.weight_grad_rowmajor(
                        h_prev, x_pad, dg, **kw), want)
                    ms = cs.graph_ms(lambda: fcv.weight_grad_rowmajor(
                        h_prev, x_pad, dg, **kw), iters=10)
                finally:
                    fcv.weight_grad_plan = chosen
                if err > tol:
                    raise SystemExit(f"K5 cell{i} {plan}: error {err} "
                                     f"over {tol}")
                rows.append((ms, dataclasses.astuple(plan)))
        rows.sort()
        mine = dataclasses.astuple(chosen(b, hh, ww, ch, cx, torch.bfloat16))
        mine_ms = [ms for ms, p in rows if p == mine]
        out[i] = {"chosen": mine, "chosen_ms": mine_ms[0] if mine_ms
                  else None, "best": rows[:top], "plans": len(rows)}
        print(f"K5 sweep cell{i} B={b}: {len(rows)} plans; chosen {mine} "
              f"{out[i]['chosen_ms']} ms; fastest "
              + "; ".join(f"{p} {ms:.4f}" for ms, p in rows[:top]),
              flush=True)
    return out


def time_step(cs, args) -> dict:
    import numpy as np
    from rsis_tpu_torch.data.synthetic import synthetic_wire_batch
    from rsis_tpu_torch.models.rsis import build_models
    from rsis_tpu_torch.train import step as ts
    b, T = args.batch, args.steps
    cfg = cs.train_config(b, T)
    torch.manual_seed(args.seed)
    enc, dec = build_models(cfg)
    weights = (enc.state_dict(), dec.state_dict())
    del enc, dec
    img, tgt = synthetic_wire_batch(np.random.default_rng(args.seed), b,
                                    *cs.TRAIN_HW, cfg.gt_maxseqlen,
                                    cfg.num_classes)
    batch = (torch.from_numpy(img).cuda(), torch.from_numpy(tgt).cuda())
    flags = ts.StepFlags(use_class_loss=1.0, use_stop_loss=1.0,
                         update_encoder=1.0)
    step, _ = ts.make_train_step(cfg, T=T)
    state = ts.create_train_state(cfg, weights)
    gen = cs.cuda_generator(args.seed)
    state, metrics = step(state, batch, flags, gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, flags, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"batch": b, "steps": T, "ms": times,
           "median_ms": float(np.median(times)),
           "loss": metrics[0].item()}
    print(f"train step B={b}, T={T}: {[round(t, 3) for t in times]} ms "
          f"(median {out['median_ms']:.3f})", flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch, flags, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = {e.key: (e.count, getattr(
            e, "self_device_time_total",
            getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
        busy = sum(ms for _, ms in kernels.values())
        # K5's kernels: dwt_* and, in a tree before the dwt_ prefix on
        # its second pass, the anonymous namespace's reduce_kernel
        k5 = {k: v for k, v in kernels.items()
              if "dwt_" in k or "namespace)::reduce_kernel" in k}
        out["profile"] = {"wall_ms": wall_ms, "busy_ms": busy,
                          "idle_share": 1 - busy / wall_ms,
                          "k5": {k: list(v) for k, v in k5.items()}}
        out["k5_device_ms"] = sum(ms for _, ms in k5.values())
        out["k5_share"] = out["k5_device_ms"] / busy
        print(f"profiled step: device busy {busy:.3f} ms of {wall_ms:.3f} "
              f"ms wall (idle share {1 - busy / wall_ms:.3f}); K5 "
              f"{out['k5_device_ms']:.3f} ms ({out['k5_share']:.3f}) in "
              + ", ".join(f"{_short(k)} x{n} {ms:.3f}"
                          for k, (n, ms) in k5.items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k5", action="store_true")
    ap.add_argument("--k5-batch", type=int, nargs="+", default=[32, 8])
    ap.add_argument("--sweep", action="store_true",
                    help="time every tensor-core plan of K5 per cell at "
                    "each --k5-batch")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k5_step: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"card": cs.card_line(), "tree": here}
    print(f"card: {result['card']}; tree {here}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.k5:
        result["k5"] = {b: time_k5(cs, b, gen) for b in args.k5_batch}
    if args.sweep:
        result["sweep"] = {b: sweep_k5(cs, b, gen) for b in args.k5_batch}
    if args.step:
        result["step"] = time_step(cs, args)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
