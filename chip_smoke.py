#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rsis_tpu_torch``) on one GPU.

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of every kernel in ``rsis_tpu_torch/csrc`` (one nvcc per
     source, all started together);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, in float32 (TF32 off) and bfloat16;
  3. the main path: ``make_forward`` at full width (resnet101, hidden 128,
     9 classes, concat, 512x1024, bfloat16, random weights from --seed)
     answering a few batches, with every kernel's launch count read from
     that run and the outputs held against the port's plain path on the
     card (and, in float32 at T=2, against a tighter tolerance);
  4. timings after warm-up: encoder, decode step and images per second
     from CUDA events around whole calls; each kernel's device time
     (CUDA-graph replay) against its plain version's and its bound;
     with --profile, device time by operation for one forward.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or without the ``rsis_tpu_torch`` package beside it.

Usage: python3 chip_smoke.py [--batch 4] [--steps 10] [--batches 3]
                             [--seed 0] [--out FILE] [--profile]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # fp32 outside the tensor cores
BF16_ULP = 2.0 ** -7               # bf16 spacing relative to magnitude
FP32_TOL = 1e-4                    # kernel vs plain, both fp32 arithmetic


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, after warmup calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of one fn() call: iters calls captured in one CUDA graph
    and replayed, so host-side launch cost is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * iters)


def profile_forward(fn, out_dir) -> None:
    """Device time by operation over one call of fn, and the device's busy
    share of the call's wall time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: an aten op's row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    log(f"profile: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for e in sorted(kernels, key=dev_us, reverse=True)[:25]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "forward_trace.json"))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_ms(n_bytes: int, ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")


def cell_inputs(geom, b, dtype, gen):
    """Random K1 operands at one cell geometry (H, W, C, Cx)."""
    from rsis_tpu_torch.ops.fused_cell import pack_cell_weights
    h, w, ch, cx = geom

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    x_pad = None
    if cx:
        x_pad = torch.nn.functional.pad(rnd(b, h, cx, w), (1, 1, 0, 0, 1, 1))
    weight = torch.randn(4 * ch, cx + ch, 3, 3, generator=gen,
                         device="cuda") * (1.0 / (9 * (cx + ch))) ** 0.5
    return (rnd(b, h, ch, w), x_pad, rnd(b, h, ch, w),
            rnd(b, h, 4 * ch, w, scale=0.5),
            pack_cell_weights(weight, cx, ch, dtype=dtype))


def head_inputs(shape, dtype, gen):
    b, h, c, w = shape
    hs = torch.randn(b, h, c, w, generator=gen, device="cuda").to(dtype)
    weight = torch.randn(1, c, 3, 3, generator=gen, device="cuda") * 0.3
    bias = torch.randn(1, generator=gen, device="cuda")
    return hs, weight, bias


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10, help="decode steps T")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    ap.add_argument("--profile", action="store_true",
                    help="print device time by operation for one forward")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from rsis_tpu_torch import Config
        from rsis_tpu_torch.evals.forward import make_forward
        from rsis_tpu_torch.models import rowmajor_decoder as rmd
        from rsis_tpu_torch.models.decoder import decoder_widths
        from rsis_tpu_torch.models.rsis import build_models, forward
        from rsis_tpu_torch.ops import _build
        from rsis_tpu_torch.ops.fused_cell import (fused_cell_rowmajor,
                                                   fused_cell_rowmajor_ref)
        from rsis_tpu_torch.ops.mask_head import (mask_head_fused_kernel,
                                                  mask_head_ref)
    except ImportError as e:
        print(f"chip_smoke: the rsis_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. card, versions, build -------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, info in sorted(built.items()):
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    b = args.batch
    hidden, height, width = 128, 512, 1024
    widths = decoder_widths(hidden)
    # (H, W, C, Cx) of the five cells and the head input at this geometry
    cell_geoms = []
    for i, ch in enumerate(widths):
        hh, ww = height // 2 ** (5 - i), width // 2 ** (5 - i)
        cell_geoms.append((hh, ww, ch, widths[i - 1] if i else 0))
    head_shape = (b, cell_geoms[-1][0], widths[-1], cell_geoms[-1][1])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    # ---- 2. kernels against their plain versions ----------------------
    log(f"kernel checks at the main path's shapes, B={b}:")
    k1_err = k2_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for i, geom in enumerate(cell_geoms):
            ops = cell_inputs(geom, b, dtype, gen)
            h_k, c_k = fused_cell_rowmajor(*ops, cx=geom[3], ch=geom[2])
            h_r, c_r = fused_cell_rowmajor_ref(*ops, cx=geom[3], ch=geom[2])
            torch.cuda.synchronize()
            for nm, got, want in (("h", h_k, h_r), ("c", c_k, c_r)):
                err = max_err(got, want)
                tol = (FP32_TOL if dtype == torch.float32 else
                       BF16_ULP * want.float().abs().max().item())
                check(f"K1 cell{i} {geom} {tag} {nm}", err, tol)
                if dtype == torch.bfloat16:
                    k1_err = max(k1_err, err)
        # widths that are not multiples of 8 take K1's FMA loop in bf16 too
        geom = (32, 64, 4, 12)
        ops = cell_inputs(geom, 2, dtype, gen)
        for nm, got, want in zip(
                ("h", "c"), fused_cell_rowmajor(*ops, cx=12, ch=4),
                fused_cell_rowmajor_ref(*ops, cx=12, ch=4)):
            tol = (FP32_TOL if dtype == torch.float32 else
                   BF16_ULP * want.float().abs().max().item())
            check(f"K1 {geom} B=2 {tag} {nm}", max_err(got, want), tol)
        hs, hw, hb = head_inputs(head_shape, dtype, gen)
        got = mask_head_fused_kernel(hs, hw, hb)
        want = mask_head_ref(hs, hw, hb)
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = (FP32_TOL if dtype == torch.float32 else
               BF16_ULP * want.float().abs().max().item())
        check(f"K2 head {head_shape} {tag}", err, tol)
        if dtype == torch.bfloat16:
            k2_err = err

    # ---- 3. the main path ----------------------------------------------
    cfg = Config(base_model="resnet101", hidden_size=hidden, num_classes=9,
                 skip_mode="concat", maxseqlen=args.steps,
                 compute_dtype="bfloat16")
    torch.manual_seed(args.seed)
    enc, dec = build_models(cfg)
    weights = (enc.state_dict(), dec.state_dict())
    fwd = make_forward(cfg, T=args.steps)
    xs = [torch.randn(b, height, width, 3, generator=gen, device="cuda")
          for _ in range(args.batches)]
    fused_cell_rowmajor.launches = 0
    mask_head_fused_kernel.launches = 0
    t0 = time.perf_counter()
    outs = [fwd(weights, x) for x in xs]
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = {"fused_cell_rowmajor": fused_cell_rowmajor.launches,
                "mask_head_fused_kernel": mask_head_fused_kernel.launches}
    log(f"main path: {args.batches} batches of {b} at {height}x{width}, "
        f"T={args.steps}, bf16, {t_main:.2f} s (first call included); "
        f"launches {launches}")
    want = {"fused_cell_rowmajor": 5 * args.steps * args.batches,
            "mask_head_fused_kernel": args.steps * args.batches}
    if launches != want:
        raise SystemExit(f"launch counts {launches} != expected {want}")

    masks, clss, stops = outs[-1]
    shapes = (tuple(masks.shape), tuple(clss.shape), tuple(stops.shape))
    want_shapes = ((b, args.steps, height, width), (b, args.steps, 9),
                   (b, args.steps, 1))
    if shapes != want_shapes:
        raise SystemExit(f"output shapes {shapes} != {want_shapes}")
    for t in (masks, clss, stops):
        if not torch.isfinite(t.float()).all():
            raise SystemExit("non-finite output")
    if (clss.float().sum(-1) - 1).abs().max().item() > 2e-2:
        raise SystemExit("class probabilities do not sum to 1")

    # the same weights through the port's plain path on the card
    enc_p, dec_p = build_models(cfg)
    enc_p.load_state_dict(weights[0])
    dec_p.load_state_dict(weights[1])
    enc_p = enc_p.to("cuda", torch.bfloat16)
    dec_p = dec_p.to("cuda")
    x_nchw = xs[-1].permute(0, 3, 1, 2).contiguous()
    plain = forward(cfg, enc_p, dec_p, x_nchw, T=args.steps, plain=True)
    # bf16 h and c round at every cell of every step in both paths; one
    # rounding flip moves a state by one bf16 ulp and the recurrence
    # carries it on, so the outputs agree to a few bf16 ulps of [0, 1].
    main_tol = {"masks": 8 * BF16_ULP, "class_probs": 8 * BF16_ULP,
                "stops": 8 * BF16_ULP}
    main_err = {}
    for nm, got, ref in zip(("masks", "class_probs", "stops"), outs[-1],
                            plain):
        main_err[nm] = max_err(got, ref)
        check(f"main path vs plain path, {nm}", main_err[nm], main_tol[nm])

    # float32 at T=2: the kernels' arithmetic is the plain path's, so the
    # whole forward agrees to fp32 rounding
    cfg32 = Config(base_model="resnet101", hidden_size=hidden,
                   num_classes=9, skip_mode="concat", maxseqlen=2,
                   compute_dtype="float32")
    enc32, dec32 = build_models(cfg32)
    enc32.load_state_dict(weights[0])
    dec32.load_state_dict(weights[1])
    enc32, dec32 = enc32.to("cuda"), dec32.to("cuda")
    x32 = x_nchw[:1]
    got32 = forward(cfg32, enc32, dec32, x32, T=2)
    ref32 = forward(cfg32, enc32, dec32, x32, T=2, plain=True)
    for nm, got, ref in zip(("masks", "class_probs", "stops"), got32, ref32):
        check(f"main path fp32 T=2 vs plain path, {nm}", max_err(got, ref),
              1e-3)
    del enc32, dec32, got32, ref32

    # ---- 4. timings ----------------------------------------------------
    encoder = enc_p
    x = x_nchw.to(torch.bfloat16)
    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: encoder(x), iters=5)
        skips = encoder(x)
        dec_ms = cuda_ms(lambda: rmd.decode_sequence_rowmajor(
            dec_p, skips, args.steps, "concat", dtype=torch.bfloat16),
            iters=3) / args.steps
        fwd_ms = cuda_ms(lambda: forward(cfg, encoder, dec_p, x_nchw,
                                         T=args.steps), iters=3)
        if args.profile:
            profile_forward(
                lambda: forward(cfg, encoder, dec_p, x_nchw, T=args.steps),
                os.path.dirname(os.path.abspath(args.out)) if args.out
                else None)
    img_s = b / (fwd_ms / 1e3)
    log(f"encoder {enc_ms:.3f} ms/batch; decode {dec_ms:.3f} ms/step; "
        f"forward T={args.steps} {fwd_ms:.3f} ms/batch = {img_s:.2f} img/s "
        f"(B={b}, bf16; CUDA events around whole calls, idle gaps "
        f"included)")

    dtype = torch.bfloat16
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
          "ops": 0.0, "cells": []}
    for i, geom in enumerate(cell_geoms):
        hh, ww, ch, cx = geom
        ops_in = cell_inputs(geom, b, dtype, gen)
        kw = {"cx": cx, "ch": ch}
        ms = graph_ms(lambda: fused_cell_rowmajor(*ops_in, **kw), iters=20)
        pms = graph_ms(lambda: fused_cell_rowmajor_ref(*ops_in, **kw),
                       iters=5)
        n_b = nbytes(*ops_in) + 2 * nbytes(ops_in[0])
        n_ops = 2.0 * 4 * ch * 9 * (cx + ch) * b * hh * ww
        bms, by = bound_ms(n_b, n_ops, dtype)
        k1["cells"].append({"cell": i, "geom": list(geom), "ms": ms,
                            "plain_ms": pms, "bound_ms": bms,
                            "bound_by": by})
        for key, val in (("ms", ms), ("plain_ms", pms), ("bound_ms", bms),
                         ("bytes", n_b), ("ops", n_ops)):
            k1[key] += val
        log(f"  K1 cell{i} {geom}: {ms:.4f} ms (plain {pms:.4f}, bound "
            f"{bms:.4f} by {by})")
    k1_by = bound_ms(k1["bytes"], k1["ops"], dtype)[1]
    hs, hw, hb = head_inputs(head_shape, dtype, gen)
    k2_ms = graph_ms(lambda: mask_head_fused_kernel(hs, hw, hb), iters=20)
    k2_pms = graph_ms(lambda: mask_head_ref(hs, hw, hb), iters=5)
    bh, hh, c, ww = head_shape
    k2_bytes = nbytes(hs, hw, hb) + bh * 4 * hh * ww * hs.element_size()
    # channel contraction, dy-summed row stage, dx-summed column stage
    k2_ops = (18.0 * c * bh * hh * ww + 12.0 * bh * 2 * hh * (ww + 2) * 3
              + 12.0 * bh * 4 * hh * ww)
    k2_bms, k2_by = bound_ms(k2_bytes, k2_ops, dtype)
    log(f"  K2 head {head_shape}: {k2_ms:.4f} ms (plain {k2_pms:.4f}, "
        f"bound {k2_bms:.4f} by {k2_by})")

    kernels = [
        {"name": "fused_cell_rowmajor", "route": "cuda",
         "source": "rsis_tpu_torch/csrc/fused_cell.cu",
         "replaces": "rsis_tpu/ops/pallas_decode.py:572",
         "launches": launches["fused_cell_rowmajor"],
         "max_abs_err": k1_err, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1_by, "library_ms": None},
        {"name": "mask_head_fused_kernel", "route": "cuda",
         "source": "rsis_tpu_torch/csrc/mask_head.cu",
         "replaces": "rsis_tpu/ops/pallas_mask_head.py:336",
         "launches": launches["mask_head_fused_kernel"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_pms,
         "bound_ms": k2_bms, "bound_by": k2_by, "library_ms": None},
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "batch": b,
                       "steps": args.steps, "batches": args.batches,
                       "encoder_ms": enc_ms, "decode_ms_per_step": dec_ms,
                       "forward_ms": fwd_ms, "images_per_s": img_s,
                       "main_err": main_err, "k1_cells": k1["cells"],
                       "kernels": kernels}, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s; kernel times are "
        f"device times (CUDA-graph replay): K1 ms is one decode step's five "
        f"launches at B={b}, K2 ms one launch")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
