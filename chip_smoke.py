#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rsis_tpu_torch``) on one GPU.

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     the build of all eight kernels in ``rsis_tpu_torch/csrc`` (one nvcc
     per source, all started together; each entry function's registers
     and spills) and of the host RLE library
     (``rsis_tpu_torch/kernels/rle``, g++);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes its main path gives it, in float32 (TF32 off) and bfloat16:
     the forward kernel K1 at the inference geometry, the mask head K2 in
     both its layouts ((B, H, C, W) of the concat decode, (B, C, H, W) of
     the mul decode) at the head's shape at B=32, 4 and --batch, at the
     train step's head shape and at edge shapes of its launch plan (twice
     on the same inputs with bit-identical results), the
     ConvLSTM step K8 at the mul decode's five cells at B=32 and 4 and at
     edge shapes of its launch plan (twice on the same inputs with
     bit-identical results), the
     backward kernels K4, K5 and K3 at the train step's five cells (K1,
     K4, K5 and K3 also at edge shapes of their launch plans, and twice
     on the same inputs with bit-identical results; K3 also at B = 8 and
     32, its pullback's dx_pad and dh_prev equal to its stacked output's
     slice and pad bit for bit), the LAP matcher K6 on random and
     tie-heavy costs at the train step's shapes and at K6_EDGE_SHAPES
     (also all-equal and negative costs; each case also as a transposed
     view; row4col identical to the plain version's, twice on the same
     inputs with identical results), the cell's whole backward
     (K4 + K5 + K3) against autograd through the plain cell, and the
     augmentation warp K7 at the train geometry (bit-identical: random
     flips at the JAX bench's ranges, the identity, a strong translation
     that clamps at the borders) and at K7_EDGE_GEOMS (row tails, narrow
     stores, C = 1-4, misaligned inputs), twice on the same inputs
     with bit-identical results;
  3. the inference path: ``make_forward`` at full width (resnet101, hidden
     128, 9 classes, concat, 512x1024, bfloat16, random weights from
     --seed) answering a few batches, with K1's and K2's launch counts
     read from that run and the outputs held against the port's plain path
     on the card (and, in float32 at T=2, against a tighter tolerance);
  3b. the same with mul skips (the plain decode, whose cells run K8 and
     whose head runs K2 on the NCHW state): K8 launched 5 T times and K2
     T times a forward, K1 never, the outputs held against the plain
     path, images per second;
  3c. the evaluation entry points in process on the card:
     ``cli.eval_cityscapes`` (2 images at 1024x2048, input 512x1024,
     T=20, built-in AP), ``cli.eval_leaves`` (CVPPP A1), ``cli.eval``
     (Pascal, COCO stats) and ``cli.predict``, on trees and full-width
     checkpoints (concat and mul) written under build/ from --seed: their
     outputs, finite scores and launches per forward checked, wall time
     per image and the forward's share of it;
  4. the training path: ``make_train_step`` at full width (the same model,
     256x512, gt_maxseqlen 20, bfloat16, device augmentation on as in the
     JAX bench, all three step flags on) on one synthetic uint8 wire batch
     with a CUDA generator: a warm-up step, then three timed steps with
     every kernel's launch count read from them (K7 once a step) and the
     loss falling; one step held against the plain path on the card from a
     generator of the same seed (bfloat16 and float32 at T=2: the loss and
     every gradient; bfloat16 gradients also against the float32 plain
     path at the same geometry, step_grad_verdict); one step with the
     three dropouts at 0.2;
  4b. the trainer: ``python -m rsis_tpu_torch.cli.train``'s ``main`` at
     full width on the synthetic dataset (256x256, batch 8, 16 images a
     split, augmentation and curriculum learning, 2 epochs) into a
     directory under build/, then again with --resume: the epoch lines,
     the checkpoint files, the resumed epoch numbers and the growing
     metrics.jsonl are checked; the loop's ms per train step and images
     per second (data loading included) beside the step's alone;
  4c. the trainer's options and the tools beside them, at the same width:
     ``cli.train`` from a seeded torchvision-layout resnet101 file
     (``-torch_encoder``, encoder frozen) with host augmentation and
     ``--visdom`` (K7 never launched, the backbone still the file's, one
     mask snapshot an epoch, the dashboard serving metrics.jsonl and the
     snapshots, ``parse_train_log``), then ``--transfer`` from that run to
     a CVPPP tree (a 2-output ``fc_class``), one train step under
     ``utils.profiling.trace`` (K1's and K4's kernels in its table), and
     ``cli.verify_parity --device`` on the eval phase's concat and mul
     checkpoints (2 images, 512x1024, T=20, fp32: deltas within the
     1e-3 budget, the forward's kernels launched);
  5. timings after warm-up: encoder, decode step, images per second and
     train ms per step from CUDA events or host clocks around whole,
     synchronised calls; each kernel's device time (CUDA-graph replay)
     against its plain version's, its bound and, where one exists, the
     PyTorch library call for the same function (K2 in both layouts,
     beside the two-call interpolate + conv2d yardstick); with --profile,
     device time by operation and the idle share of one forward, one
     step, a resumed trainer run and the Cityscapes evaluation.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or without the ``rsis_tpu_torch`` package beside it.

Usage: python3 chip_smoke.py [--batch 4] [--steps 10] [--batches 3]
                             [--train-batch 8] [--train-steps 5]
                             [--seed 0] [--out FILE]
                             [--profile]
(--batch 32 --steps 20 --batches 1 is the decode bench geometry,
--train-batch 32 --train-steps 20 the train bench geometry.)
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
CELL_BWD_BF16_ULPS = 2             # FusedCellFunction bf16 vs autograd
# the bf16 train step's gradients against the plain path's, in bf16 ulps
# of each tensor's largest magnitude (step_grad_verdict: where the plain
# bf16 path itself is farther than this from the fp32 path, the kernel
# path is held against fp32 instead). Read on an H100 at B=8, T=5 and
# B=32, T=20 without augmentation: the decoder group (the kernels' own
# gradients, the skip convolutions, the heads) at most 0.79, the backbone
# 8.9-13.0 across runs, always at its first BatchNorm's bias: a sum over
# every pixel of the batch that nearly cancels, behind cuDNN's
# nondeterministic backward
STEP_GRAD_BF16_ULPS = {"backbone": 32, "decoder": 3}
STEP_LOSS_BF16_REL = 1e-3          # bf16 train step's loss vs plain
# K5's edge shapes ((H, W, C, Cx), B), beside the train step's cells
K5_EDGE_GEOMS = [((6, 24, 8, 0), 1), ((10, 40, 8, 8), 2),
                 ((11, 48, 16, 8), 1), ((6, 24, 16, 16), 1),
                 ((9, 40, 32, 16), 2)]
# K3's edge shapes ((H, W, C, Cx), B; Cin = 4C, Cout = Cx + C): each warp
# tile, split, ring depth and weight staging of its plan, H and W off the
# unit, W below one unit, B=1, Cx=0, C=8 (Cout 8 and 24), several output
# channel tiles, one across the dx / dh border
K3_EDGE_GEOMS = [((6, 24, 8, 0), 1), ((10, 40, 8, 16), 2),
                 ((17, 8, 16, 32), 1), ((17, 136, 32, 32), 3),
                 ((9, 136, 8, 32), 3), ((3, 8, 32, 8), 1),
                 ((9, 24, 16, 16), 1), ((17, 8, 8, 8), 1),
                 ((17, 136, 32, 40), 3)]
# K1's and K4's edge shapes ((H, W, C, Cx), B): between their two plans
# (the forward's five epilogue planes, the backward's seven) each warp
# tile, ring depth, chunk width (C = 8: the narrow chunk), channel tiling
# and split of cell_plan, the weight chunk resident and streamed, H and W
# off the unit, W below one unit, B=1, Cx=0
K1_EDGE_GEOMS = [((1, 8, 8, 0), 1), ((9, 40, 8, 16), 2),
                 ((3, 24, 32, 8), 1), ((1, 8, 64, 0), 1),
                 ((17, 136, 64, 0), 2), ((17, 136, 32, 0), 3),
                 ((2, 136, 64, 8), 1), ((17, 40, 32, 8), 3)]
# K8's edge shapes ((H, W, Cx, C), B): each warp tile, ring depth, chunk
# width (C = 8: the narrow chunk), channel tiling and split of
# cell_plan(..., kind="step"), the weight chunk resident and streamed,
# two blocks an SM, H and W off the unit, W below one unit, B=1, odd H
# (the JAX kernel rejects odd H)
K8_EDGE_GEOMS = [((1, 8, 8, 8), 1), ((17, 40, 16, 8), 2),
                 ((3, 24, 8, 32), 1), ((1, 8, 64, 64), 1),
                 ((17, 136, 64, 64), 2), ((17, 136, 32, 32), 3),
                 ((17, 40, 8, 32), 3), ((129, 264, 16, 8), 2)]
# K2's edge shapes (B, H, C, W), beside the head's shapes at 512x1024 and
# 256x512: each column width of its plan (v = 4, 2, 1), H = W = 1, odd W,
# W off a warp's columns (a part warp, five warps), rows a block that do
# not divide H, C = 3, 5 and 16 (two channel chunks), B = 1, and a row
# wider than one block (strips with halo threads)
K2_EDGE_GEOMS = [(1, 1, 8, 1), (2, 5, 3, 7), (2, 13, 8, 70),
                 (3, 9, 16, 200), (1, 17, 8, 520), (2, 33, 5, 36),
                 (8, 99, 8, 512), (1, 6, 8, 1100)]
# K6's edge shapes (B, nr, nc): one and several register slots a lane
# (nc = 1, 32, 33, 64, 128), nr = 1, 1 < nr < nc (the transposed view's
# staging with its two strides apart) and nr = nc, B = 1, 3 and 33 (a
# small B at large nc: the host oracle is slow there); each in check_lap
# with random, tie-heavy, all-equal and negative (with -0.0) costs,
# contiguous and as a transposed view
K6_EDGE_SHAPES = [(33, 1, 1), (3, 1, 32), (33, 32, 32), (3, 1, 33),
                  (3, 5, 33), (3, 33, 33), (1, 1, 64), (3, 20, 64),
                  (3, 64, 64), (1, 1, 128), (1, 128, 128)]
# K7's edge geometries (B, H, W, C), each in fp32 and bf16 in check_warp:
# W = 1, 7 and 9 (a row's tail alone, stores narrower than 16 bytes), 513
# (a tail after a whole segment), H = 1, C = 1, 2 and 4 (a pixel as one 4-,
# 8- or 16-byte vector load) and 3, B = 1; at C = 2 and 4 also with the
# image and the ids at a misaligned address (element gathers)
K7_EDGE_GEOMS = [(1, 1, 1, 3), (2, 3, 7, 1), (1, 5, 9, 4), (2, 1, 513, 3),
                 (1, 4, 513, 4), (3, 6, 9, 3), (1, 2, 64, 1), (2, 3, 40, 2),
                 (2, 5, 40, 4)]
TRAIN_HW = (256, 512)              # the train step's input (imsize 256)
TRAIN_ITERS = 3                    # timed train steps after the warm-up
# the JAX train bench's augmentation ranges; the zoom is zoom_range_for's
# for the default dataset (pascal, zoom 0.7)
WARP_RANGES = (10.0, 0.1, 0.1, (0.7, 1.4))  # rotation, translation, shear


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log_ptxas(name: str, text: str) -> None:
    """nvcc's -Xptxas=-v report of one library: each entry function's
    registers and spills, under the function's (mangled) name."""
    for line in text.splitlines():
        if "Function properties for" in line:
            log(f"  {name}: {line.split('for', 1)[1].strip()[:120]}")
        elif "registers" in line or "spill" in line:
            log(f"  {name}:   {line.strip()}")


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


def profile_call(fn, out_dir, name: str) -> dict:
    """Device time by operation over one call of fn, and the device's busy
    share of the call's wall time (torch.profiler). Returns the idle share
    and the device ms of the 25 busiest operations."""
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
    idle = 1 - busy_ms / wall_ms
    log(f"profile {name}: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
        f"wall (idle share {idle:.3f})")
    top = sorted(kernels, key=dev_us, reverse=True)[:25]
    for e in top:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": idle,
            "top": [[e.key, e.count, dev_us(e) / 1e3] for e in top]}


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


def step_grad_rows(g_k, g_p, g_f=None, ulp: float = BF16_ULP) -> dict:
    """Distances between the train step's gradients, tensor by tensor:
    kernel path g_k, plain path g_p and, where given, the fp32 path g_f
    (name -> tensor dicts). Each distance is the largest elementwise
    difference in units of ulp (default one bf16 ulp) times the tensor's
    scale: the largest magnitude of its plain gradient, floored at 1e-3
    of the largest of all (the skip convolutions' biases feed BatchNorm:
    their true gradient is zero and every path returns noise). Returns name -> {"group": "backbone"
    (encoder.base.*) or "decoder" (the rest), "kp": |kernel - plain|,
    "pf": |plain - fp32|, "kf": |kernel - fp32|}, pf and kf None without
    g_f."""
    top = max(g.abs().max().item() for g in g_p.values())
    rows = {}
    for k, gp in g_p.items():
        unit = ulp * max(gp.abs().max().item(), 1e-3 * top)
        row = {"group": "backbone" if k.startswith("encoder.base.")
               else "decoder", "kp": max_err(g_k[k], gp) / unit,
               "pf": None, "kf": None}
        if g_f is not None:
            row["pf"] = max_err(gp, g_f[k]) / unit
            row["kf"] = max_err(g_k[k], g_f[k]) / unit
        rows[k] = row
    return rows


def step_grad_verdict(row: dict, limit: float) -> tuple:
    """The bf16 train step's rule for one gradient tensor (a row of
    step_grad_rows), limit in ulps: where the plain bf16 path is within
    limit of the fp32 path, or no fp32 path ran, the kernel path must be
    within limit of the plain path; where the plain path itself is
    farther, both bf16 paths miss the truth by more than the limit and
    their difference is that error's noise, so the kernel path may be no
    farther from fp32 than the plain path, plus limit. Returns (ok, the
    held distance, its limit, "plain" or "fp32")."""
    if row["pf"] is None or row["pf"] <= limit:
        return row["kp"] <= limit, row["kp"], limit, "plain"
    bound = row["pf"] + limit
    return row["kf"] <= bound, row["kf"], bound, "fp32"


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


HEAD_LAYOUTS = ("rowmajor", "nchw")


def head_case(shape, layout, dtype, gen):
    """K2's operands at one head shape (B, H, C, W) in one layout, its
    wrapper and its plain version: "rowmajor" hs (B, H, C, W), the concat
    decode's (``mask_head_fused_kernel``), or "nchw" (B, C, H, W), the
    plain decoder's (``mask_head_nchw_kernel``)."""
    from rsis_tpu_torch.ops import mask_head as mh
    hs, weight, bias = head_inputs(shape, dtype, gen)
    if layout == "rowmajor":
        return ((hs, weight, bias), mh.mask_head_fused_kernel,
                mh.mask_head_ref)
    return ((hs.transpose(1, 2).contiguous(), weight, bias),
            mh.mask_head_nchw_kernel, mh.mask_head_nchw_ref)


def head_plan_tag(shape, layout, dtype) -> str:
    """K2's launch plan at one head shape and layout, for the check lines."""
    from rsis_tpu_torch.ops.mask_head import mask_head_plan
    b, h, c, w = shape
    strides = ((h * c * w, w, c * w) if layout == "rowmajor"
               else (c * h * w, h * w, w))
    p = mask_head_plan(b, h, c, w, dtype, strides)
    return (f"(v={p.v}, {p.rows} rows a block, {p.warps} warps, "
            f"{p.strips(w)} strips)")


def head_bound(shape, dtype) -> tuple[float, str]:
    """K2's bound at one head shape (B, H, C, W): the input, the fp32
    weight and bias read once and the (B, 2H, 2W) output written once; the
    channel contraction, the dy-summed row stage and the dx-summed column
    stage as operations."""
    b, h, c, w = shape
    size = torch.empty((), dtype=dtype).element_size()
    n_bytes = b * h * c * w * size + 4 * (9 * c + 1) + b * 4 * h * w * size
    ops = (18.0 * c * b * h * w + 12.0 * b * 2 * h * (w + 2) * 3
           + 12.0 * b * 4 * h * w)
    return bound_ms(n_bytes, ops, dtype)


def check_k2(shapes, gen) -> float:
    """K2 against its plain version in both layouts at the head shapes
    (B, H, C, W) given and at K2_EDGE_GEOMS: fp32 (TF32 off) within
    FP32_TOL, bf16 within one bf16 ulp of max|ref|; each launched twice on
    the same inputs with bit-identical results. Returns the worst bf16
    error."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for shape in list(shapes) + K2_EDGE_GEOMS:
            for layout in HEAD_LAYOUTS:
                ops, kern, ref = head_case(shape, layout, dtype, gen)
                got = kern(*ops)
                again = kern(*ops)
                want = ref(*ops)
                torch.cuda.synchronize()
                name = (f"K2 {shape} {layout} {tag} "
                        + head_plan_tag(shape, layout, dtype))
                err = max_err(got, want)
                check(name, err, tol_for(dtype, want))
                if not torch.equal(got, again):
                    raise SystemExit(f"{name}: two launches on the same "
                                     f"inputs differ")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
    return worst


def time_k2(shape, gen) -> dict:
    """K2 at one head shape (bf16) in both layouts: device ms of one
    launch, the plain version's, the bound and a two-call yardstick
    (``F.interpolate(..., mode="bilinear", align_corners=True)`` then
    ``F.conv2d`` on the NCHW input; the port never calls it)."""
    F = torch.nn.functional
    dtype = torch.bfloat16
    bms, by = head_bound(shape, dtype)
    out = {"shape": list(shape), "bound_ms": bms, "bound_by": by}
    for layout in HEAD_LAYOUTS:
        ops, kern, ref = head_case(shape, layout, dtype, gen)
        out[layout] = {"ms": graph_ms(lambda: kern(*ops), iters=20),
                       "plain_ms": graph_ms(lambda: ref(*ops), iters=5)}
        if layout == "nchw":
            ht, weight, bias = ops
            wt, bt = weight.to(dtype), bias.to(dtype)
            out["library_ms"] = graph_ms(lambda: F.conv2d(F.interpolate(
                ht, scale_factor=2, mode="bilinear", align_corners=True),
                wt, bt, padding=1), iters=20)
        log(f"  K2 {shape} {layout}: {out[layout]['ms']:.4f} ms (plain "
            f"{out[layout]['plain_ms']:.4f}, bound {bms:.4f} by {by}) "
            + head_plan_tag(shape, layout, dtype))
    log(f"  K2 {shape}: interpolate + conv2d (two calls, a yardstick) "
        f"{out['library_ms']:.4f} ms")
    return out


def bwd_inputs(geom, b, dtype, gen):
    """K1 operands plus the output cotangents dh, dc of one cell."""
    ops = cell_inputs(geom, b, dtype, gen)
    cot = [torch.randn(ops[0].shape, generator=gen, device="cuda").to(dtype)
           for _ in range(2)]
    return ops, cot


def tol_for(dtype, want, fp32_tol=FP32_TOL) -> float:
    """fp32: the stated tolerance; bf16: one bf16 ulp at the output's
    largest magnitude (both sides sum in fp32 in another order, then round
    once)."""
    if dtype == torch.float32:
        return fp32_tol
    return BF16_ULP * want.float().abs().max().item()


def cell_plan_tag(geom, b, dtype, kind="forward") -> str:
    """K1's, K4's or K8's launch plan (cell_plan's kind) at one geometry
    (H, W, C, Cx), for the check lines."""
    from rsis_tpu_torch.ops.fused_cell import cell_plan
    hh, ww, ch, cx = geom
    p = cell_plan(b, hh, ww, ch, cx, dtype, kind=kind)
    if not p.mma:
        return "(fma)"
    return (f"(mma, {16 * p.wm}x{8 * p.wj}x4 warp tile, {p.rows}x{p.tw} "
            f"unit, {p.block_c}-channel tile, {p.cc}-channel chunks, "
            f"{p.stages} stages, {p.splits} parts)")


def check_cell_kernels(geom, b, dtype, gen, label="") -> dict:
    """K1 and K4 against their plain versions at one geometry (fp32: 1e-4;
    bf16: one ulp of each output's max), each launched twice on the same
    inputs with bit-identical results. Returns the bf16 errors of each (0
    for fp32)."""
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    from rsis_tpu_torch.ops.fused_cell import (fused_cell_rowmajor,
                                               fused_cell_rowmajor_ref)
    hh, ww, ch, cx = geom
    kw = {"cx": cx, "ch": ch}
    tag = "fp32" if dtype == torch.float32 else "bf16"
    ops, (dh, dc) = bwd_inputs(geom, b, dtype, gen)
    errs = {"k1": 0.0, "k4": 0.0}
    for key, name, fn, ref, args, kind in (
            ("k1", "K1", fused_cell_rowmajor, fused_cell_rowmajor_ref, ops,
             "forward"),
            ("k4", "K4", fcv.cell_backward_dgates,
             fcv.cell_backward_dgates_ref, (*ops, dh, dc), "backward")):
        got = fn(*args, **kw)
        again = fn(*args, **kw)
        want = ref(*args, **kw)
        torch.cuda.synchronize()
        full = (f"{name} {label}{geom} B={b} {tag} "
                + cell_plan_tag(geom, b, dtype, kind))
        nms = ("h", "c") if key == "k1" else ("dg", "dc_prev")
        for nm, g_, a_, w_ in zip(nms, got, again, want):
            err = max_err(g_, w_)
            check(f"{full} {nm}", err, tol_for(dtype, w_))
            if not torch.equal(g_, a_):
                raise SystemExit(f"{full} {nm}: two launches on the same "
                                 f"inputs differ")
            if dtype == torch.bfloat16:
                errs[key] = max(errs[key], err)
    return errs


def check_backward_kernels(cell_geoms, b, gen, k3_batches=()) -> dict:
    """K4, K5 and K3 against their plain versions at the train step's
    shapes, fp32 and bf16 (K3 also at the five cells at k3_batches, whose
    launch plans differ). Returns the largest bf16 error of each."""
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    errs = {"k3": 0.0, "k4": 0.0, "k5": 0.0}
    # the five cells, then widths that are not multiples of 8 (FMA loops),
    # then K3 alone at the other batches
    geoms = [(g, b, True) for g in cell_geoms] + [((32, 64, 4, 12), 2, True)]
    geoms += [(g, bb, False) for bb in k3_batches if bb != b
              for g in cell_geoms]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for geom, bb, all_three in geoms:
            hh, ww, ch, cx = geom
            ops, (dh, dc) = bwd_inputs(geom, bb, dtype, gen)
            kw = {"cx": cx, "ch": ch}
            want = fcv.cell_backward_dgates_ref(*ops, dh, dc, **kw)
            dg = want[0]
            if all_three:
                got = fcv.cell_backward_dgates(*ops, dh, dc, **kw)
                again = fcv.cell_backward_dgates(*ops, dh, dc, **kw)
                torch.cuda.synchronize()
                name = f"K4 {geom} B={bb} {tag} " + cell_plan_tag(
                    geom, bb, dtype, kind="backward")
                for nm, g_, a_, w_ in zip(("dg", "dc_prev"), got, again,
                                          want):
                    err = max_err(g_, w_)
                    check(f"{name} {nm}", err, tol_for(dtype, w_))
                    if not torch.equal(g_, a_):
                        raise SystemExit(f"{name} {nm}: two launches on "
                                         f"the same inputs differ")
                    if dtype == torch.bfloat16:
                        errs["k4"] = max(errs["k4"], err)
                errs["k5"] = max(errs["k5"], check_k5(
                    ops[0], ops[1], dg, geom, bb, dtype))
            wpack = fcv.conv_transpose_weights(ops[4], cx, ch,
                                               "xh" if cx else "h")
            errs["k3"] = max(errs["k3"], check_k3(dg, wpack, geom, bb,
                                                  dtype))
        # K3 at the edges of its plan (K3_EDGE_GEOMS)
        for geom, bb in K3_EDGE_GEOMS:
            hh, ww, ch, cx = geom
            dg = torch.randn(bb, hh, 4 * ch, ww, generator=gen,
                             device="cuda").to(dtype)
            wpack = (torch.randn(cx + ch, 36 * ch, generator=gen,
                                 device="cuda") / (36 * ch) ** 0.5).to(dtype)
            errs["k3"] = max(errs["k3"], check_k3(dg, wpack, geom, bb,
                                                  dtype))
        # K5 at the edges of its plan: H and W not multiples of the unit's
        # rows and columns, W below one unit, B=1, Cx=0 and the narrowest
        # widths of the tensor-core loop, each of its four warp tiles
        for geom, bb in K5_EDGE_GEOMS:
            hh, ww, ch, cx = geom
            h_prev = torch.randn(bb, hh, ch, ww, generator=gen,
                                 device="cuda").to(dtype)
            x_pad = None
            if cx:
                x_pad = torch.nn.functional.pad(torch.randn(
                    bb, hh, cx, ww, generator=gen, device="cuda").to(dtype),
                    (1, 1, 0, 0, 1, 1))
            dg = torch.randn(bb, hh, 4 * ch, ww, generator=gen,
                             device="cuda").to(dtype)
            err = check_k5(h_prev, x_pad, dg, geom, bb, dtype)
            if dtype == torch.bfloat16:
                errs["k5"] = max(errs["k5"], err)
    return errs


def check_k5(h_prev, x_pad, dg, geom, b, dtype) -> float:
    """K5 against its plain version (fp32: 1e-4 of max|dwt|, a sum of up
    to 1M products; bf16: one ulp of the max), launched twice on the same
    inputs with bit-identical results. Returns the bf16 error (0 for
    fp32)."""
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    kw = {"cx": geom[3], "ch": geom[2]}
    got = fcv.weight_grad_rowmajor(h_prev, x_pad, dg, **kw)
    again = fcv.weight_grad_rowmajor(h_prev, x_pad, dg, **kw)
    want = fcv.weight_grad_ref(h_prev, x_pad, dg, **kw)
    torch.cuda.synchronize()
    plan = fcv.weight_grad_plan(b, geom[0], geom[1], geom[2], geom[3],
                                dtype)
    tag = "fp32" if dtype == torch.float32 else "bf16"
    name = f"K5 {geom} B={b} {tag} " + (
        f"(mma, {plan.block_m}x{plan.block_c} tile, {plan.rows}x{plan.tw} "
        f"unit, {plan.chunks} chunks)" if plan.mma else
        f"(fma, {plan.chunks} chunks)")
    err = max_err(got, want)
    scale = want.float().abs().max().item()
    check(name, err, tol_for(dtype, want, FP32_TOL * scale))
    if not torch.equal(got, again):
        raise SystemExit(f"{name}: two launches on the same inputs differ")
    return err if dtype == torch.bfloat16 else 0.0


def check_k3(dg, wpack, geom, b, dtype) -> float:
    """K3 against its plain version (fp32: 1e-4; bf16: one ulp of the
    output's max), launched twice on the same inputs with bit-identical
    results, and its pullback outputs (dx_pad with a zero ring, dh_prev)
    equal to the stacked output's slice and pad bit for bit. Returns the
    bf16 error (0 for fp32)."""
    from rsis_tpu_torch.ops import conv3x3 as k3
    hh, ww, ch, cx = geom
    kw = {"cin": 4 * ch, "cout": cx + ch}
    got = k3.conv3x3_rowmajor(dg, wpack, **kw)
    again = k3.conv3x3_rowmajor(dg, wpack, **kw)
    dx_pad, dh_prev = k3.conv3x3_pullback(dg, wpack, cx=cx, ch=ch)
    want = k3.conv3x3_rowmajor_ref(dg, wpack, **kw)
    torch.cuda.synchronize()
    plan = k3.conv3x3_plan(b, hh, ww, 4 * ch, cx + ch, dtype)
    tag = "fp32" if dtype == torch.float32 else "bf16"
    name = f"K3 {geom} B={b} {tag} " + (
        f"(mma, {16 * plan.wm}x{8 * plan.wn} warp tile, {plan.rows}x"
        f"{plan.tw} unit, {plan.cc}-channel chunks, {plan.splits} parts)"
        if plan.mma else "(fma)")
    err = max_err(got, want)
    check(name, err, tol_for(dtype, want))
    if not torch.equal(got, again):
        raise SystemExit(f"{name}: two launches on the same inputs differ")
    split_ok = torch.equal(dh_prev, got[:, :, cx:])
    if cx:
        ring = dx_pad.clone()
        ring[:, 1:-1, :, 1:-1] = 0
        split_ok = (split_ok and not ring.any().item() and torch.equal(
            dx_pad[:, 1:-1, :, 1:-1], got[:, :, :cx]))
    if not split_ok:
        raise SystemExit(f"{name}: the pullback's dx_pad / dh_prev differ "
                         f"from the stacked output's slice and pad")
    return err if dtype == torch.bfloat16 else 0.0


def lap_cases(gen, b=32, shapes=((5, 20), (20, 20))):
    """(name, costs (B, nr, nc)) at the train step's matcher shapes:
    random costs and tie-heavy ones, where the invalid (prediction, GT)
    pairs cost exactly 10.0 as in the loss; each contiguous, then as the
    transposed view of a (B, nc, nr) tensor, as the matcher passes it."""
    cases = []
    for nr, nc in shapes:
        rnd = torch.rand(b, nr, nc, generator=gen, device="cuda")
        cases.append((f"random ({b}, {nr}, {nc})", rnd))
        valid_n = torch.randint(1, nc + 1, (b, 1), generator=gen,
                                device="cuda")
        sw = (torch.arange(nc, device="cuda")[None] < valid_n).float()
        valid = sw[:, :nr, None] * sw[:, None, :]
        coarse = torch.floor(rnd * 4) / 4    # ties among valid pairs too
        cases.append((f"ties ({b}, {nr}, {nc})",
                      (coarse * valid + (1 - valid) * 10.0).contiguous()))
    return cases + [(f"{name} transposed",
                     c.transpose(1, 2).contiguous().transpose(1, 2))
                    for name, c in cases]


def assignment_cost(costs, row4col) -> torch.Tensor:
    """Total cost of each problem's assignment, checking that it assigns
    every row to exactly one column."""
    b, nr, nc = costs.shape
    r4c = row4col.long()
    taken = r4c >= 0
    if not torch.equal(taken.sum(1), torch.full((b,), nr, device=r4c.device)):
        raise SystemExit("K6: an assignment leaves rows unassigned")
    rows = torch.where(taken, r4c, torch.zeros_like(r4c))
    hits = torch.zeros(b, nr, dtype=torch.long, device=r4c.device)
    hits.scatter_add_(1, rows, taken.long())
    if not torch.equal(hits, torch.ones_like(hits)):
        raise SystemExit("K6: a row is assigned to several columns")
    picked = torch.gather(costs, 1, rows[:, None, :])[:, 0]
    return (picked * taken).sum(1)


def lap_edge_cases(gen):
    """(name, costs) at K6_EDGE_SHAPES: random, tie-heavy (quarters),
    all-equal and negative costs (a third of them -0.0), each contiguous
    and as the transposed view of a (B, nc, nr) tensor, as the matcher
    passes it."""
    cases = []
    for b, nr, nc in K6_EDGE_SHAPES:
        rnd = torch.rand(b, nr, nc, generator=gen, device="cuda")
        neg = rnd - 0.5
        neg[:, :, ::3] = -0.0
        for kind, c in (("random", rnd), ("ties", torch.floor(rnd * 4) / 4),
                        ("all-equal", torch.full_like(rnd, 0.25)),
                        ("negative", neg)):
            cases.append((f"{kind} ({b}, {nr}, {nc})", c.contiguous()))
            cases.append((f"{kind} ({b}, {nr}, {nc}) transposed",
                          c.transpose(1, 2).contiguous().transpose(1, 2)))
    return cases


def check_lap(gen) -> float:
    """K6 against its plain version on lap_cases and lap_edge_cases:
    row4col identical to the plain version's (which also makes the total
    cost equal), valid assignments, and two launches identical. Returns
    the largest total-cost difference (0 where row4col agrees)."""
    from rsis_tpu_torch.ops.lap import solve_lap_batch, solve_lap_batch_ref
    worst = 0.0
    edge = lap_edge_cases(gen)
    edge_names = {name for name, _ in edge}
    for name, costs in lap_cases(gen) + edge:
        r4c = solve_lap_batch(costs)
        again = solve_lap_batch(costs)
        want = solve_lap_batch_ref(costs)
        torch.cuda.synchronize()
        err = (assignment_cost(costs, r4c)
               - assignment_cost(costs, want)).abs().max().item()
        worst = max(worst, err)
        differ = (r4c != want).sum().item()
        if differ or not torch.equal(r4c, again):
            raise SystemExit(f"K6 {name}: row4col differs from the plain "
                             f"version's in {differ} entries (or between "
                             f"two launches)")
        if name in edge_names:
            continue
        log(f"  K6 {name}: row4col identical to the plain version "
            f"(total cost difference {err:.3e}), two launches identical")
    log(f"  K6 edge shapes {K6_EDGE_SHAPES}, random, ties, all-equal and "
        f"negative costs, contiguous and transposed ({len(edge)} cases): "
        f"row4col identical to the plain version, launches identical")
    return worst


def check_cell_backward(cell_geoms, b, gen) -> float:
    """FusedCellFunction's whole backward (K4, K5, K3) against autograd
    through the plain cell, all five cotangents (the up-input's through its
    zero-ring pad, as the decoder builds it), in fp32 and in bf16, where
    the kernels take their tensor-core loops. Returns the largest bf16
    error in bf16 ulps at the cotangent's largest magnitude."""
    from rsis_tpu_torch.ops.fused_cell import fused_cell_rowmajor_ref
    from rsis_tpu_torch.ops.fused_cell_vjp import FusedCellFunction
    F = torch.nn.functional
    worst = 0.0
    for geom, dtype in [(g, d) for d in (torch.float32, torch.bfloat16)
                        for g in cell_geoms]:
        hh, ww, ch, cx = geom
        tag = "fp32" if dtype == torch.float32 else "bf16"
        ops, (gh, gc) = bwd_inputs(geom, b, dtype, gen)
        h_prev, x_pad, c_prev, s_term, wt = ops
        x = x_pad[:, 1:-1, :, 1:-1].contiguous() if cx else None
        grads = []
        for fn in (lambda *a: FusedCellFunction.apply(*a, cx, ch),
                   lambda *a: fused_cell_rowmajor_ref(*a, cx=cx, ch=ch)):
            leaves = [t.detach().requires_grad_() if t is not None else None
                      for t in (h_prev, x, c_prev, s_term, wt)]
            xp = (F.pad(leaves[1], (1, 1, 0, 0, 1, 1)) if cx else None)
            h, c = fn(leaves[0], xp, leaves[2], leaves[3], leaves[4])
            torch.autograd.backward((h, c), (gh, gc))
            grads.append([t.grad for t in leaves if t is not None])
        names = [n for n, t in zip(("h_prev", "x", "c_prev", "s", "wt"),
                                   (h_prev, x, c_prev, s_term, wt))
                 if t is not None]
        torch.cuda.synchronize()
        for nm, got, want in zip(names, *grads):
            err = max_err(got, want)
            if dtype == torch.float32:
                tol = FP32_TOL * max(1.0, want.abs().max().item())
            else:
                # the kernels round dg to bf16 before K5 and K3 read it,
                # autograd through the plain cell keeps it in fp32; both
                # round the cotangent once
                ulp = BF16_ULP * want.float().abs().max().item()
                tol = CELL_BWD_BF16_ULPS * ulp
                worst = max(worst, err / ulp)
            check(f"cell backward {geom} {tag} d{nm}", err, tol)
    return worst


def train_config(b: int, T: int, dtype: str = "bfloat16"):
    from rsis_tpu_torch import Config
    return Config(base_model="resnet101", hidden_size=128, num_classes=9,
                  skip_mode="concat", maxseqlen=T, compute_dtype=dtype,
                  imsize=TRAIN_HW[0], gt_maxseqlen=20, batch_size=b,
                  augment=True)


def cuda_generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def warp_cases(b: int, gen):
    """(name, image, ids, matrices, flip) of K7's checks at the train
    geometry: fp32 and bf16 images with a uint8 id plane, random flips and
    matrices at the bench's ranges, the identity, and a strong translation
    whose rows and columns clamp at the borders."""
    from rsis_tpu_torch.data.device_aug import sample_affine_matrices
    hh, ww = TRAIN_HW
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        img = torch.randn(b, hh, ww, 3, generator=gen, device="cuda").to(dtype)
        ids = torch.randint(0, 21, (b, hh, ww), generator=gen, device="cuda",
                            dtype=torch.uint8)
        flip = torch.rand(b, generator=gen, device="cuda") < 0.5
        bench = sample_affine_matrices(gen, b, hh, ww, *WARP_RANGES)
        strong = sample_affine_matrices(gen, b, hh, ww, 15.0, 0.4, 5.0,
                                        (0.8, 1.2))
        eye = torch.eye(3, device="cuda").expand(b, 3, 3).contiguous()
        for name, ms, fl in (("bench ranges", bench, flip),
                             ("identity", eye, None),
                             ("strong translation", strong, flip)):
            cases.append((f"{name} B={b} {tag}", img, ids, ms, fl))
    return cases


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts one element past an
    aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def warp_edge_cases(gen):
    """(name, image, ids, matrices, flip) of K7 at K7_EDGE_GEOMS in fp32
    and bf16: random flips, matrices with a strong translation (clamping
    at the borders); at C = 2 and 4 also the image and the ids at a
    misaligned address."""
    from rsis_tpu_torch.data.device_aug import sample_affine_matrices
    cases = []
    for b, h, w, c in K7_EDGE_GEOMS:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"({b}, {h}, {w}, {c}) {str(dtype)[6:]}"
            img = torch.randn(b, h, w, c, generator=gen,
                              device="cuda").to(dtype)
            ids = torch.randint(0, 21, (b, h, w), generator=gen,
                                device="cuda", dtype=torch.uint8)
            ms = sample_affine_matrices(gen, b, h, w, 15.0, 0.4, 5.0,
                                        (0.8, 1.2))
            flip = torch.rand(b, generator=gen, device="cuda") < 0.5
            cases.append((tag, img, ids, ms, flip))
            if c in (2, 4):
                cases.append((f"{tag} misaligned", misaligned(img),
                              misaligned(ids), ms, flip))
    return cases


def check_warp_edges(gen) -> float:
    """K7 at K7_EDGE_GEOMS: bit-identical to its plain version, and two
    launches identical. Returns the largest difference (0)."""
    from rsis_tpu_torch.ops.warp import (address_alignment, affine_warp_ref,
                                         warp_by_coefficients,
                                         warp_coefficients, warp_plan)
    worst = 0.0
    for name, img, ids, ms, fl in warp_edge_cases(gen):
        coef = warp_coefficients(img, ms, fl)
        got = warp_by_coefficients(img, ids, coef)
        again = warp_by_coefficients(img, ids, coef)
        want = affine_warp_ref(img, ids, coef)
        torch.cuda.synchronize()
        err = max(max_err(g, w) for g, w in zip(got, want))
        worst = max(worst, err)
        plan = warp_plan(img.shape[2], img.shape[3], img.element_size(),
                         address_alignment(img))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        log(f"  K7 edge {name} (plan {plan}): "
            f"{'bit-identical' if equal else 'DIFFERS'}, launches "
            f"{'identical' if same else 'DIFFER'}")
        if not (equal and same):
            raise SystemExit(f"K7 edge {name}: kernel differs from its "
                             f"plain version or between two launches")
    return worst


def check_warp(batches, gen) -> float:
    """K7 against its plain version: bit-identical outputs in every case
    (both read the same coefficients), at the train geometry and at
    K7_EDGE_GEOMS. Returns the largest difference."""
    from rsis_tpu_torch.ops.warp import (affine_warp, nearest_index_maps,
                                         warp_coefficients)
    worst = check_warp_edges(gen)
    for b in batches:
        for name, img, ids, ms, fl in warp_cases(b, gen):
            got = affine_warp(img, ids, ms, fl)
            again = affine_warp(img, ids, ms, fl)
            want = affine_warp(img, ids, ms, fl, plain=True)
            torch.cuda.synchronize()
            err = max(max_err(g, w) for g, w in zip(got, want))
            worst = max(worst, err)
            equal = all(torch.equal(g, w) and torch.equal(g, a)
                        for g, w, a in zip(got, want, again))
            if name.startswith("identity"):
                equal = equal and torch.equal(got[0], img) and torch.equal(
                    got[1], ids)
            idx = nearest_index_maps(warp_coefficients(img, ms, fl),
                                     *TRAIN_HW)
            rows, cols = idx // TRAIN_HW[1], idx % TRAIN_HW[1]
            edge = ((rows == 0) | (rows == TRAIN_HW[0] - 1) | (cols == 0)
                    | (cols == TRAIN_HW[1] - 1)).float().mean().item()
            log(f"  K7 {name}: {'bit-identical' if equal else 'DIFFERS'}"
                f"{', launches identical' if equal else ''} "
                f"(max_abs_err {err:.3e}; {edge:.3f} of the pixels read "
                f"the border)")
            if not equal:
                raise SystemExit(f"K7 {name}: kernel differs from its plain "
                                 f"version")
    return worst


def time_warp(b: int, gen) -> dict:
    """K7 at the train geometry (bf16 image, uint8 ids, bench ranges):
    device ms of one launch against the plain version, the byte bound and
    the library row: torch.gather of the image and of the id plane over a
    precomputed index map (two calls; the index math is left out). Also
    the whole augmentation block (id collapse, coefficients, K7, mask
    expansion) on gt_maxseqlen 20 masks."""
    from rsis_tpu_torch.data.device_aug import augment_wire_batch_with
    from rsis_tpu_torch.ops.warp import (affine_warp_ref, nearest_index_maps,
                                         warp_by_coefficients,
                                         warp_coefficients)
    name, img, ids, ms, fl = [c for c in warp_cases(b, gen)
                              if c[0].startswith("bench") and "bf16" in c[0]
                              ][0]
    hh, ww = TRAIN_HW
    coef = warp_coefficients(img, ms, fl)
    ms_k = graph_ms(lambda: warp_by_coefficients(img, ids, coef), iters=20)
    pms = graph_ms(lambda: affine_warp_ref(img, ids, coef), iters=5)
    idx = nearest_index_maps(coef, hh, ww)
    idx3 = idx[:, :, None].expand(b, hh * ww, 3)
    img_flat, ids_flat = img.reshape(b, hh * ww, 3), ids.reshape(b, hh * ww)
    lms = graph_ms(lambda: (torch.gather(img_flat, 1, idx3),
                            torch.gather(ids_flat, 1, idx)), iters=20)
    # each input read once, each output written once; ~10 fp32 operations
    # of index math per pixel
    bms, by = bound_ms(2 * nbytes(img, ids) + nbytes(coef),
                       10.0 * b * hh * ww, torch.float32)
    y_mask = (torch.randint(0, 21, (b, 1, hh * ww), generator=gen,
                            device="cuda") == torch.arange(
                                1, 21, device="cuda")[None, :, None]
              ).to(torch.uint8)
    block_ms = graph_ms(lambda: augment_wire_batch_with(img, y_mask, ms, fl),
                        iters=5)
    block_bytes = 2 * nbytes(img, y_mask)
    log(f"  K7 warp {name}: {ms_k:.4f} ms (plain {pms:.4f}, library "
        f"torch.gather x2 {lms:.4f} without the index math, bound "
        f"{bms:.4f} by {by}); augmentation block {block_ms:.4f} ms "
        f"(bound {block_bytes / HBM_BYTES_PER_S * 1e3:.4f} by bytes)")
    return {"ms": ms_k, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
            "bound_by": by, "block_ms": block_ms,
            "block_bound_ms": block_bytes / HBM_BYTES_PER_S * 1e3}


def kernel_counters() -> dict:
    """Each kernel wrapper of the train step (its launch count lives on the
    function)."""
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    from rsis_tpu_torch.ops.conv3x3 import conv3x3_rowmajor
    from rsis_tpu_torch.ops.fused_cell import fused_cell_rowmajor
    from rsis_tpu_torch.ops.lap import solve_lap_batch
    from rsis_tpu_torch.ops.mask_head import mask_head_fused_kernel
    from rsis_tpu_torch.ops.warp import warp_by_coefficients
    return {"fused_cell_rowmajor": fused_cell_rowmajor,
            "mask_head_fused_kernel": mask_head_fused_kernel,
            "conv3x3_rowmajor": conv3x3_rowmajor,
            "cell_backward_dgates": fcv.cell_backward_dgates,
            "weight_grad_rowmajor": fcv.weight_grad_rowmajor,
            "solve_lap_batch": solve_lap_batch,
            "warp_by_coefficients": warp_by_coefficients}


def train_phase(args, out_dir) -> dict:
    """Phase 4: the full-width train step with device augmentation
    through the kernels, timed, its launches counted, its loss falling,
    one step held against the plain path on the card, and one step with
    the three dropouts."""
    import numpy as np
    from rsis_tpu_torch.data.synthetic import synthetic_wire_batch
    from rsis_tpu_torch.models.rsis import build_models
    from rsis_tpu_torch.train import step as ts

    b, T = args.train_batch, args.train_steps
    hh, ww = TRAIN_HW
    cfg = train_config(b, T)
    torch.manual_seed(args.seed)
    enc, dec = build_models(cfg)
    weights = (enc.state_dict(), dec.state_dict())
    del enc, dec
    img, tgt = synthetic_wire_batch(np.random.default_rng(args.seed), b, hh,
                                    ww, cfg.gt_maxseqlen, cfg.num_classes)
    batch = (torch.from_numpy(img).cuda(), torch.from_numpy(tgt).cuda())
    flags = ts.StepFlags(use_class_loss=1.0, use_stop_loss=1.0,
                         update_encoder=1.0)
    remat = ts._resolve_remat(cfg, T)
    train_step, _ = ts.make_train_step(cfg, T=T, remat=remat)
    state = ts.create_train_state(cfg, weights)
    gen = cuda_generator(args.seed)
    t0 = time.perf_counter()
    state, metrics = train_step(state, batch, flags, gen)
    loss0 = metrics[0].item()
    log(f"train step warm-up: {time.perf_counter() - t0:.2f} s, loss "
        f"{loss0:.5f}")

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_ITERS):
        state, metrics = train_step(state, batch, flags, gen)
        losses.append(metrics[0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_ITERS * 1e3
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = [loss0] + [x.item() for x in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    img_s = b / (step_ms / 1e3)
    log(f"train path: {TRAIN_ITERS} steps of B={b} at {hh}x{ww}, "
        f"T={T}, bf16, remat {remat}, device augmentation: {step_ms:.3f} "
        f"ms/step "
        f"= {img_s:.2f} img/s (host clock around synchronised steps); peak "
        f"{peak_gb:.2f} GB; losses {[round(x, 5) for x in losses]}; "
        f"launches {launches}")
    n, rep = TRAIN_ITERS, 2 if remat else 1
    want = {"fused_cell_rowmajor": 5 * T * rep * n,
            "mask_head_fused_kernel": T * rep * n,
            "conv3x3_rowmajor": 5 * T * n, "cell_backward_dgates": 5 * T * n,
            "weight_grad_rowmajor": 5 * T * n, "solve_lap_batch": n,
            "warp_by_coefficients": n}
    if launches != want:
        raise SystemExit(f"train launch counts {launches} != expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"the train loss does not fall: {losses}")
    profile = None
    if args.profile:
        profile = profile_call(lambda: train_step(state, batch, flags, gen),
                               out_dir, "train_step")
    del state

    # one step with the three dropouts: the plain decoder under autograd,
    # its dropouts drawing from the CUDA generator after the augmentation
    cfg_drop = cfg.replace(dropout=0.2, dropout_cls=0.2, dropout_stop=0.2)
    step_drop, _ = ts.make_train_step(cfg_drop, T=T, remat=remat)
    state = ts.create_train_state(cfg_drop, weights)
    t0 = time.perf_counter()
    _, m_drop = step_drop(state, batch, flags, cuda_generator(args.seed))
    drop_loss = m_drop[0].item()
    log(f"dropout step (0.2 each, plain decoder): loss {drop_loss:.5f} in "
        f"{time.perf_counter() - t0:.2f} s")
    if not np.isfinite(drop_loss):
        raise SystemExit(f"the dropout step's loss is {drop_loss}")
    del state

    # the same weights and batch through the plain path on the card; both
    # draw the same flips and matrices from generators of one seed
    def loss_grads(cfg_, batch_, T_, plain):
        st = ts.create_train_state(cfg_, weights)
        total, _, grads = ts.loss_and_grads(
            cfg_, st, batch_, flags, T_, plain=plain,
            rng=cuda_generator(args.seed + 1))
        return total.item(), grads

    def check_grads(tag, rows, limits):
        """Every gradient tensor (step_grad_rows) by step_grad_verdict at
        limits[group]; returns each group's worst held distance over its
        limit and its tensor."""
        worst = dict.fromkeys(limits, (0.0, None))
        held = dict.fromkeys(limits, 0)
        for k, row in rows.items():
            ok, dist, lim, against = step_grad_verdict(
                row, limits[row["group"]])
            worst[row["group"]] = max(worst[row["group"]], (dist / lim, k))
            held[row["group"]] += against == "fp32"
            if not ok:
                raise SystemExit(
                    f"train step {tag} gradient {k}: {dist:.3f} units "
                    f"against {against} (limit {lim:.3f}; kernel-plain "
                    f"{row['kp']:.3f}, plain-fp32 {row['pf']}, "
                    f"kernel-fp32 {row['kf']})")
        log(f"  train step {tag} gradients: {len(rows)} tensors ok; worst "
            f"share of its limit: " + ", ".join(
                f"{g} {w:.3f} at {at} ({held[g]} held against fp32)"
                for g, (w, at) in worst.items()))
        return worst

    # bf16: the forwards agree to a few bf16 ulps of each mask logit, and
    # the loss is an fp32 mean over all of them, so it moves far less than
    # one bf16 ulp of itself (2^-8..2^-7 relative). The gradients: both
    # paths round every cotangent between cells and steps to bf16, but the
    # kernels also round dg before K5 and K3 read it, and the recurrence
    # carries such differences back through T steps and the encoder; the
    # fp32 plain path at this geometry is the truth both are held to
    got, g_k = loss_grads(cfg, batch, T, False)
    want_loss, g_p = loss_grads(cfg, batch, T, True)
    _, g_f = loss_grads(cfg.replace(compute_dtype="float32"), batch, T, True)
    bf16_rel = abs(got - want_loss) / abs(want_loss)
    check("train step bf16 loss vs plain path (relative)", bf16_rel,
          STEP_LOSS_BF16_REL)
    rows = step_grad_rows(g_k, g_p, g_f)
    bf16_grad = check_grads("bf16", rows, STEP_GRAD_BF16_ULPS)
    del g_k, g_p, g_f
    # float32 at T=2 on two images: the kernels' arithmetic is the plain
    # path's, so the loss agrees to 1e-4 relative and every gradient to
    # 1e-3 of its largest magnitude
    cfg32 = train_config(2, 2, "float32")
    batch32 = tuple(t[:2] for t in batch)
    got, g_k = loss_grads(cfg32, batch32, 2, False)
    want_loss, g_p = loss_grads(cfg32, batch32, 2, True)
    check("train step fp32 T=2 loss vs plain path (relative)",
          abs(got - want_loss) / abs(want_loss), 1e-4)
    check_grads("fp32 T=2", step_grad_rows(g_k, g_p, ulp=1e-3),
                {"backbone": 1, "decoder": 1})
    return {"batch": b, "steps": T, "iters": n, "remat": remat,
            "ms_per_step": step_ms, "images_per_s": img_s, "peak_gb": peak_gb,
            "losses": losses, "launches": launches,
            "bf16_loss_rel_err": bf16_rel,
            "bf16_grad_worst_share": bf16_grad, "bf16_grad_rows": rows,
            "dropout_step_loss": drop_loss,
            "profile": profile}


def trainer_phase(args, out_dir) -> dict:
    """Phase 4b: ``python -m rsis_tpu_torch.cli.train`` at full width on
    the synthetic dataset, 2 epochs, then resumed; checks the log, the
    checkpoint and the metrics, and times the loop against its step."""
    import shutil
    import tempfile
    import numpy as np
    from rsis_tpu_torch.cli.train import main as train_main
    from rsis_tpu_torch.config import Config
    from rsis_tpu_torch.train import step as ts
    from rsis_tpu_torch.train.loop import init_dataloaders
    from rsis_tpu_torch.ops.warp import warp_by_coefficients

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_models_",
                            dir=os.path.join(here, "build"))
    b = 8
    argv = ["-dataset", "synthetic", "-base_model", "resnet101",
            "-hidden_size", "128", "-num_classes", "9",
            "-compute_dtype", "bfloat16", "-imsize", "256",
            "-batch_size", str(b), "-synthetic_length", "16",
            "--augment", "--curriculum_learning", "-max_epoch", "2",
            "-print_every", "1", "-seed", str(args.seed),
            "-models_root", root, "-model_name", "smoke"]
    d = os.path.join(root, "smoke")

    def read(name):
        with open(os.path.join(d, name)) as fp:
            return fp.read()

    def headers(text):
        return [int(ln.split()[1]) for ln in text.splitlines()
                if ln.startswith("Epoch ") and ":" not in ln]

    try:
        t0 = time.perf_counter()
        train_main(argv)
        first_s = time.perf_counter() - t0
        log1 = read("train.log")
        files = ["encoder.pt", "decoder.pt", "optim.pt", "args.json"]
        missing = [f for f in files if not os.path.exists(
            os.path.join(d, f))]
        if headers(log1) != [0, 1] or "Saving checkpoint." not in log1 \
                or log1.count("(val)") != 2 or missing:
            raise SystemExit(f"trainer: epochs {headers(log1)}, missing "
                             f"files {missing}; log:\n{log1[-2000:]}")
        first_recs = [json.loads(ln) for ln in
                      read("metrics.jsonl").splitlines()]
        n_metrics = len(first_recs)
        saved = Config.load(os.path.join(d, "args.json"))

        warp_by_coefficients.launches = 0
        t0 = time.perf_counter()
        state = train_main(argv + ["--resume"])
        resume_s = time.perf_counter() - t0
        launches = warp_by_coefficients.launches
        log2 = read("train.log")[len(log1):]
        records = [json.loads(ln) for ln in
                   read("metrics.jsonl").splitlines()[n_metrics:]]
        train_recs = [r for r in records if r["split"] == "train"]
        resumed = headers(log2)
        # the saved config (2 epochs) takes precedence; the run restarts
        # at the checkpointed epoch, as the reference's epoch_resume does
        want = [saved.epoch_resume + e for e in range(saved.max_epoch)]
        if resumed != want or not train_recs or launches != len(train_recs):
            raise SystemExit(f"resumed trainer: epochs {resumed} (want "
                             f"{want}), {len(train_recs)} train records, "
                             f"{launches} K7 launches; log:\n{log2[-2000:]}")
        # the loop's time per train step: consecutive train batches of an
        # epoch in both runs, data loading and logging included
        gaps = [b2["t"] - b1["t"]
                for recs in (first_recs, records)
                for b1, b2 in zip(recs, recs[1:])
                if b1["split"] == b2["split"] == "train"
                and b1["epoch"] == b2["epoch"]]
        loop_ms = 1e3 * sum(gaps) / len(gaps)
        # over the whole resumed call: model build, data, checkpoints
        run_img_s = b * len(records) / resume_s
        # the step alone on one of the loop's batches, at the loop's T
        cfg = Config.load(os.path.join(d, "args.json"))
        T = min(cfg.maxseqlen, cfg.limit_seqlen_to)
        loaders = init_dataloaders(cfg)
        batch = [torch.from_numpy(a).cuda() for a in next(iter(
            loaders["train"]))]
        step, _ = ts.make_train_step(cfg, T=T)
        flags = ts.StepFlags.from_config(cfg)
        gen = cuda_generator(args.seed)
        state, _ = step(state, batch, flags, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            state, metrics = step(state, batch, flags, gen)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TRAIN_ITERS * 1e3
        log(f"trainer: 2 epochs in {first_s:.2f} s, resumed at epoch "
            f"{resumed[0]} for epochs {resumed} in {resume_s:.2f} s "
            f"({len(records)} batches of {b} at 256x256, T={T}, bf16, "
            f"augmentation on; {launches} K7 launches); loop "
            f"{loop_ms:.3f} ms per train step = {b / loop_ms * 1e3:.2f} "
            f"img/s (data loading included, {len(gaps)} gaps); "
            f"{run_img_s:.2f} img/s over the whole resumed call (model "
            f"build, data, val and checkpoints included); the step alone "
            f"{step_ms:.3f} ms = {b / step_ms * 1e3:.2f} img/s")
        del state
        profile = None
        if args.profile:
            # no trace file: seconds of host work make it too large
            profile = profile_call(lambda: train_main(argv + ["--resume"]),
                                   None, "trainer_resume")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not np.isfinite(loop_ms):
        raise SystemExit("trainer: no loop time")
    return {"first_run_s": first_s, "resume_s": resume_s,
            "resumed_epochs": resumed, "batches": len(records), "T": T,
            "k7_launches": launches, "loop_ms_per_train_step": loop_ms,
            "loop_images_per_s": b / loop_ms * 1e3,
            "resumed_call_images_per_s": run_img_s, "step_ms": step_ms,
            "step_images_per_s": b / step_ms * 1e3, "profile": profile}


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_captured(fn, argv):
    """fn(argv) with its standard output captured and echoed; returns
    (result, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    return res, text


def conv_weights_equal(enc_sd, source, prefix: str) -> int:
    """Raise unless every 4-d weight of ``source`` equals the encoder's
    ``prefix + key`` bit for bit; returns how many were compared."""
    n = 0
    for k, v in source.items():
        if v.dim() == 4 and k.endswith("weight"):
            if not torch.equal(enc_sd[prefix + k].cpu(), v.cpu()):
                raise SystemExit(f"trainer options: {prefix}{k} moved")
            n += 1
    return n


def options_phase(args, models, card) -> dict:
    """Phase 4c: the trainer's options and the tools beside them at full
    width (resnet101, hidden 128, bf16), each check fatal:

    1. a torchvision-layout resnet101 backbone file under build/ (the
       port's trunk under torch.manual_seed(--seed), plus torchvision's
       ``fc.*``);
    2. ``cli.train`` on the synthetic dataset (256x256, batch 8, 16 images
       a split, 2 epochs, curriculum) with ``-finetune_after -1`` (the
       encoder frozen), ``--augment --host_augment``, ``-torch_encoder``
       the file and ``--visdom -port`` a free loopback port: the
       ``Encoder initialized from`` line, K7 never launched and the train
       step's other kernels launched, encoder.pt's backbone convolutions
       equal to the file's bit for bit, one mask snapshot an epoch of the
       grid's size, the dashboard's /metrics equal to metrics.jsonl and
       its /snapshots listing both, ``parse_train_log`` one value an epoch
       and split;
    3. ``cli.train --transfer -transfer_from`` that run on a CVPPP A1 tree
       from --seed (104 plants: 96 train, 8 val; 2 classes, 1 epoch,
       encoder frozen): ``fc_class`` with 2 outputs, the backbone's
       convolutions still the file's;
    4. one train step of that run's configuration under
       ``utils.profiling.trace``: its kernel table, K1's and K4's kernels
       among the device rows;
    5. ``cli.verify_parity --device`` on the eval phase's concat and mul
       checkpoints (2 images, 512x1024, T=20, float32): the deltas, rc 0
       (mean mask-IoU delta within 1e-3), and K1 and K2 (concat) or K8
       and K2 (mul) launched as a forward launches them."""
    import re
    import shutil
    import tempfile
    import urllib.request
    from rsis_tpu_torch.cli import verify_parity
    from rsis_tpu_torch.cli.train import main as train_main
    from rsis_tpu_torch.config import Config
    from rsis_tpu_torch.models.backbones import resnet101
    from rsis_tpu_torch.train import step as ts
    from rsis_tpu_torch.train.checkpoint import load_weights
    from rsis_tpu_torch.train.loop import init_dataloaders
    from rsis_tpu_torch.utils import profiling
    from rsis_tpu_torch.utils.monitor import snapshot_size
    from rsis_tpu_torch.utils.plot_curves import parse_train_log
    import numpy as np
    from PIL import Image

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_options_",
                            dir=os.path.join(here, "build"))
    walls = {}
    try:
        # 1. the backbone file
        t0 = time.perf_counter()
        torch.manual_seed(args.seed)
        backbone = dict(resnet101().state_dict())
        backbone["fc.weight"] = torch.randn(1000, 2048) * 0.01
        backbone["fc.bias"] = torch.zeros(1000)
        path = os.path.join(root, "resnet101_backbone.pth")
        torch.save(backbone, path)
        walls["backbone_file_s"] = time.perf_counter() - t0

        # 2. training from it, host augmentation, snapshots, dashboard
        port = free_port()
        mroot = os.path.join(root, "models")
        common = ["-base_model", "resnet101", "-hidden_size", "128",
                  "-compute_dtype", "bfloat16", "-imsize", "256",
                  "-batch_size", "8", "-print_every", "1", "-seed",
                  str(args.seed), "-finetune_after", "-1",
                  "--curriculum_learning", "-models_root", mroot]
        argv = common + ["-dataset", "synthetic", "-num_classes", "9",
                         "-synthetic_length", "16", "-max_epoch", "2",
                         "--augment", "--host_augment", "-torch_encoder",
                         path, "--visdom", "-port", str(port),
                         "-model_name", "opts"]
        d = os.path.join(mroot, "opts")
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        _, out = run_captured(train_main, argv)
        walls["train_s"] = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        if f"Encoder initialized from {path}" not in out:
            raise SystemExit("trainer options: no 'Encoder initialized "
                             "from' line")
        if launches["warp_by_coefficients"] != 0 or not all(
                n > 0 for k, n in launches.items()
                if k != "warp_by_coefficients"):
            raise SystemExit(f"trainer options: launches {launches} (want "
                             f"K7 0, every other kernel of the step > 0)")
        enc = torch.load(os.path.join(d, "encoder.pt"), map_location="cpu")
        n_conv = conv_weights_equal(enc, backbone, "base.")
        with open(os.path.join(d, "metrics.jsonl")) as fp:
            records = [json.loads(ln) for ln in fp]
        snaps = []
        for epoch in (0, 1):
            T = {r["T"] for r in records if r["epoch"] == epoch}
            name = f"masks_epoch{epoch:04d}.png"
            with Image.open(os.path.join(d, name)) as im:
                im.load()
                size = im.size
            if len(T) != 1 or size != snapshot_size(T.pop(), 256, 256):
                raise SystemExit(f"trainer options: {name} is {size}")
            snaps.append(name)
        base = f"http://127.0.0.1:{port}"
        served = json.loads(urllib.request.urlopen(base + "/metrics",
                                                   timeout=30).read())
        listed = json.loads(urllib.request.urlopen(base + "/snapshots",
                                                   timeout=30).read())
        if served != records or listed != snaps:
            raise SystemExit(f"dashboard: {len(served)} records (want "
                             f"{len(records)}), snapshots {listed}")
        curves = parse_train_log(os.path.join(d, "train.log"))
        counts = {f"{s}/{k}": len(v) for s in ("train", "val")
                  for k, v in curves[s].items()}
        if sorted(counts.values()) != [2] * 8:
            raise SystemExit(f"parse_train_log: values {counts}")
        log(f"options: trained 2 epochs from {os.path.basename(path)} in "
            f"{walls['train_s']:.2f} s (host augmentation, snapshots, "
            f"dashboard on port {port}); launches {launches}; {n_conv} "
            f"backbone convolutions equal to the file's; snapshots {snaps} "
            f"{size}; dashboard served {len(served)} records")

        # 3. transfer onto CVPPP leaves
        t0 = time.perf_counter()
        leaves = write_leaves(root, np.random.default_rng(args.seed), n=104)
        walls["leaves_tree_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_captured(train_main, common + [
            "-dataset", "leaves", "-leaves_dir", leaves, "-num_classes", "2",
            "-max_epoch", "1", "--transfer", "-transfer_from", "opts",
            "-model_name", "leaves_transfer"])
        walls["transfer_s"] = time.perf_counter() - t0
        enc_t, dec_t = load_weights(Config(models_root=mroot),
                                    "leaves_transfer")
        n_out = dec_t["fc_class.weight"].shape[0]
        if n_out != 2 or dec_t["fc_class.bias"].shape != (2,):
            raise SystemExit(f"transfer: fc_class has {n_out} outputs")
        conv_weights_equal(enc_t, backbone, "base.")
        log(f"options: transfer to CVPPP (96 train, 8 val plants) in "
            f"{walls['transfer_s']:.2f} s (tree {walls['leaves_tree_s']:.2f}"
            f" s): fc_class {tuple(dec_t['fc_class.weight'].shape)}, the "
            f"backbone still the file's")

        # 4. one profiled train step
        cfg = Config.load(os.path.join(d, "args.json"))
        T = min(cfg.maxseqlen, cfg.limit_seqlen_to)
        batch = [torch.from_numpy(a).cuda() for a in next(iter(
            init_dataloaders(cfg)["train"]))]
        enc_w, dec_w = load_weights(cfg)
        state = ts.create_train_state(cfg, (enc_w, dec_w))
        step, _ = ts.make_train_step(cfg, T=T)
        flags = ts.StepFlags.from_config(cfg)
        gen = cuda_generator(args.seed)
        state, _ = step(state, batch, flags, gen)
        trace_dir = os.path.join(root, "trace")
        t0 = time.perf_counter()
        with profiling.trace(trace_dir):
            state, _ = step(state, batch, flags, gen)
        walls["profiled_step_s"] = time.perf_counter() - t0
        rows = profiling.op_table(profiling.load_trace_events(trace_dir),
                                  top=12)
        log(f"options: one profiled train step (B=8, T={T}, 256x256, "
            f"bf16), device kernels by self time:")
        for name, ms in rows:
            log(f"  {ms:9.3f} ms  {name[:100]}")
        all_rows = profiling.op_table(profiling.load_trace_events(
            trace_dir), top=10 ** 6)
        for kernel, epilogue in (("K1", "LstmForward"),
                                 ("K4", "LstmBackward")):
            mine = [(n, ms) for n, ms in all_rows if epilogue in n]
            if not mine:
                raise SystemExit(f"profile: no {kernel} ({epilogue}) "
                                 f"kernel among the device rows")
            log(f"  {kernel}: {sum(ms for _, ms in mine):.3f} ms in "
                f"{len(mine)} kernel names, rank "
                f"{all_rows.index(mine[0]) + 1} of {len(all_rows)}")
        del state, batch

        # 5. verify_parity on the card
        parity = {}
        for name, skip, n_cls in (("cs", "concat", 9), ("voc", "mul", 21)):
            ck = os.path.join(models, name)
            vargs = [os.path.join(ck, "encoder.pt"),
                     os.path.join(ck, "decoder.pt"), "-base_model",
                     "resnet101", "-hidden_size", "128", "-num_classes",
                     str(n_cls), "-skip_mode", skip, "-maxseqlen", "20",
                     "-imsize", "512", "-n_images", "2", "--device"]
            fwd = forward_counters()
            for fn in fwd.values():
                fn.launches = 0
            t0 = time.perf_counter()
            rc, out = run_captured(verify_parity.main, vargs)
            wall = time.perf_counter() - t0
            got = {k: fn.launches for k, fn in fwd.items()}
            deltas = {key: float(m.group(1)) for key, m in (
                (key, re.search(rf"{pat}\s*:\s*([0-9.eE+-]+)", out))
                for key, pat in (("mask_iou", "mean mask-IoU delta"),
                                 ("mask", r"max \|mask delta\|"),
                                 ("class", r"max \|class delta\|"),
                                 ("stop", r"max \|stop delta\|")))
                if m}
            if rc != 0 or len(deltas) != 4 or deltas["mask_iou"] > 1e-3 \
                    or got != forward_launches(skip, 20, 1):
                raise SystemExit(f"verify_parity {skip}: rc {rc}, deltas "
                                 f"{deltas}, launches {got} (want "
                                 f"{forward_launches(skip, 20, 1)})")
            parity[skip] = {"wall_s": wall, "deltas": deltas,
                            "launches": got}
            walls[f"verify_parity_{skip}_s"] = wall
            log(f"options: verify_parity --device {skip} (2 x 512x1024, "
                f"T=20, fp32) in {wall:.2f} s: {deltas}; launches {got}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"options phase wall times ({card}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls.items()))
    return {"walls": walls, "launches": launches, "parity": parity,
            "profile_rows": rows}


def time_backward_kernels(cell_geoms, b, gen) -> dict:
    """K4, K5 and K3 at the train step's five cells (bf16): device ms of
    one decode step's five launches of each, against the plain version,
    the bound and the library call (cuDNN's conv and its weight gradient on
    NCHW copies of the same inputs)."""
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    from rsis_tpu_torch.ops.conv3x3 import (conv3x3_rowmajor,
                                            conv3x3_rowmajor_ref)
    F = torch.nn.functional
    dtype = torch.bfloat16
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bytes", "ops")
    out = {k: dict.fromkeys(keys, 0.0) for k in ("k3", "k4", "k5")}
    for k in out.values():
        k["cells"] = []
    for i, geom in enumerate(cell_geoms):
        hh, ww, ch, cx = geom
        ops, (dh, dc) = bwd_inputs(geom, b, dtype, gen)
        h_prev, x_pad = ops[0], ops[1]
        kw = {"cx": cx, "ch": ch}
        dg, dc_prev = fcv.cell_backward_dgates(*ops, dh, dc, **kw)
        gemm_ops = 2.0 * 4 * ch * 9 * (cx + ch) * b * hh * ww
        nchw = [t.permute(0, 2, 1, 3).contiguous() for t in
                ([x_pad[:, 1:-1, :, 1:-1]] if cx else []) + [h_prev]]
        xh_nchw = torch.cat(nchw, dim=1)
        dg_nchw = dg.permute(0, 2, 1, 3).contiguous()
        wpack = fcv.conv_transpose_weights(ops[4], cx, ch, "xh" if cx else "h")
        w_conv = wpack.reshape(cx + ch, 3, 3, 4 * ch).permute(0, 3, 1, 2
                                                               ).contiguous()
        rows = {
            "k4": (lambda: fcv.cell_backward_dgates(*ops, dh, dc, **kw),
                   lambda: fcv.cell_backward_dgates_ref(*ops, dh, dc, **kw),
                   None, nbytes(*ops, dh, dc, dg, dc_prev), gemm_ops),
            "k5": (lambda: fcv.weight_grad_rowmajor(h_prev, x_pad, dg, **kw),
                   lambda: fcv.weight_grad_ref(h_prev, x_pad, dg, **kw),
                   lambda: torch.nn.grad.conv2d_weight(
                       xh_nchw, (4 * ch, cx + ch, 3, 3), dg_nchw, padding=1),
                   # dwt has wt's size and dtype
                   nbytes(h_prev, x_pad, dg, ops[4]), gemm_ops),
            "k3": (lambda: conv3x3_rowmajor(dg, wpack, cin=4 * ch,
                                            cout=cx + ch),
                   lambda: conv3x3_rowmajor_ref(dg, wpack, cin=4 * ch,
                                                cout=cx + ch),
                   lambda: F.conv2d(dg_nchw, w_conv, padding=1),
                   nbytes(dg, wpack) + b * hh * (cx + ch) * ww * 2,
                   gemm_ops),
        }
        for name, (kern, plain, library, n_b, n_ops) in rows.items():
            ms = graph_ms(kern, iters=20)
            pms = graph_ms(plain, iters=5)
            lms = graph_ms(library, iters=20) if library else None
            bms, by = bound_ms(n_b, n_ops, dtype)
            row = out[name]
            row["cells"].append({"cell": i, "geom": list(geom), "ms": ms,
                                 "plain_ms": pms, "library_ms": lms,
                                 "bound_ms": bms, "bound_by": by})
            for key, val in (("ms", ms), ("plain_ms", pms), ("bound_ms", bms),
                             ("library_ms", lms or 0.0), ("bytes", n_b),
                             ("ops", n_ops)):
                row[key] += val
            lib = f"{lms:.4f}" if lms is not None else "none"
            log(f"  {name.upper()} cell{i} {geom} B={b}: {ms:.4f} ms (plain "
                f"{pms:.4f}, library {lib}, bound {bms:.4f} by {by})")
    for name, row in out.items():
        row["bound_by"] = bound_ms(row["bytes"], row["ops"], dtype)[1]
        if name == "k4":
            row["library_ms"] = None
    return out


def time_lap(b: int, T: int, n: int, gen) -> dict:
    """K6 at the train step's matcher shape (B, T predictions, N GT slots)
    on loss-like costs: device ms against the plain (host) solver. The
    bound counts what these costs need: the costs read and row4col written
    once, and 6 fp32 operations per column per Dijkstra step that the
    plain solver took on them. The figure of merit of the sequential
    solver: ns a Dijkstra step of the batch's longest problem
    (max_scans)."""
    from rsis_tpu_torch.ops.lap import solve_lap_batch, solve_lap_batch_ref
    costs = [c for name, c in lap_cases(gen, b, ((T, n),))
             if name.startswith("ties")][0]
    stats = {}
    solve_lap_batch_ref(costs, stats)
    ms = graph_ms(lambda: solve_lap_batch(costs), iters=20)
    pms = cuda_ms(lambda: solve_lap_batch_ref(costs), iters=3, warmup=1)
    bms, by = bound_ms(nbytes(costs) + b * n * 4, 6.0 * n * stats["scans"],
                       torch.float32)
    ns_step = ms * 1e6 / stats["max_scans"]
    log(f"  K6 LAP ({b}, {T}, {n}): {ms:.4f} ms (plain {pms:.4f} on the "
        f"host, bound {bms:.6f} by {by}; {stats['scans']} Dijkstra steps, "
        f"{stats['max_scans']} in the longest problem: {ns_step:.1f} ns a "
        f"step)")
    return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "scans": stats["scans"], "max_scans": stats["max_scans"],
            "ns_per_step": ns_step}


def mul_geoms(height: int, width: int, widths) -> list:
    """(H, W, Cx, C) of the five cells of the mul decode at one input
    size: cell 0 reads the coarsest skip (width widths[0]), cell i the
    upsampled state of cell i - 1 times skip i (width widths[i - 1])."""
    return [(height // 2 ** (5 - i), width // 2 ** (5 - i),
             widths[i - 1] if i else widths[0], ch)
            for i, ch in enumerate(widths)]


def clstm_inputs(geom, b, dtype, gen):
    """Random K8 operands (x, h_prev, c_prev, weight, bias) at one cell
    geometry (H, W, Cx, C), NCHW."""
    h, w, cx, ch = geom

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    weight = rnd(4 * ch, cx + ch, 3, 3, scale=(1.0 / (9 * (cx + ch))) ** 0.5)
    bias = torch.randn(4 * ch, generator=gen, device="cuda") * 0.1
    return (rnd(b, cx, h, w), rnd(b, ch, h, w), rnd(b, ch, h, w), weight,
            bias)


def check_clstm(geoms, batches, gen) -> float:
    """K8 against its plain version at the mul decode's five cells at each
    of batches, at K8_EDGE_GEOMS and at a W that is not a multiple of 8
    (the FMA loop in bf16 too): fp32 (TF32 off) within FP32_TOL, bf16
    within one bf16 ulp of max|ref| on h and on c; each launched twice on
    the same inputs with bit-identical results. Returns the worst bf16
    error."""
    from rsis_tpu_torch.ops.clstm_step import clstm_step, clstm_step_ref
    worst = 0.0
    cases = ([(g, bb) for bb in batches for g in geoms] + K8_EDGE_GEOMS
             + [((9, 20, 16, 8), 2)])
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for geom, bb in cases:
            ops = clstm_inputs(geom, bb, dtype, gen)
            got = clstm_step(*ops)
            again = clstm_step(*ops)
            want = clstm_step_ref(*ops)
            torch.cuda.synchronize()
            hh, ww, cx, ch = geom
            name = (f"K8 {geom} B={bb} {tag} "
                    + cell_plan_tag((hh, ww, ch, cx), bb, dtype, kind="step"))
            for nm, g, a, w in zip(("h", "c"), got, again, want):
                err = max_err(g, w)
                check(f"{name} {nm}", err, tol_for(dtype, w))
                if not torch.equal(g, a):
                    raise SystemExit(f"{name} {nm}: two launches on the "
                                     f"same inputs differ")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
    return worst


def time_clstm(geoms, b, gen) -> dict:
    """K8 at the mul decode's five cells (bf16): device ms of one decode
    step's five launches against the plain version and the bound (each
    input read and each output written once; 2 * 4C * 9(Cx+C) operations
    a pixel)."""
    from rsis_tpu_torch.ops.clstm_step import clstm_step, clstm_step_ref
    dtype = torch.bfloat16
    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
           "ops": 0.0, "cells": []}
    for i, geom in enumerate(geoms):
        hh, ww, cx, ch = geom
        ops = clstm_inputs(geom, b, dtype, gen)
        ms = graph_ms(lambda: clstm_step(*ops), iters=20)
        pms = graph_ms(lambda: clstm_step_ref(*ops), iters=5)
        n_b = nbytes(*ops) + 2 * nbytes(ops[1])
        n_ops = 2.0 * 4 * ch * 9 * (cx + ch) * b * hh * ww
        bms, by = bound_ms(n_b, n_ops, dtype)
        out["cells"].append({"cell": i, "geom": list(geom), "ms": ms,
                             "plain_ms": pms, "bound_ms": bms,
                             "bound_by": by})
        for key, val in (("ms", ms), ("plain_ms", pms), ("bound_ms", bms),
                         ("bytes", n_b), ("ops", n_ops)):
            out[key] += val
        log(f"  K8 cell{i} {geom} B={b}: {ms:.4f} ms (plain {pms:.4f}, "
            f"bound {bms:.4f} by {by})")
    out["bound_by"] = bound_ms(out["bytes"], out["ops"], dtype)[1]
    return out


def forward_counters() -> dict:
    """The kernel wrappers of the inference forward."""
    from rsis_tpu_torch.ops.clstm_step import clstm_step
    from rsis_tpu_torch.ops.fused_cell import fused_cell_rowmajor
    from rsis_tpu_torch.ops.mask_head import mask_head_fused_kernel
    return {"fused_cell_rowmajor": fused_cell_rowmajor,
            "mask_head_fused_kernel": mask_head_fused_kernel,
            "clstm_step": clstm_step}


def forward_launches(skip_mode: str, T: int, n: int) -> dict:
    """Launches of n forwards of T steps: K1 and K2 for the channel-
    separable skips, K8 and K2 for mul."""
    if skip_mode == "mul":
        return {"fused_cell_rowmajor": 0, "mask_head_fused_kernel": T * n,
                "clstm_step": 5 * T * n}
    return {"fused_cell_rowmajor": 5 * T * n,
            "mask_head_fused_kernel": T * n, "clstm_step": 0}


def mul_forward_phase(args, xs) -> dict:
    """Phase 3b: ``make_forward`` at full width with mul skips (resnet101,
    hidden 128, 9 classes, 512x1024, bf16, random weights from --seed) on
    the batches xs, K8's and K2's launches read from that run (5 T and T
    per forward, K1 none), the outputs held against the plain path on the
    card and
    the images per second (with --profile, device time by operation and
    the idle share of one forward)."""
    from rsis_tpu_torch import Config
    from rsis_tpu_torch.evals.forward import make_forward
    from rsis_tpu_torch.models.rsis import build_models, forward

    T = args.steps
    b, height, width = xs[0].shape[:3]
    cfg = Config(base_model="resnet101", hidden_size=128, num_classes=9,
                 skip_mode="mul", maxseqlen=T, compute_dtype="bfloat16")
    torch.manual_seed(args.seed)
    enc, dec = build_models(cfg)
    weights = (enc.state_dict(), dec.state_dict())
    fwd = make_forward(cfg, T=T)
    counters = forward_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [fwd(weights, x) for x in xs]
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"mul path: {len(xs)} batches of {b} at {height}x{width}, T={T}, "
        f"bf16, {t_run:.2f} s (first call included); launches {launches}")
    want = forward_launches("mul", T, len(xs))
    if launches != want:
        raise SystemExit(f"mul launch counts {launches} != expected {want}")
    masks, clss, stops = outs[-1]
    want_shapes = ((b, T, height, width), (b, T, 9), (b, T, 1))
    shapes = (tuple(masks.shape), tuple(clss.shape), tuple(stops.shape))
    if shapes != want_shapes:
        raise SystemExit(f"mul output shapes {shapes} != {want_shapes}")
    if not all(torch.isfinite(t.float()).all() for t in outs[-1]):
        raise SystemExit("non-finite mul output")

    # the same weights through the plain path (K8's plain version, the
    # upsample and F.conv2d for K2) on the card; h and c round to bf16 at
    # every cell in both paths, so the outputs agree to a few bf16 ulps of
    # [0, 1] (the concat check's limit)
    enc_p, dec_p = build_models(cfg)
    enc_p.load_state_dict(weights[0])
    dec_p.load_state_dict(weights[1])
    enc_p = enc_p.to("cuda", torch.bfloat16)
    dec_p = dec_p.to("cuda")
    x_nchw = xs[-1].permute(0, 3, 1, 2).contiguous()
    plain = forward(cfg, enc_p, dec_p, x_nchw, T=T, plain=True)
    err = {}
    for nm, got, ref in zip(("masks", "class_probs", "stops"), outs[-1],
                            plain):
        err[nm] = max_err(got, ref)
        check(f"mul path vs plain path, {nm}", err[nm], 8 * BF16_ULP)
    del plain
    fwd_ms = cuda_ms(lambda: forward(cfg, enc_p, dec_p, x_nchw, T=T),
                     iters=3)
    img_s = b / (fwd_ms / 1e3)
    log(f"mul forward T={T} {fwd_ms:.3f} ms/batch = {img_s:.2f} img/s "
        f"(B={b}, bf16; CUDA events around whole calls)")
    profile = None
    if args.profile:
        profile = profile_call(
            lambda: forward(cfg, enc_p, dec_p, x_nchw, T=T), None,
            "mul_forward")
    return {"launches": launches, "err": err, "forward_ms": fwd_ms,
            "images_per_s": img_s, "profile": profile}


def write_cityscapes(root, rng, n=2, size=(1024, 2048)):
    """gtFine val of one city at the dataset's native size: random images,
    instance ids of persons (24xxx), cars (26xxx), a caravan (29xxx, which
    the catalog drops) and a person crowd region (24)."""
    import numpy as np
    from PIL import Image
    h, w = size
    img_dir = os.path.join(root, "cs", "leftImg8bit", "val", "cityA")
    gt_dir = os.path.join(root, "cs", "gtFine", "val", "cityA")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        ids = np.zeros((h, w), np.int32)
        for iid in (24000, 24001, 26000, 26001, 29000, 24):
            cy, cx = rng.integers(h // 10, h - h // 10), rng.integers(
                w // 10, w - w // 10)
            ry, rx = rng.integers(h // 25, h // 5, 2)
            ids[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = iid
        name = f"cityA_{i:06d}_000019"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(img_dir,
                                            f"{name}_leftImg8bit.png"))
        Image.fromarray(ids.astype(np.uint16)).save(
            os.path.join(gt_dir, f"{name}_gtFine_instanceIds.png"))
    return os.path.join(root, "cs")


def write_leaves(root, rng, n=3, size=(530, 500)):
    """CVPPP A1 plants at the dataset's image size, 4-8 leaves each."""
    import numpy as np
    from PIL import Image
    h, w = size
    d = os.path.join(root, "A1")
    os.makedirs(d)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        label = np.zeros((h, w), np.uint8)
        for k in range(1, int(rng.integers(4, 9))):
            cy, cx = rng.integers(h // 8, h - h // 8), rng.integers(
                w // 8, w - w // 8)
            r = rng.integers(h // 25, h // 8)
            label[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = k
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(d, f"plant{i:03d}_rgb.png"))
        Image.fromarray(label).save(os.path.join(d, f"plant{i:03d}_label.png"))
    return d


def write_pascal(root, rng, n=2, size=(375, 500)):
    """VOC layout at a typical VOC image size: a person and a car as
    palette PNGs with a 255 ignore border, and the val list."""
    import numpy as np
    from PIL import Image
    from rsis_tpu_torch.data.tools.palettes import pascal_palette
    h, w = size
    d = os.path.join(root, "voc")
    for sub in ("JPEGImages", "SegmentationClass", "SegmentationObject",
                "ImageSets/Segmentation"):
        os.makedirs(os.path.join(d, sub))
    color = {v: k for k, v in pascal_palette().items()}
    yy, xx = np.ogrid[:h, :w]
    names = []
    for i in range(n):
        name = f"2007_{i:06d}"
        names.append(name)
        seg = np.zeros((h, w, 3), np.uint8)
        obj = np.zeros((h, w, 3), np.uint8)
        for k, cls in enumerate((15, 7), start=1):
            cy, cx = rng.integers(h // 5, h - h // 5), rng.integers(
                w // 5, w - w // 5)
            r = rng.integers(h // 12, h // 5)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            seg[blob], obj[blob] = color[cls], color[k]
        seg[:3], obj[:3] = color[255], color[255]
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(d, "JPEGImages", f"{name}.jpg"))
        Image.fromarray(seg).save(
            os.path.join(d, "SegmentationClass", f"{name}.png"))
        Image.fromarray(obj).save(
            os.path.join(d, "SegmentationObject", f"{name}.png"))
    with open(os.path.join(d, "ImageSets/Segmentation/val.txt"), "w") as fp:
        fp.write("\n".join(names) + "\n")
    return d


def eval_phase(args, out_dir, models) -> dict:
    """Phase 3c: the evaluation entry points in process on the card. Under
    build/, from --seed: a Cityscapes val tree (2 images, 1024x2048), a
    CVPPP A1 tree (3 plants) and a Pascal tree (2 images, precomputed by
    the port's pascal_precompute); two full-width checkpoints written by
    the port's train/checkpoint.py (random weights, bf16) into ``models``
    (kept for phase 4c's verify_parity): "cs" (concat, 9 classes) and
    "voc" (mul, 21 classes). Then cli.eval_cityscapes (cs,
    -imsize 512: input 512x1024, T=20, built-in AP), cli.eval_leaves (cs),
    cli.eval (voc, COCO stats) and cli.predict (voc, two images): every
    output file, finite scores and the kernels' launches per forward are
    checked; the wall time per image and the forward's share of it are
    printed (with --profile, the device's idle share of the Cityscapes
    run)."""
    import shutil
    import tempfile
    import numpy as np
    from rsis_tpu_torch import Config
    from rsis_tpu_torch.cli import eval as cli_eval
    from rsis_tpu_torch.cli import eval_cityscapes, eval_leaves, predict
    from rsis_tpu_torch.data.tools.pascal_precompute import run as precompute
    from rsis_tpu_torch.models.rsis import build_models
    from rsis_tpu_torch.train.checkpoint import save_checkpoint
    from rsis_tpu_torch.train.step import create_train_state

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_",
                            dir=os.path.join(here, "build"))
    rng = np.random.default_rng(args.seed)
    try:
        t0 = time.perf_counter()
        cs_dir = write_cityscapes(root, rng)
        leaves_dir = write_leaves(root, rng)
        voc_dir = write_pascal(root, rng)
        precompute(voc_dir, "val")
        for name, skip, n_cls in (("cs", "concat", 9), ("voc", "mul", 21)):
            cfg = Config(base_model="resnet101", hidden_size=128,
                         num_classes=n_cls, skip_mode=skip,
                         compute_dtype="bfloat16", models_root=models,
                         model_name=name)
            torch.manual_seed(args.seed)
            enc, dec = build_models(cfg)
            state = create_train_state(cfg, (enc.state_dict(),
                                             dec.state_dict()))
            save_checkpoint(cfg, state)
            del state, enc, dec
        log(f"eval phase set-up (trees, precompute, two checkpoints): "
            f"{time.perf_counter() - t0:.2f} s")
        common = ["-models_root", models, "--log_term", "-seed",
                  str(args.seed)]
        pred_dir = os.path.join(root, "predictions")
        runs = [
            ("eval_cityscapes", eval_cityscapes.main, "concat", 20, 2,
             ["-model_name", "cs", "-dataset", "cityscapes",
              "-cityscapes_dir", cs_dir, "-eval_split", "val", "-imsize",
              "512", "-maxseqlen", "20", "-batch_size", "2"]),
            ("eval_leaves", eval_leaves.main, "concat", 20, 3,
             ["-model_name", "cs", "-dataset", "leaves", "-leaves_dir",
              leaves_dir, "-eval_split", "train", "-imsize", "512",
              "--resize", "-maxseqlen", "20", "-batch_size", "3"]),
            ("eval", cli_eval.main, "mul", 10, 2,
             ["-model_name", "voc", "-dataset", "pascal", "-pascal_dir",
              voc_dir, "-eval_split", "val", "-imsize", "256",
              "-maxseqlen", "10", "-batch_size", "2"]),
            ("predict", predict.main, "mul", 10, 2,
             ["-model_name", "voc", "-predict_input",
              os.path.join(voc_dir, "JPEGImages"), "-predict_output",
              pred_dir, "-imsize", "256", "--resize", "-maxseqlen", "10",
              "-batch_size", "2", "-stop_th", "0"]),
        ]
        counters = forward_counters()
        results = {}
        for name, main_fn, skip, T, n_img, argv in runs:
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            res = main_fn(common + argv)
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            want = forward_launches(skip, T, 1)
            if res["images"] != n_img or launches != want:
                raise SystemExit(f"cli.{name}: {res['images']} images, "
                                 f"launches {launches} (want {n_img} "
                                 f"images in one forward: {want})")
            results[name] = {"wall_s": wall, "images": n_img,
                             "forward_s": res["forward_s"],
                             "s_per_image": wall / n_img,
                             "forward_share": res["forward_s"] / wall,
                             "launches": launches}
            log(f"cli.{name} ({skip}, T={T}): {wall:.2f} s for {n_img} "
                f"images = {wall / n_img:.3f} s per image, the forward "
                f"{res['forward_s']:.3f} s ({res['forward_s'] / wall:.3f} "
                f"of the wall time); launches {launches}")
            results[name]["result"] = res

        cs = results["eval_cityscapes"]["result"]
        for txt in cs["written"]:
            with open(txt) as fp:
                lines = fp.read().split("\n")[:-1]
            if len(lines) != 20 * 8 or not all(os.path.exists(
                    os.path.join(os.path.dirname(txt), ln.split()[0]))
                    for ln in lines):
                raise SystemExit(f"cli.eval_cityscapes: {txt} lists "
                                 f"{len(lines)} masks, or one is missing")
        ap = cs["ap"]
        leaves = results["eval_leaves"]["result"]
        scores = leaves["scores"]
        stats = results["eval"]["result"]["stats"]
        pred = results["predict"]["result"]["written"]
        files = (cs["written"] + leaves["written"] + pred["png"]
                 + [pred["json"]])
        if (len(cs["written"]) != 2 or len(leaves["written"]) != 3
                or len(pred["png"]) != 2
                or not all(os.path.exists(f) for f in files)):
            raise SystemExit(f"missing evaluation outputs: {files}")
        if ap is None or scores is None or stats is None or len(stats) != 12 \
                or not np.isfinite([ap["allAp"], ap["allAp50%"], scores["SBD"],
                                    scores["absDiC"]] + list(stats)).all():
            raise SystemExit(f"non-finite evaluation results: AP {ap}, "
                             f"CVPPP {scores}, COCO stats {stats}")
        log(f"eval results (random weights): Cityscapes allAp "
            f"{ap['allAp']:.4f}, allAp50% {ap['allAp50%']:.4f}; CVPPP SBD "
            f"{scores['SBD']:.4f}, |DiC| {scores['absDiC']:.4f}; Pascal "
            f"COCO AP {stats[0]:.4f}; predict "
            f"{results['predict']['result']['instances']} instances")
        profile = None
        if args.profile:
            # no trace file: seconds of host work make it too large
            profile = profile_call(
                lambda: eval_cityscapes.main(common + runs[0][-1]), None,
                "eval_cityscapes")
        for r in results.values():
            r.pop("result")
        results["scores"] = {"cityscapes_ap": ap, "cvppp": scores,
                             "coco_stats": stats}
        results["profile"] = profile
        return results
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10, help="decode steps T")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    ap.add_argument("--train-batch", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=5,
                    help="decode steps T of the train step")
    ap.add_argument("--profile", action="store_true",
                    help="print device time by operation for one forward "
                    "and one train step")
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
        from rsis_tpu_torch.kernels import _binding as rle_binding
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
    t0 = time.perf_counter()
    log(f"build: RLE library {rle_binding.build().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, info in sorted(built.items()):
        log_ptxas(name, info["log"])

    b = args.batch
    hidden, height, width = 128, 512, 1024
    widths = decoder_widths(hidden)
    # (H, W, C, Cx) of the five cells and the head input at this geometry
    cell_geoms = []
    for i, ch in enumerate(widths):
        hh, ww = height // 2 ** (5 - i), width // 2 ** (5 - i)
        cell_geoms.append((hh, ww, ch, widths[i - 1] if i else 0))
    head_shape = (b, cell_geoms[-1][0], widths[-1], cell_geoms[-1][1])
    # (H, W, Cx, C) of the mul decode's five cells (K8)
    k8_geoms = mul_geoms(height, width, widths)
    # the five cells of the train step's decode (input TRAIN_HW)
    train_geoms = [(TRAIN_HW[0] // 2 ** (5 - i), TRAIN_HW[1] // 2 ** (5 - i),
                    ch, widths[i - 1] if i else 0)
                   for i, ch in enumerate(widths)]
    tb = args.train_batch
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out_dir = (os.path.dirname(os.path.abspath(args.out)) if args.out
               else None)

    # ---- 2. kernels against their plain versions ----------------------
    log(f"kernel checks at the main path's shapes, B={b}:")
    k1_err = k4_edge_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for i, geom in enumerate(cell_geoms):
            ops = cell_inputs(geom, b, dtype, gen)
            h_k, c_k = fused_cell_rowmajor(*ops, cx=geom[3], ch=geom[2])
            h_a, c_a = fused_cell_rowmajor(*ops, cx=geom[3], ch=geom[2])
            h_r, c_r = fused_cell_rowmajor_ref(*ops, cx=geom[3], ch=geom[2])
            torch.cuda.synchronize()
            name = f"K1 cell{i} {geom} {tag} " + cell_plan_tag(geom, b,
                                                               dtype)
            for nm, got, again, want in (("h", h_k, h_a, h_r),
                                         ("c", c_k, c_a, c_r)):
                err = max_err(got, want)
                tol = (FP32_TOL if dtype == torch.float32 else
                       BF16_ULP * want.float().abs().max().item())
                check(f"{name} {nm}", err, tol)
                if not torch.equal(got, again):
                    raise SystemExit(f"{name} {nm}: two launches on the "
                                     f"same inputs differ")
                if dtype == torch.bfloat16:
                    k1_err = max(k1_err, err)
        # K1 and K4 at the edges of their plans (K1_EDGE_GEOMS)
        for geom, bb in K1_EDGE_GEOMS:
            errs = check_cell_kernels(geom, bb, dtype, gen, "edge ")
            k1_err = max(k1_err, errs["k1"])
            k4_edge_err = max(k4_edge_err, errs["k4"])
        # widths that are not multiples of 8 take K1's FMA loop in bf16 too
        geom = (32, 64, 4, 12)
        ops = cell_inputs(geom, 2, dtype, gen)
        for nm, got, want in zip(
                ("h", "c"), fused_cell_rowmajor(*ops, cx=12, ch=4),
                fused_cell_rowmajor_ref(*ops, cx=12, ch=4)):
            tol = (FP32_TOL if dtype == torch.float32 else
                   BF16_ULP * want.float().abs().max().item())
            check(f"K1 {geom} B=2 {tag} {nm}", max_err(got, want), tol)
    k2_err = check_k2([(bb,) + head_shape[1:] for bb in
                       sorted({32, 4, b}, reverse=True)]
                      + [(tb, TRAIN_HW[0] // 2) + head_shape[2:3]
                         + (TRAIN_HW[1] // 2,)], gen)
    k8_err = check_clstm(k8_geoms, sorted({32, 4, b}, reverse=True), gen)
    log(f"backward kernel checks at the train step's shapes, B={tb}:")
    bwd_err = check_backward_kernels(train_geoms, tb, gen,
                                     k3_batches=sorted({b, 8, 32}))
    bwd_err["k4"] = max(bwd_err["k4"], k4_edge_err)
    lap_err = check_lap(gen)
    cell_bwd_ulps = check_cell_backward(train_geoms, tb, gen)
    log(f"  cell backward bf16: worst {cell_bwd_ulps:.3f} bf16 ulps")
    warp_err = check_warp(sorted({8, tb}), gen)

    # ---- 3. the inference path -----------------------------------------
    cfg = Config(base_model="resnet101", hidden_size=hidden, num_classes=9,
                 skip_mode="concat", maxseqlen=args.steps,
                 compute_dtype="bfloat16")
    torch.manual_seed(args.seed)
    enc, dec = build_models(cfg)
    weights = (enc.state_dict(), dec.state_dict())
    fwd = make_forward(cfg, T=args.steps)
    xs = [torch.randn(b, height, width, 3, generator=gen, device="cuda")
          for _ in range(args.batches)]
    counters = forward_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [fwd(weights, x) for x in xs]
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"main path: {args.batches} batches of {b} at {height}x{width}, "
        f"T={args.steps}, bf16, {t_main:.2f} s (first call included); "
        f"launches {launches}")
    want = forward_launches("concat", args.steps, args.batches)
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

    # ---- 3b, 3c. the mul forward and the evaluation entry points --------
    mul = mul_forward_phase(args, xs)
    del xs
    import shutil
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    # the eval phase's two full-width checkpoints, for phase 4c too
    models = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                              dir=os.path.join(here, "build"))
    try:
        evals = eval_phase(args, out_dir, models)

        # ---- 4. the training path --------------------------------------
        train = train_phase(args, out_dir)
        trainer = trainer_phase(args, out_dir)
        options = options_phase(args, models, card)
    finally:
        shutil.rmtree(models, ignore_errors=True)

    # ---- 5. timings ----------------------------------------------------
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
            profile_call(
                lambda: forward(cfg, encoder, dec_p, x_nchw, T=args.steps),
                out_dir, "forward")
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
    k2 = time_k2(head_shape, gen)
    k8 = time_clstm(k8_geoms, b, gen)
    bwd = time_backward_kernels(train_geoms, tb, gen)
    lap = time_lap(tb, args.train_steps, 20, gen)
    warp = time_warp(tb, gen)
    tl = train["launches"]

    def bwd_row(key, name, source, replaces):
        row = bwd[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": tl[name],
                "max_abs_err": bwd_err[key], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

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
         "max_abs_err": k2_err, "ms": k2["rowmajor"]["ms"],
         "plain_ms": k2["rowmajor"]["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
        bwd_row("k3", "conv3x3_rowmajor", "rsis_tpu_torch/csrc/conv3x3.cu",
                "rsis_tpu/ops/pallas_decode.py:437"),
        bwd_row("k4", "cell_backward_dgates",
                "rsis_tpu_torch/csrc/cell_bwd.cu",
                "rsis_tpu/ops/pallas_decode_vjp.py:194"),
        bwd_row("k5", "weight_grad_rowmajor",
                "rsis_tpu_torch/csrc/weight_grad.cu",
                "rsis_tpu/ops/pallas_decode_vjp.py:317"),
        {"name": "solve_lap_batch", "route": "cuda",
         "source": "rsis_tpu_torch/csrc/lap.cu",
         "replaces": "rsis_tpu/ops/pallas_matching.py:185",
         "launches": tl["solve_lap_batch"], "max_abs_err": lap_err,
         "ms": lap["ms"], "plain_ms": lap["plain_ms"],
         "bound_ms": lap["bound_ms"], "bound_by": lap["bound_by"],
         "library_ms": None},
        {"name": "warp_by_coefficients", "route": "cuda",
         "source": "rsis_tpu_torch/csrc/warp.cu",
         "replaces": "rsis_tpu/ops/pallas_warp.py:437",
         "launches": tl["warp_by_coefficients"], "max_abs_err": warp_err,
         "ms": warp["ms"], "plain_ms": warp["plain_ms"],
         "bound_ms": warp["bound_ms"], "bound_by": warp["bound_by"],
         "library_ms": warp["library_ms"]},
        {"name": "clstm_step", "route": "cuda",
         "source": "rsis_tpu_torch/csrc/clstm_step.cu",
         "replaces": "rsis_tpu/ops/pallas_clstm.py:154",
         "launches": mul["launches"]["clstm_step"], "max_abs_err": k8_err,
         "ms": k8["ms"], "plain_ms": k8["plain_ms"],
         "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
         "library_ms": None},
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
                       "k2": k2,
                       "cell_bwd_bf16_ulps": cell_bwd_ulps,
                       "train": train, "train_batch": tb,
                       "trainer": trainer, "options": options,
                       "warp": warp,
                       "backward_cells": {k: v["cells"]
                                          for k, v in bwd.items()},
                       "lap": lap, "mul": mul, "k8_cells": k8["cells"],
                       "evals": evals, "kernels": kernels}, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s; kernel times are "
        f"device times (CUDA-graph replay): K1 and K8 ms are one decode "
        f"step's five launches at B={b}, K2 ms one launch ((B, H, C, W) "
        f"input; its library ms the two-call interpolate + conv2d "
        f"yardstick); K3, K4 and K5 ms "
        f"one decode step's five launches at B={tb}, K6 and K7 ms one "
        f"launch; launches of K1 and K2 are from the inference path, of K8 "
        f"from the mul path, of K3-K7 from the train path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
