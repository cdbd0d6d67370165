#!/usr/bin/env python3
"""K1 (the fused decode cell), K4 (the cell backward), K5 (the weight
gradient), K3 (the pullback conv) and K8 (the NCHW ConvLSTM step) per cell,
K2 (the mask head) per head shape, K6 (the LAP matcher) and K7 (the
augmentation warp) at the train step's shapes, the bench-geometry mul
forward and train step, timed on one GPU, for comparing two trees of the
port in one call.

Runs the ``rsis_tpu_torch`` package beside it (run a copy of this script
from the root of another tree to time that tree), with ``chip_smoke.py``'s
inputs, timers and bounds:

- --k5: ``weight_grad_rowmajor`` at the train step's five cells (256x512
  input, hidden 128, bf16) for each --k5-batch, at the Pascal recipe's
  (256x256, B=28, fp32, TF32 off: the FMA loop) and at the CVPPP
  recipe's (400x400, bf16, B=2 and 256: the FMA loop at widths 13-100):
  device ms of one launch (CUDA-graph replay), its bound, ``torch.nn.
  grad.conv2d_weight`` on NCHW copies of the same inputs in the same
  dtype, and the error against ``weight_grad_ref``;
- --sweep: every tensor-core plan of K5 at those cells and batches
  (``weight_grad_plan`` replaced for the call), each checked against the
  plain version, the fastest beside the chosen one;
- --fma-sweep: the FMA loop's plans around the chosen one at the Pascal
  recipe's cells (fp32, B=28) and the CVPPP recipe's edge cells (bf16,
  B=256): every thread tile and pixel-group count within a factor of two
  of the chosen one, every unit, half and twice the chunks, the other
  ring depth; timed and checked the same way;
- --k3: ``conv3x3_rowmajor`` (K3) at the same cells and batches: device
  ms of one launch, of the cell backward's pullback (``conv3x3_pullback``
  where the tree has it, else the stacked conv with the slice and pad
  the backward then copied), its bound, ``F.conv2d`` on NCHW copies of
  the same inputs, and the error against ``conv3x3_rowmajor_ref``;
- --k3-sweep: every tensor-core plan of K3 at those cells and batches
  (``conv3x3_plan`` replaced for the call), each checked against the
  plain version, the fastest beside the chosen one;
- --k1: ``fused_cell_rowmajor`` (K1) at the forward's five cells (512x1024
  input, hidden 128, bf16) for each --k1-batch; --k4:
  ``cell_backward_dgates`` (K4) at the train step's five cells for each
  --k4-batch: device ms of one launch, its bound, the plain version's ms,
  cuDNN's gate convolution alone (``F.conv2d`` of the NCHW concat of x
  and h_prev: a yardstick for the GEMM part, not the cell's function),
  and the error against the plain version;
- --k8: ``clstm_step`` (K8) at the mul decode's five cells (512x1024) for
  each --k1-batch, timed as --k1 (cuDNN's gate conv of the NCHW concat of
  x and h_prev beside it);
- --cell-sweep [k1 k4 k8]: every tensor-core plan of the named kernels
  (all without a name) at those cells and batches (``cell_plan`` replaced
  for the call), each checked against the plain version, the fastest
  beside the chosen one;
- --k2: ``mask_head_fused_kernel`` ((B, H, C, W) input) and, where the
  tree has it, ``mask_head_nchw_kernel`` ((B, C, H, W)) at the head's
  shape at 512x1024 (B=32 and 4) and at the train step's (256x512, B=32),
  bf16, and at the first in fp32: device ms of one launch, the plain
  version's, the bound (where the tree's chip_smoke.py has
  ``head_bound``), the two-call yardstick
  ``F.interpolate(..., mode="bilinear", align_corners=True)`` then
  ``F.conv2d`` on the NCHW input, and the error against the plain
  version;
- --k2-sweep: every plan of K2 at those shapes in both layouts
  (``mask_head_plan`` replaced for the call), each checked against the
  plain version, the fastest beside the chosen one;
- --k6: ``solve_lap_batch`` (K6) at the train step's matcher shapes
  (32, 20, 20) and (8, 5, 20) on the tie-heavy loss-like costs of
  ``lap_cases``: device ms of one launch, of the tree's ``hungarian`` on
  the (B, N, T) costs, the Dijkstra steps of the longest problem and ns
  a step, row4col against the plain version;
- --k7: ``warp_by_coefficients`` (K7) at 256x512, bf16 RGB, the bench's
  ranges, B=32 and 8 (``chip_smoke.time_warp``): ms, plain, bound and
  share, the two ``torch.gather`` calls, the augmentation block;
- --upsample: the inter-cell upsample at the forward's four (512x1024,
  hidden 128, bf16) for each --k1-batch, checked as chip_smoke.py's phase
  2 checks it (``check_upsample``) and timed (``time_upsample``: each launch's device ms, the plain
  version's, ``F.interpolate``'s and the bound);
- --mul: the mul-skip forward at --batch, --steps (512x1024, bf16, K8
  in every cell, K2 on the head where the tree routes it; chip_smoke.py's
  phase 3b): ms a forward, images per second; with --profile, device
  time by operation of one forward;
- --step: the train step at --batch, --steps (resnet101, device
  augmentation on, bf16): a warm-up step, then --iters steps each timed
  by the host clock around a synchronised step; with --profile, device
  time by kernel over one more step: K1's, K4's, K5's, K3's, K6's and
  K7's kernels by name and their shares, and PyTorch's copy kernels
  (direct_copy).

Prints one JSON object as its last line (and writes it to --out).
Usage: python3 chip_k5_step.py [--k1] [--k4] [--k8] [--k2] [--k2-sweep]
                               [--k6] [--k7] [--upsample]
                               [--cell-sweep [k1 k4 k8]]
                               [--k1-batch 32 4] [--k4-batch 32 8]
                               [--k5] [--k3] [--k5-batch 32 8] [--sweep]
                               [--fma-sweep]
                               [--k3-sweep] [--mul] [--step] [--batch 32]
                               [--steps 20] [--iters 5] [--profile]
                               [--seed 0] [--out FILE]
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch


def _short(kernel: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0]


def _k5_cells(cs, b, gen, hw, dtype):
    """(cell, geom, h_prev, x_pad, dg) at the five cells of a decode at
    input hw: dg from the plain cell backward on chip_smoke's inputs."""
    from rsis_tpu_torch.models.decoder import decoder_widths
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    for i, geom in enumerate(cs.concat_geoms(*hw, decoder_widths(128))):
        ops, (dh, dc) = cs.bwd_inputs(geom, b, dtype, gen)
        kw = {"cx": geom[3], "ch": geom[2]}
        dg = fcv.cell_backward_dgates_ref(*ops, dh, dc, **kw)[0]
        yield i, geom, ops[0], ops[1], dg


def time_k5(cs, b: int, gen, hw=None, dtype=torch.bfloat16) -> list:
    """K5 at the five cells of a decode at input hw (the train step's by
    default): device ms, conv2d_weight's, the bound and the error (bf16:
    in ulps of max|dwt|; fp32: over max|dwt|)."""
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    rows = []
    for i, (hh, ww, ch, cx), h_prev, x_pad, dg in _k5_cells(
            cs, b, gen, hw or cs.TRAIN_HW, dtype):
        kw = {"cx": cx, "ch": ch}
        want = fcv.weight_grad_ref(h_prev, x_pad, dg, **kw)
        got = fcv.weight_grad_rowmajor(h_prev, x_pad, dg, **kw)
        scale = want.float().abs().max().item()
        err = cs.max_err(got, want) / (
            cs.BF16_ULP * scale if dtype == torch.bfloat16 else scale)
        xh = torch.cat([t.permute(0, 2, 1, 3).contiguous() for t in
                        ([x_pad[:, 1:-1, :, 1:-1]] if cx else [])
                        + [h_prev]], dim=1)
        dg_nchw = dg.permute(0, 2, 1, 3).contiguous()
        ms = cs.graph_ms(lambda: fcv.weight_grad_rowmajor(h_prev, x_pad, dg,
                                                          **kw), iters=20)
        lms = cs.graph_ms(lambda: torch.nn.grad.conv2d_weight(
            xh, (4 * ch, cx + ch, 3, 3), dg_nchw, padding=1), iters=20)
        wt_bytes = 4 * ch * 9 * (cx + ch) * dg.element_size()
        bms, by = cs.bound_ms(cs.nbytes(h_prev, x_pad, dg) + wt_bytes,
                              2.0 * 4 * ch * 9 * (cx + ch) * b * hh * ww,
                              dtype)
        tag = "fp32" if dtype == torch.float32 else "bf16"
        rows.append({"cell": i, "geom": [hh, ww, ch, cx], "batch": b,
                     "dtype": tag, "ms": ms, "library_ms": lms,
                     "bound_ms": bms, "bound_by": by, "err": err})
        print(f"K5 {tag} cell{i} ({hh}, {ww}, {ch}, {cx}) B={b}: {ms:.4f} "
              f"ms (conv2d_weight {lms:.4f}, bound {bms:.4f} by {by}; "
              f"error {err:.3e} " + ("bf16 ulps of the max)"
                                     if dtype == torch.bfloat16
                                     else "of the max)"), flush=True)
    print(f"K5 {rows[0]['dtype']} B={b}: {sum(r['ms'] for r in rows):.4f} "
          f"ms a decode step (conv2d_weight "
          f"{sum(r['library_ms'] for r in rows):.4f}, bound "
          f"{sum(r['bound_ms'] for r in rows):.4f})", flush=True)
    return rows


def sweep_k5(cs, b: int, gen, top: int = 5) -> dict:
    """Every tensor-core plan of K5 (warp tile, warps, unit, ring, one or
    more blocks an SM) at the train step's five cells, timed like time_k5
    and checked against the plain version; returns each cell's fastest
    plans beside the one weight_grad_plan chooses."""
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


def _fma_neighbours(fcv, plan, b, h, w):
    """FMA plans around ``plan``: thread tiles and pixel groups (128 or
    256 threads) within a factor of two of its own, every unit of 1-8
    rows x 4-128 columns, half and twice the chunks, the other ring
    depth; each with the deepest ring that fits and no more chunks than
    units."""
    rep = dataclasses.replace
    out = [plan]
    for thm in (plan.threads_m // 2, plan.threads_m, 2 * plan.threads_m):
        for thc in (plan.threads_c // 2, plan.threads_c,
                    2 * plan.threads_c):
            for nt in (128, 256):
                if thm and thc and nt % (thm * thc) == 0:
                    out.append(rep(plan, threads_m=thm, threads_c=thc,
                                   groups=nt // (thm * thc)))
    for rows in (1, 2, 4, 8):
        for tw in (4, 8, 16, 32, 64, 128):
            if rows <= h and tw < 2 * w:
                out.append(rep(plan, rows=rows, tw=tw))
    out += [rep(plan, chunks=max(1, plan.chunks // 2)),
            rep(plan, chunks=2 * plan.chunks),
            rep(plan, stages=5 - plan.stages)]
    seen = {}
    for p in out:
        if p.smem_bytes() > fcv.SMEM_LIMIT:
            p = rep(p, stages=2)
        p = rep(p, chunks=min(p.chunks, p.units(b, h, w)))
        if p.smem_bytes() <= fcv.SMEM_LIMIT:
            seen.setdefault(dataclasses.astuple(p), p)
    return list(seen.values())


def sweep_k5_fma(cs, b: int, gen, hw, dtype, top: int = 5) -> dict:
    """The FMA loop's plans around the chosen one (``_fma_neighbours``) at
    the cells of a decode at input hw that take it, each timed like
    time_k5 and checked against the plain version (fp32: 1e-4 of
    max|dwt|; bf16: one ulp of the max); returns each cell's fastest
    plans beside the one weight_grad_plan chooses."""
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    chosen = fcv.weight_grad_plan
    out = {}
    for i, (hh, ww, ch, cx), h_prev, x_pad, dg in _k5_cells(
            cs, b, gen, hw, dtype):
        mine = chosen(b, hh, ww, ch, cx, dtype)
        if mine.mma:
            continue
        kw = {"cx": cx, "ch": ch}
        want = fcv.weight_grad_ref(h_prev, x_pad, dg, **kw)
        tol = (1e-4 if dtype == torch.float32 else cs.BF16_ULP) * (
            want.float().abs().max().item())
        rows = []
        for plan in _fma_neighbours(fcv, mine, b, hh, ww):
            fcv.weight_grad_plan = lambda *a, plan=plan: plan
            try:
                err = cs.max_err(fcv.weight_grad_rowmajor(
                    h_prev, x_pad, dg, **kw), want)
                ms = cs.graph_ms(lambda: fcv.weight_grad_rowmajor(
                    h_prev, x_pad, dg, **kw), iters=10)
            finally:
                fcv.weight_grad_plan = chosen
            if err > tol:
                raise SystemExit(f"K5 fma cell{i} {plan}: error {err} "
                                 f"over {tol}")
            rows.append((ms, dataclasses.astuple(plan)))
        rows.sort()
        mine_ms = [ms for ms, p in rows
                   if p == dataclasses.astuple(mine)][0]
        out[i] = {"chosen": dataclasses.astuple(mine), "chosen_ms": mine_ms,
                  "best": rows[:top], "plans": len(rows), "all": rows}
        print(f"K5 fma sweep cell{i} B={b} {dtype}: {len(rows)} plans; "
              f"chosen {dataclasses.astuple(mine)} {mine_ms:.4f} ms "
              f"({mine_ms / rows[0][0] - 1:+.1%} of the fastest); fastest "
              + "; ".join(f"{p} {ms:.4f}" for ms, p in rows[:top]),
              flush=True)
    return out


def _k3_cells(cs, b, gen):
    """(cell, geom, dg, wpack) at the train step's five cells: dg from the
    plain K4 on random operands, wpack the transposed cell weight."""
    from rsis_tpu_torch.models.decoder import decoder_widths
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    widths = decoder_widths(128)
    for i, ch in enumerate(widths):
        hh, ww = cs.TRAIN_HW[0] // 2 ** (5 - i), cs.TRAIN_HW[1] // 2 ** (5 - i)
        cx = widths[i - 1] if i else 0
        ops, (dh, dc) = cs.bwd_inputs((hh, ww, ch, cx), b, torch.bfloat16,
                                      gen)
        dg = fcv.cell_backward_dgates_ref(*ops, dh, dc, cx=cx, ch=ch)[0]
        wpack = fcv.conv_transpose_weights(ops[4], cx, ch,
                                           "xh" if cx else "h")
        yield i, (hh, ww, ch, cx), dg, wpack


def time_k3(cs, b: int, gen) -> list:
    from rsis_tpu_torch.ops import conv3x3 as k3
    F = torch.nn.functional
    rows = []
    for i, (hh, ww, ch, cx), dg, wpack in _k3_cells(cs, b, gen):
        kw = {"cin": 4 * ch, "cout": cx + ch}
        want = k3.conv3x3_rowmajor_ref(dg, wpack, **kw)
        got = k3.conv3x3_rowmajor(dg, wpack, **kw)
        err = cs.max_err(got, want) / (
            cs.BF16_ULP * want.float().abs().max().item())
        if hasattr(k3, "conv3x3_pullback"):
            def pullback():
                return k3.conv3x3_pullback(dg, wpack, cx=cx, ch=ch)
        else:   # the stacked conv, the slice and the pad it replaced
            def pullback():
                out = k3.conv3x3_rowmajor(dg, wpack, **kw)
                return (F.pad(out[:, :, :cx], (1, 1, 0, 0, 1, 1)) if cx
                        else None, out[:, :, cx:].contiguous())
        dg_nchw = dg.permute(0, 2, 1, 3).contiguous()
        w_conv = wpack.reshape(cx + ch, 3, 3, 4 * ch).permute(
            0, 3, 1, 2).contiguous()
        ms = cs.graph_ms(lambda: k3.conv3x3_rowmajor(dg, wpack, **kw),
                         iters=20)
        pms = cs.graph_ms(pullback, iters=20)
        lms = cs.graph_ms(lambda: F.conv2d(dg_nchw, w_conv, padding=1),
                          iters=20)
        bms, by = cs.bound_ms(cs.nbytes(dg, wpack) + b * hh * (cx + ch)
                              * ww * 2,
                              2.0 * 4 * ch * 9 * (cx + ch) * b * hh * ww,
                              torch.bfloat16)
        rows.append({"cell": i, "geom": [hh, ww, ch, cx], "batch": b,
                     "ms": ms, "pullback_ms": pms, "library_ms": lms,
                     "bound_ms": bms, "bound_by": by, "err_ulps": err})
        print(f"K3 cell{i} ({hh}, {ww}, {ch}, {cx}) B={b}: {ms:.4f} ms "
              f"(pullback {pms:.4f}; F.conv2d {lms:.4f}, bound {bms:.4f} by "
              f"{by}; error {err:.3f} bf16 ulps of the max)", flush=True)
    print(f"K3 B={b}: {sum(r['ms'] for r in rows):.4f} ms a decode step "
          f"(pullback {sum(r['pullback_ms'] for r in rows):.4f}; F.conv2d "
          f"{sum(r['library_ms'] for r in rows):.4f}, bound "
          f"{sum(r['bound_ms'] for r in rows):.4f})", flush=True)
    return rows


def _k3_plans(b, h, w, cin, cout):
    """Every tensor-core plan of K3 for one cell that the kernel takes and
    whose shared memory fits: warp tiles, warps, channel tiles of Cout or
    Cout / 2, unit shapes, chunks, rings, and parts where the units leave
    SMs idle (up to one wave), else one group of units an SM."""
    import itertools
    from rsis_tpu_torch.ops import conv3x3 as k3
    n8 = cout // 8
    w16 = -(-w // 16) * 16
    for wm, wn, wpm, wpn, cc, st in itertools.product(
            k3.WARP_M_TILES, k3.WARP_N_TILES, (1, 2, 4, 8), (1, 2, 4, 8),
            k3.CHUNK_CHANNELS, (2, 3)):
        if (not 4 <= wpm * wpn <= 8 or n8 % (wn * wpn) or cin % cc
                or n8 // (wn * wpn) > 2):
            continue
        px = 16 * wm * wpm
        tw = 16
        while tw <= min(px, w16):
            rows = px // tw
            tw_, tw = tw, 2 * tw
            if rows > 2 * h:
                continue
            plan = k3.Conv3x3Plan(True, wm, wn, wpm, wpn, rows, tw_, cc, st)
            units = plan.units(b, h, w)
            nt = n8 // (wn * wpn)
            nck = cin // cc
            splits = [1]
            if units * nt < k3.SM_COUNT:
                splits += [d for d in range(2, nck + 1) if nck % d == 0
                           and units * nt * d <= k3.SM_COUNT]
            for sp in splits:
                plan = dataclasses.replace(
                    plan, splits=sp,
                    groups=units if sp > 1 else min(units, k3.SM_COUNT))
                if plan.smem_bytes(cin) <= k3.SMEM_LIMIT:
                    yield plan


def sweep_k3(cs, b: int, gen, top: int = 5) -> dict:
    """Every tensor-core plan of K3 at the train step's five cells, timed
    like time_k3 and checked against the plain version; returns each
    cell's fastest plans beside the one conv3x3_plan chooses."""
    from rsis_tpu_torch.ops import conv3x3 as k3
    chosen = k3.conv3x3_plan
    out = {}
    for i, (hh, ww, ch, cx), dg, wpack in _k3_cells(cs, b, gen):
        kw = {"cin": 4 * ch, "cout": cx + ch}
        want = k3.conv3x3_rowmajor_ref(dg, wpack, **kw)
        tol = cs.BF16_ULP * want.float().abs().max().item()
        rows = []
        for plan in _k3_plans(b, hh, ww, 4 * ch, cx + ch):
            k3.conv3x3_plan = lambda *a, plan=plan: plan
            try:
                err = cs.max_err(k3.conv3x3_rowmajor(dg, wpack, **kw), want)
                ms = cs.graph_ms(lambda: k3.conv3x3_rowmajor(dg, wpack,
                                                             **kw), iters=10)
            finally:
                k3.conv3x3_plan = chosen
            if err > tol:
                raise SystemExit(f"K3 cell{i} {plan}: error {err} over "
                                 f"{tol}")
            rows.append((ms, dataclasses.astuple(plan)))
        rows.sort()
        mine = dataclasses.astuple(chosen(b, hh, ww, 4 * ch, cx + ch,
                                          torch.bfloat16))
        mine_ms = [ms for ms, p in rows if p == mine]
        out[i] = {"chosen": mine, "chosen_ms": mine_ms[0] if mine_ms
                  else None, "best": rows[:top], "plans": len(rows)}
        print(f"K3 sweep cell{i} B={b}: {len(rows)} plans; chosen {mine} "
              f"{out[i]['chosen_ms']} ms; fastest "
              + "; ".join(f"{p} {ms:.4f}" for ms, p in rows[:top]),
              flush=True)
    return out


FWD_HW = (512, 1024)   # the decode bench's input


def _cells(cs, kind):
    """(cell, (H, W, C, Cx)) of the five cells of K1 (the forward at
    512x1024), K4 (the train step at cs.TRAIN_HW) or K8 (the mul decode at
    512x1024, whose cell 0 reads the coarsest skip)."""
    from rsis_tpu_torch.models.decoder import decoder_widths
    widths = decoder_widths(128)
    if kind == "k8":
        for i, (hh, ww, cx, ch) in enumerate(cs.mul_geoms(*FWD_HW, widths)):
            yield i, (hh, ww, ch, cx)
        return
    hw = FWD_HW if kind == "k1" else cs.TRAIN_HW
    for i, ch in enumerate(widths):
        yield i, (hw[0] // 2 ** (5 - i), hw[1] // 2 ** (5 - i), ch,
                  widths[i - 1] if i else 0)


# cell_plan's kind of each kernel
PLAN_KIND = {"k1": "forward", "k4": "backward", "k8": "step"}


def _cell_case(cs, kind, geom, b, gen):
    """Operands of K1, K4 or K8 at one cell (H, W, C, Cx), the kernel and
    its plain version as functions of none, and cuDNN's gate convolution
    alone (``F.conv2d`` of the NCHW concat of x and h_prev: a yardstick for
    the GEMM part, not the cell's function), and the tensors each reads."""
    F = torch.nn.functional
    from rsis_tpu_torch.ops import clstm_step as k8
    from rsis_tpu_torch.ops import fused_cell as fc
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    hh, ww, ch, cx = geom
    if kind == "k8":
        ops = cs.clstm_inputs((hh, ww, cx, ch), b, torch.bfloat16, gen)
        xh = torch.cat(ops[:2], dim=1)
        return (lambda: k8.clstm_step(*ops), lambda: k8.clstm_step_ref(*ops),
                lambda: F.conv2d(xh, ops[3], padding=1), ops)
    ops, cot = cs.bwd_inputs(geom, b, torch.bfloat16, gen)
    kw = {"cx": cx, "ch": ch}
    xh = torch.cat([t.permute(0, 2, 1, 3).contiguous() for t in
                    ([ops[1][:, 1:-1, :, 1:-1]] if cx else []) + [ops[0]]],
                   dim=1)
    wt = ops[4]
    w_conv = torch.cat(
        ([wt[:, :9 * cx].reshape(4 * ch, 3, 3, cx)] if cx else [])
        + [wt[:, 9 * cx:].reshape(4 * ch, 3, 3, ch)], dim=3).permute(
            0, 3, 1, 2).contiguous()

    def gate_conv():
        return F.conv2d(xh, w_conv, padding=1)
    if kind == "k1":
        return (lambda: fc.fused_cell_rowmajor(*ops, **kw),
                lambda: fc.fused_cell_rowmajor_ref(*ops, **kw), gate_conv,
                [t for t in ops if t is not None])
    return (lambda: fcv.cell_backward_dgates(*ops, *cot, **kw),
            lambda: fcv.cell_backward_dgates_ref(*ops, *cot, **kw),
            gate_conv, [t for t in ops if t is not None] + list(cot))


def time_cell(cs, kind: str, b: int, gen) -> list:
    """K1 (kind "k1", forward cells), K4 ("k4", train cells) or K8 ("k8",
    mul cells) per cell: device ms of one launch, its bound, the plain
    version's ms, cuDNN's gate conv alone and the error against the plain
    version."""
    rows = []
    for i, geom in _cells(cs, kind):
        hh, ww, ch, cx = geom
        kern, plain, gate_conv, inputs = _cell_case(cs, kind, geom, b, gen)
        got = kern()
        want = plain()
        err = max(cs.max_err(g, w) / (cs.BF16_ULP
                                      * w.float().abs().max().item())
                  for g, w in zip(got, want))
        ms = cs.graph_ms(kern, iters=20)
        pms = cs.graph_ms(plain, iters=5)
        gms = cs.graph_ms(gate_conv, iters=20)
        n_b = cs.nbytes(*inputs, *got)
        bms, by = cs.bound_ms(n_b,
                              2.0 * 4 * ch * 9 * (cx + ch) * b * hh * ww,
                              torch.bfloat16)
        rows.append({"cell": i, "geom": [hh, ww, ch, cx], "batch": b,
                     "ms": ms, "plain_ms": pms, "gate_conv_ms": gms,
                     "bound_ms": bms, "bound_by": by, "err_ulps": err})
        print(f"{kind.upper()} cell{i} ({hh}, {ww}, {ch}, {cx}) B={b}: "
              f"{ms:.4f} ms (plain {pms:.4f}; cuDNN gate conv {gms:.4f}, "
              f"bound {bms:.4f} by {by}; error {err:.3f} bf16 ulps of the "
              f"max)", flush=True)
    print(f"{kind.upper()} B={b}: {sum(r['ms'] for r in rows):.4f} ms a "
          f"decode step (plain {sum(r['plain_ms'] for r in rows):.4f}; "
          f"cuDNN gate conv {sum(r['gate_conv_ms'] for r in rows):.4f}, "
          f"bound {sum(r['bound_ms'] for r in rows):.4f})", flush=True)
    return rows


def _cell_plans(b, h, w, ch, cx, kind):
    """Every tensor-core plan of K1, K4 or K8 (cell_plan's kind) for one
    cell that the kernel takes and whose shared memory fits: warp tiles,
    4-8 warps, channel tiles, the unit shape of _unit_shape and whole rows
    (tw up to W), chunks, rings, and the most parts where the units leave
    SMs idle (else one wave of groups, at one block an SM and, where
    per_sm allows, two)."""
    import itertools
    from rsis_tpu_torch.ops import fused_cell as fc
    ccs = [c for c in fc.CELL_CHUNKS if ch % c == 0 and cx % c == 0]
    for wm, wj, wpm, wpn, cc, st in itertools.product(
            fc.CELL_WARP_M, fc.CELL_WARP_J, (1, 2, 4, 8), (1, 2, 4, 8), ccs,
            (2, 3)):
        ct = 8 * wj * wpn
        if (not 4 <= wpm * wpn <= 8 or ch % ct or wm * wj > 8
                or (cc == 8 and wj > 2)):
            continue
        px = 16 * wm * wpm
        for tw in sorted({fc._unit_shape(px, h, w)[1],
                          min(px, -(-w // 16) * 16)}):
            rows = px // tw
            if rows > 2 * h:
                continue
            plan = fc.CellPlan(True, wm, wj, wpm, wpn, rows, tw, cc, st)
            units, n_ct = plan.units(b, h, w), ch // ct
            if plan.smem_bytes(ch, cx, kind, w=w) > fc.SMEM_LIMIT:
                continue
            if units * n_ct < fc.SM_COUNT:
                yield dataclasses.replace(
                    plan, groups=units, splits=fc._divisor_at_most(
                        plan.chunks(ch, cx), fc.SM_COUNT // (units * n_ct)))
                continue
            for per_sm in ((1, 2) if plan.two_per_sm(ch, cx, kind, w=w)
                           else (1,)):
                yield dataclasses.replace(plan, per_sm=per_sm, groups=min(
                    units, max(1, per_sm * fc.SM_COUNT // n_ct)))


def sweep_cell(cs, kind: str, b: int, gen, top: int = 5) -> dict:
    """Every tensor-core plan of K1, K4 or K8 at its five cells, timed
    like time_cell and checked against the plain version (one bf16 ulp of
    each output's max); returns each cell's fastest plans beside the one
    cell_plan chooses."""
    from rsis_tpu_torch.ops import clstm_step as k8
    from rsis_tpu_torch.ops import fused_cell as fc
    from rsis_tpu_torch.ops import fused_cell_vjp as fcv
    chosen = fc.cell_plan
    # each wrapper reads cell_plan from its own module's namespace
    modules = (fc, fcv, k8)
    out = {}
    for i, geom in _cells(cs, kind):
        hh, ww, ch, cx = geom
        kern, plain, _, _ = _cell_case(cs, kind, geom, b, gen)
        want = plain()
        rows = []
        for plan in _cell_plans(b, hh, ww, ch, cx, PLAN_KIND[kind]):
            for m in modules:
                m.cell_plan = lambda *a, plan=plan, **k: plan
            try:
                got = kern()
                ms = cs.graph_ms(kern, iters=10)
            finally:
                for m in modules:
                    m.cell_plan = chosen
            for g, w in zip(got, want):
                err = cs.max_err(g, w)
                tol = cs.BF16_ULP * w.float().abs().max().item()
                if err > tol:
                    raise SystemExit(f"{kind.upper()} cell{i} {plan}: "
                                     f"error {err} over {tol}")
            rows.append((ms, dataclasses.astuple(plan)))
        rows.sort()
        mine = dataclasses.astuple(chosen(b, hh, ww, ch, cx, torch.bfloat16,
                                          kind=PLAN_KIND[kind]))
        mine_ms = [ms for ms, p in rows if p == mine]
        out[i] = {"chosen": mine, "chosen_ms": mine_ms[0] if mine_ms
                  else None, "best": rows[:top], "plans": len(rows)}
        print(f"{kind.upper()} sweep cell{i} B={b}: {len(rows)} plans; "
              f"chosen {mine} {out[i]['chosen_ms']} ms; fastest "
              + "; ".join(f"{p} {ms:.4f}" for ms, p in rows[:top]),
              flush=True)
    return out


# (B, H, C, W) of K2 at the head of the 512x1024 forward (B=32 and 4) and
# of the 256x512 train step (B=32), hidden 128
K2_SHAPES = [(32, 256, 8, 512), (4, 256, 8, 512), (32, 128, 8, 256)]


def _k2_cases(cs, shape, gen, dtype=torch.bfloat16):
    """(layout, operands, kernel, plain version) of each K2 wrapper this
    tree has."""
    from rsis_tpu_torch.ops import mask_head as mh
    hs, weight, bias = cs.head_inputs(shape, dtype, gen)
    yield ("rowmajor", (hs, weight, bias), mh.mask_head_fused_kernel,
           mh.mask_head_ref)
    if hasattr(mh, "mask_head_nchw_kernel"):
        yield ("nchw", (hs.transpose(1, 2).contiguous(), weight, bias),
               mh.mask_head_nchw_kernel, mh.mask_head_nchw_ref)


def _ulps(cs, got, want) -> float:
    return cs.max_err(got, want) / (cs.BF16_ULP
                                    * want.float().abs().max().item())


def time_k2(cs, shape, gen, dtype=torch.bfloat16) -> dict:
    """K2 at one head shape in each layout: device ms of one launch, the
    plain version's, the bound, the two-call yardstick and the error in
    bf16 ulps of the max."""
    F = torch.nn.functional
    bms, by = (cs.head_bound(shape, dtype)
               if hasattr(cs, "head_bound") else (None, None))
    out = {"shape": list(shape), "dtype": str(dtype), "bound_ms": bms,
           "bound_by": by}
    for layout, ops, kern, plain in _k2_cases(cs, shape, gen, dtype):
        err = _ulps(cs, kern(*ops), plain(*ops))
        ms = cs.graph_ms(lambda: kern(*ops), iters=20)
        pms = cs.graph_ms(lambda: plain(*ops), iters=5)
        out[layout] = {"ms": ms, "plain_ms": pms, "err_ulps": err}
        print(f"K2 {shape} {layout} {dtype}: {ms:.4f} ms (plain "
              f"{pms:.4f}, bound {bms}; error {err:.3f} bf16 ulps of the "
              f"max)", flush=True)
        if layout == "rowmajor":
            hs, weight, bias = ops
            ht = hs.transpose(1, 2).contiguous()
            wt, bt = weight.to(hs.dtype), bias.to(hs.dtype)
            out["library_ms"] = cs.graph_ms(lambda: F.conv2d(F.interpolate(
                ht, scale_factor=2, mode="bilinear", align_corners=True),
                wt, bt, padding=1), iters=20)
            print(f"K2 {shape}: interpolate + conv2d (two calls, a "
                  f"yardstick) {out['library_ms']:.4f} ms", flush=True)
    return out


def sweep_k2(cs, shape, gen, top: int = 5) -> dict:
    """Every plan of K2 (columns a thread, rows a block, warps) at one head
    shape in each layout, timed like time_k2 and checked against the plain
    version (one bf16 ulp of the max); returns each layout's fastest plans
    beside the one mask_head_plan chooses."""
    import itertools
    from rsis_tpu_torch.ops import mask_head as mh
    b, h, c, w = shape
    chosen = mh.mask_head_plan
    out = {}
    for layout, ops, kern, plain in _k2_cases(cs, shape, gen):
        strides = tuple(ops[0].stride()[:3]) if layout == "nchw" else (
            h * c * w, w, c * w)
        widest = mh.head_vector(w, ops[0].dtype, strides)
        want = plain(*ops)
        rows = []
        for v, r, warps in itertools.product(mh.HEAD_VECTORS, mh.HEAD_ROWS,
                                             (1, 2, 4, 8)):
            if v > widest or r > h or (warps > 1 and 32 * (warps // 2) * v
                                       >= w):
                continue
            plan = mh.MaskHeadPlan(v, r, warps)
            mh.mask_head_plan = lambda *a, plan=plan, **k: plan
            try:
                got = kern(*ops)
                ms = cs.graph_ms(lambda: kern(*ops), iters=10)
            finally:
                mh.mask_head_plan = chosen
            if _ulps(cs, got, want) > 1:
                raise SystemExit(f"K2 {shape} {layout} {plan}: error "
                                 f"{_ulps(cs, got, want)} bf16 ulps")
            rows.append((ms, (v, r, warps)))
        rows.sort()
        p = chosen(b, h, c, w, ops[0].dtype, strides)
        mine = (p.v, p.rows, p.warps)
        mine_ms = [ms for ms, q in rows if q == mine]
        out[layout] = {"chosen": mine, "chosen_ms": mine_ms[0] if mine_ms
                       else None, "best": rows[:top], "plans": len(rows)}
        print(f"K2 sweep {shape} {layout}: {len(rows)} plans (v, rows, "
              f"warps); chosen {mine} {out[layout]['chosen_ms']} ms; "
              "fastest " + "; ".join(f"{q} {ms:.4f}" for ms, q in
                                     rows[:top]), flush=True)
    return out


# K6 at the train step's matcher shapes (B, T predictions, N GT slots)
# and K7's batches at 256x512 (bf16, the bench's ranges)
K6_SHAPES = [(32, 20, 20), (8, 5, 20)]
K7_BATCHES = [32, 8]


def time_k6(cs, shape, gen) -> dict:
    """K6 at one matcher shape on the tie-heavy loss-like costs of
    ``lap_cases``: device ms of one launch on contiguous costs, and of the
    tree's ``hungarian`` on (B, N, T) costs as the train step holds them
    (the transposed view: with the contiguous copy that the tree makes, if
    any, and the perm); the Dijkstra steps of the longest problem and ns a
    step; row4col against the plain version."""
    from rsis_tpu_torch.ops import lap
    from rsis_tpu_torch.ops.matching import hungarian
    b, t, n = shape
    costs = [c for name, c in cs.lap_cases(gen, b, ((t, n),))
             if name.startswith("ties")][0]
    steps = []
    for i in range(b):
        stats = {}
        lap.solve_lap_batch_ref(costs[i:i + 1], stats)
        steps.append(stats["scans"])
    same = torch.equal(lap.solve_lap_batch(costs),
                       lap.solve_lap_batch_ref(costs))
    ms = cs.graph_ms(lambda: lap.solve_lap_batch(costs), iters=20)
    bnt = costs.transpose(1, 2).contiguous()
    matcher_ms = cs.graph_ms(lambda: hungarian(bnt), iters=20)
    out = {"shape": list(shape), "ms": ms, "matcher_ms": matcher_ms,
           "scans": sum(steps), "max_scans": max(steps),
           "ns_per_step": ms * 1e6 / max(steps), "row4col_equal": same}
    print(f"K6 {shape}: {ms:.4f} ms, matcher {matcher_ms:.4f} ms; "
          f"{sum(steps)} Dijkstra steps, {max(steps)} in the longest "
          f"problem: {out['ns_per_step']:.1f} ns a step; row4col "
          f"{'equal to' if same else 'DIFFERS from'} the plain version's",
          flush=True)
    return out


def time_k7(cs, b: int, gen) -> dict:
    """K7 at 256x512, bf16, the bench's ranges (chip_smoke.time_warp): ms,
    plain, bound and its share, the two torch.gather calls, the
    augmentation block; the plan where the tree has ``warp_plan``."""
    from rsis_tpu_torch.ops import warp
    out = cs.time_warp(b, gen)
    out["share"] = out["bound_ms"] / out["ms"]
    if hasattr(warp, "warp_plan"):
        out["plan"] = str(warp.warp_plan(cs.TRAIN_HW[1], 3, 2))
    print(f"K7 B={b}: {out['ms']:.4f} ms, {100 * out['share']:.1f}% of "
          f"the bound {out['bound_ms']:.4f}; plan {out.get('plan')}",
          flush=True)
    return out


def time_upsample(cs, b: int, gen) -> dict:
    """The forward's four inter-cell upsamples at B = b, checked and timed
    by the tree's chip_smoke.py."""
    from rsis_tpu_torch.models.decoder import decoder_widths
    geoms = [(512 // 2 ** (5 - i), 1024 // 2 ** (5 - i), ch, 0)
             for i, ch in enumerate(decoder_widths(128))]
    shapes = cs.upsample_shapes(geoms, b)
    return {"checked": cs.check_upsample(shapes, gen),
            **cs.time_upsample(shapes, gen)}


def time_mul(cs, args) -> dict:
    """The mul-skip forward at --batch, --steps (chip_smoke's phase 3b:
    resnet101, hidden 128, 512x1024, bf16, every cell one K8 launch,
    the outputs held against the plain path): ms a forward by CUDA events
    around whole calls, and images per second."""
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    xs = [torch.randn(args.batch, *FWD_HW, 3, generator=gen, device="cuda")]
    out = cs.mul_forward_phase(argparse.Namespace(
        steps=args.steps, seed=args.seed, profile=args.profile), xs)
    return {"batch": args.batch, "steps": args.steps,
            "forward_ms": out["forward_ms"],
            "images_per_s": out["images_per_s"], "profile": out["profile"]}


def time_step(cs, args) -> dict:
    import numpy as np
    from rsis_tpu_torch.data.synthetic import synthetic_wire_batch
    from rsis_tpu_torch.train import step as ts
    b, T = args.batch, args.steps
    cfg = cs.train_config(b, T)
    weights = cs.fresh_weights(cfg, args.seed)
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
        # its second pass, the anonymous namespace's reduce_kernel; K1's
        # and K4's by their epilogues' names (either main loop)
        groups = {
            "k1": {k: v for k, v in kernels.items() if "LstmForward" in k},
            "k4": {k: v for k, v in kernels.items() if "LstmBackward" in k},
            "k5": {k: v for k, v in kernels.items()
                   if "dwt_" in k or "namespace)::reduce_kernel" in k},
            "k3": {k: v for k, v in kernels.items() if "conv_mma_kernel" in k
                   or "conv_reduce_kernel" in k or "conv_fma_kernel" in k},
            "k6": {k: v for k, v in kernels.items() if "lap_kernel" in k},
            "k7": {k: v for k, v in kernels.items()
                   if "warp_kernel" in k or "warp_segment_kernel" in k
                   or "warp_pixel_kernel" in k},
            "direct_copy": {k: v for k, v in kernels.items()
                            if "direct_copy" in k}}
        out["profile"] = {"wall_ms": wall_ms, "busy_ms": busy}
        print(f"profiled step: kernels' device ms summed {busy:.3f}, "
              f"{wall_ms:.3f} ms wall", flush=True)
        for name, group in groups.items():
            out["profile"][name] = {k: list(v) for k, v in group.items()}
            out[f"{name}_device_ms"] = sum(ms for _, ms in group.values())
            out[f"{name}_calls"] = sum(n for n, _ in group.values())
            out[f"{name}_share"] = out[f"{name}_device_ms"] / busy
            print(f"  {name}: {out[f'{name}_device_ms']:.3f} ms "
                  f"({out[f'{name}_share']:.3f}), {out[f'{name}_calls']} "
                  f"calls, in " + ", ".join(
                      f"{_short(k)} x{n} {ms:.3f}"
                      for k, (n, ms) in group.items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1", action="store_true")
    ap.add_argument("--k4", action="store_true")
    ap.add_argument("--k8", action="store_true")
    ap.add_argument("--cell-sweep", nargs="*", choices=("k1", "k4", "k8"),
                    default=None,
                    help="time every tensor-core plan of the named kernels "
                    "(all without a name) per cell: K1 and K8 at each "
                    "--k1-batch, K4 at each --k4-batch")
    ap.add_argument("--k1-batch", type=int, nargs="+", default=[32, 4])
    ap.add_argument("--k4-batch", type=int, nargs="+", default=[32, 8])
    ap.add_argument("--k5", action="store_true")
    ap.add_argument("--k5-batch", type=int, nargs="+", default=[32, 8])
    ap.add_argument("--sweep", action="store_true",
                    help="time every tensor-core plan of K5 per cell at "
                    "each --k5-batch")
    ap.add_argument("--fma-sweep", action="store_true",
                    help="time the FMA loop's plans of K5 per cell at the "
                    "Pascal recipe's geometry (fp32, B=28)")
    ap.add_argument("--k3", action="store_true")
    ap.add_argument("--k3-sweep", action="store_true",
                    help="time every tensor-core plan of K3 per cell at "
                    "each --k5-batch")
    ap.add_argument("--k2", action="store_true")
    ap.add_argument("--k2-sweep", action="store_true",
                    help="time every plan of K2 at each head shape")
    ap.add_argument("--k6", action="store_true")
    ap.add_argument("--k7", action="store_true")
    ap.add_argument("--upsample", action="store_true")
    ap.add_argument("--mul", action="store_true")
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
    if args.k1:
        result["k1"] = {b: time_cell(cs, "k1", b, gen) for b in args.k1_batch}
    if args.k4:
        result["k4"] = {b: time_cell(cs, "k4", b, gen) for b in args.k4_batch}
    if args.k8:
        result["k8"] = {b: time_cell(cs, "k8", b, gen)
                        for b in args.k1_batch}
    if args.cell_sweep is not None:
        result["cell_sweep"] = {
            kind: {b: sweep_cell(cs, kind, b, gen) for b in (
                args.k4_batch if kind == "k4" else args.k1_batch)}
            for kind in args.cell_sweep or ("k1", "k4", "k8")}
    if args.k5:
        result["k5"] = {b: time_k5(cs, b, gen) for b in args.k5_batch}
        result["k5_fp32"] = time_k5(cs, cs.PASCAL_BATCH, gen, cs.PASCAL_HW,
                                    torch.float32)
        result["k5_leaves"] = {b: time_k5(cs, b, gen, cs.LEAVES_HW)
                               for b in (2, cs.LEAVES_BATCH)}
    if args.sweep:
        result["sweep"] = {b: sweep_k5(cs, b, gen) for b in args.k5_batch}
    if args.fma_sweep:
        result["fma_sweep"] = sweep_k5_fma(cs, cs.PASCAL_BATCH, gen,
                                           cs.PASCAL_HW, torch.float32)
        result["fma_sweep_leaves"] = sweep_k5_fma(
            cs, cs.LEAVES_BATCH, gen, cs.LEAVES_HW, torch.bfloat16)
    if args.k3:
        result["k3"] = {b: time_k3(cs, b, gen) for b in args.k5_batch}
    if args.k3_sweep:
        result["k3_sweep"] = {b: sweep_k3(cs, b, gen)
                              for b in args.k5_batch}
    if args.k2:
        result["k2"] = [time_k2(cs, shape, gen) for shape in K2_SHAPES] + [
            time_k2(cs, K2_SHAPES[0], gen, torch.float32)]
    if args.k2_sweep:
        result["k2_sweep"] = {str(shape): sweep_k2(cs, shape, gen)
                              for shape in K2_SHAPES}
    if args.k6:
        result["k6"] = [time_k6(cs, shape, gen) for shape in K6_SHAPES]
    if args.k7:
        result["k7"] = {b: time_k7(cs, b, gen) for b in K7_BATCHES}
    if args.upsample:
        result["upsample"] = {b: time_upsample(cs, b, gen)
                              for b in args.k1_batch}
    if args.mul:
        result["mul"] = time_mul(cs, args)
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
