#!/usr/bin/env python3
"""Where the bf16 train step's gradients part from the fp32 path's, on one
GPU.

``chip_smoke.py`` holds the bf16 train step (kernels) against the same
step through the kernels' plain versions and against the fp32 plain path
(``step_grad_rows``, ``step_grad_verdict``), gradient by gradient, in
bf16 ulps of each tensor's scale. This script takes that comparison apart
at one geometry (by default the train bench's: B=32, T=20, 256x512,
resnet101, hidden 128, device augmentation on, the weights and batch of
``chip_smoke.py`` at --seed):

- the matcher inputs and assignments of the two bf16 paths, and of the
  fp32 path against the plain bf16 one (are the same GT slots matched to
  the same steps?), and the three losses;
- for every tensor of the decoder group (and the worst of the backbone),
  the three distances kernel bf16 - fp32, plain bf16 - fp32 and kernel
  bf16 - plain bf16, and the verdict of chip_smoke's rule;
- cell 0's gate weight split into its skip part (the hoisted S-term
  convolution) and its hidden part (the packed weight of the cell
  kernels);
- the fp32 kernel path against the fp32 plain path.

Usage: python3 chip_bf16_gap.py [--batch 32] [--steps 20] [--seed 0]
                                [--out FILE]
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the distances as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_bf16_gap: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import chip_smoke as cs
    from rsis_tpu_torch.data.synthetic import synthetic_wire_batch
    from rsis_tpu_torch.train import step as ts
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    b, T = args.batch, args.steps
    cfg = cs.train_config(b, T)
    weights = cs.fresh_weights(cfg, args.seed)
    img, tgt = synthetic_wire_batch(np.random.default_rng(args.seed), b,
                                    *cs.TRAIN_HW, cfg.gt_maxseqlen,
                                    cfg.num_classes)
    batch = (torch.from_numpy(img).cuda(), torch.from_numpy(tgt).cuda())
    flags = ts.StepFlags(use_class_loss=1.0, use_stop_loss=1.0,
                         update_encoder=1.0)
    solve = ts.hungarian
    runs = {}
    for dtype in ("bfloat16", "float32"):
        for plain in (False, True):
            seen = []

            def record(costs, plain=False, seen=seen):
                seen.append(costs.clone())
                perm = solve(costs, plain=plain)
                seen.append(perm)
                return perm

            ts.hungarian = record
            try:
                c = cfg.replace(compute_dtype=dtype)
                state = ts.create_train_state(c, weights)
                total, _, grads = ts.loss_and_grads(
                    c, state, batch, flags, T, plain=plain,
                    rng=cs.cuda_generator(args.seed + 1))
            finally:
                ts.hungarian = solve
            runs[(dtype, plain)] = (total.item(), seen, {
                k: g.float().cpu() for k, g in grads.items()})
            del state, grads
            torch.cuda.empty_cache()

    card = cs.card_line()
    print(f"card: {card}; B={b}, T={T}, 256x512, bf16, augmentation on")
    (lk, (ck, pk), gk) = runs[("bfloat16", False)]
    (lp, (cp, pp), gp) = runs[("bfloat16", True)]
    lf, (cf, pf_), gf = runs[("float32", True)]
    print(f"bf16 matcher: costs max |kernel - plain| "
          f"{(ck - cp).abs().max().item():.3e}; assignments equal "
          f"{torch.equal(pk, pp)} ({(pk != pp).sum().item()} entries "
          f"differ); loss kernel {lk:.7f} plain {lp:.7f} fp32 {lf:.7f}")
    print(f"fp32 matcher against bf16 plain: costs max difference "
          f"{(cf - cp).abs().max().item():.3e}; assignments equal "
          f"{torch.equal(pf_, pp)} ({(pf_ != pp).sum().item()} entries "
          f"differ)")
    rows = cs.step_grad_rows(gk, gp, gf)
    print("distances in bf16 ulps of each tensor's scale (chip_smoke."
          "step_grad_rows): kernel-fp32, plain-fp32, kernel-plain; the "
          "verdict of step_grad_verdict at the group's limit")
    worst_backbone = max((r["kp"], k) for k, r in rows.items()
                         if r["group"] == "backbone")
    for k, r in rows.items():
        limit = cs.STEP_GRAD_BF16_ULPS[r["group"]]
        ok, dist, lim, against = cs.step_grad_verdict(r, limit)
        r.update(ok=ok, held=against, bound=lim)
        if r["group"] == "decoder" or k == worst_backbone[1]:
            print(f"  {k:48s} {r['kf']:9.3f} {r['pf']:9.3f} "
                  f"{r['kp']:7.3f}  {'ok' if ok else 'FAIL'} against "
                  f"{against} ({dist:.3f} <= {lim:.3f})")
    key = "decoder.clstm_list.0.Gates.weight"
    skip = cfg.hidden_size     # cell 0's input: the x5 skip, then h
    parts = {}
    for part, cols in (("skip", slice(0, skip)),
                       ("hidden", slice(skip, None))):
        sub = {n: {key: g[key][:, cols]} for n, g in
               (("k", gk), ("p", gp), ("f", gf))}
        parts[part] = cs.step_grad_rows(sub["k"], sub["p"], sub["f"])[key]
        r = parts[part]
        print(f"  {key} {part} part: kernel-fp32 {r['kf']:.3f}, "
              f"plain-fp32 {r['pf']:.3f}, kernel-plain {r['kp']:.3f} "
              f"(ulps of the part's own scale)")
    l32, _, g32 = runs[("float32", False)]
    fp32 = cs.step_grad_rows(g32, gf, ulp=1e-3)
    worst = max((r["kp"], k) for k, r in fp32.items())
    print(f"fp32 kernel vs fp32 plain: loss relative "
          f"{abs(l32 - lf) / abs(lf):.3e}; worst {worst[0]:.4f} x 1e-3 of "
          f"the scale at {worst[1]}")
    failed = [k for k, r in rows.items() if not r["ok"]]
    print(f"rule: {len(rows) - len(failed)} of {len(rows)} tensors pass; "
          f"failing: {failed}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "batch": b, "steps": T,
                       "loss": {"kernel": lk, "plain": lp, "fp32": lf},
                       "rows": rows, "cell0_parts": parts,
                       "fp32_kernel_worst": worst}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
