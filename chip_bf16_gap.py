#!/usr/bin/env python3
"""Where the bf16 train step's gradients part from the plain path's, on one
GPU.

``chip_smoke.py`` holds the bf16 train step (kernels) against the same
step through the kernels' plain versions, gradient by gradient, in bf16
ulps of each tensor's largest magnitude. This script takes that
comparison apart at one geometry (by default the train bench's: B=32,
T=20, 256x512, resnet101, hidden 128, device augmentation on, the weights
and batch of ``chip_smoke.py`` at --seed):

- the two bf16 paths' matcher inputs and assignments (are the same GT
  slots matched to the same steps?) and their losses;
- the worst gradient of the decoder group, and cell 0's gate weight split
  into its skip part (the hoisted S-term convolution) and its hidden part
  (the packed weight of the cell kernels);
- both bf16 paths and the fp32 kernel path against the fp32 plain path,
  in bf16 ulps of the fp32 gradient's largest magnitude.

Usage: python3 chip_bf16_gap.py [--batch 32] [--steps 20] [--seed 0]
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_bf16_gap: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import chip_smoke as cs
    from rsis_tpu_torch.data.synthetic import synthetic_wire_batch
    from rsis_tpu_torch.models.rsis import build_models
    from rsis_tpu_torch.train import step as ts
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

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
    ref_loss, _, ref = runs[("float32", True)]
    print(f"bf16 matcher: costs max |kernel - plain| "
          f"{(ck - cp).abs().max().item():.3e}; assignments equal "
          f"{torch.equal(pk, pp)} ({(pk != pp).sum().item()} entries "
          f"differ); loss kernel {lk:.7f} plain {lp:.7f} (relative "
          f"{abs(lk - lp) / abs(lp):.3e})")
    key = "decoder.clstm_list.0.Gates.weight"
    skip = cfg.hidden_size     # cell 0's input: the x5 skip, then h

    def ulps(got, want, k, cols=slice(None)):
        unit = cs.BF16_ULP * want[k].abs().max().item()
        return (got[k][:, cols] - want[k][:, cols]).abs().max().item() / unit

    top = max(g.abs().max().item() for g in gp.values())
    worst = max(
        ((gk[k] - gp[k]).abs().max().item()
         / (cs.BF16_ULP * max(gp[k].abs().max().item(), 1e-3 * top)), k)
        for k in gp if not k.startswith("encoder.base."))
    print(f"bf16 kernel vs bf16 plain: decoder group worst {worst[0]:.3f} "
          f"ulps at {worst[1]}; {key}: {ulps(gk, gp, key):.3f} (skip part "
          f"{ulps(gk, gp, key, slice(0, skip)):.3f}, hidden part "
          f"{ulps(gk, gp, key, slice(skip, None)):.3f})")
    top = max(g.abs().max().item() for g in ref.values())
    for name, (loss, _, g) in (("bf16 kernel", runs[("bfloat16", False)]),
                               ("bf16 plain", runs[("bfloat16", True)]),
                               ("fp32 kernel", runs[("float32", False)])):
        worst = max(((g[k] - ref[k]).abs().max().item()
                     / (cs.BF16_ULP * max(ref[k].abs().max().item(),
                                          1e-3 * top)), k) for k in ref)
        print(f"{name} vs fp32 plain: loss relative "
              f"{abs(loss - ref_loss) / abs(ref_loss):.3e}; worst "
              f"{worst[0]:.3f} ulps at {worst[1]}; {key}: "
              f"{ulps(g, ref, key):.3f} (skip part "
              f"{ulps(g, ref, key, slice(0, skip)):.3f}, hidden part "
              f"{ulps(g, ref, key, slice(skip, None)):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
