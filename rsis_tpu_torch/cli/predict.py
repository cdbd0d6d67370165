"""Generic prediction CLI: a checkpoint + arbitrary images -> instances.

Counterpart of ``rsis_tpu/cli/predict.py`` (``list_images``,
``predict_images``, ``write_outputs``, ``main``). The reference reaches
its inference only through the dataset-bound eval scripts; this runs the
same forward on any file, directory or glob, applies the reference's keep
rules (stop score > stop_th, mask > mask_th after the native-size zoom,
the min-size filter) and writes per-image results:

  <stem>_instances.png   indexed label image (0 = background, k = k-th
                         kept instance, in decode order)
  predictions.json       COCO-style list: image id, category id/name,
                         RLE segmentation (the native library), bbox,
                         score = class_prob * stop_score

Usage:
  python -m rsis_tpu_torch.cli.predict -model_name mymodel \
      -predict_input /path/to/images -predict_output /tmp/out \
      [-predict_format png|coco|both] [-stop_th .5] [-mask_th .5]

The network input geometry follows the dataset conventions the model was
trained with: square imsize x imsize when the saved config has
``resize`` set (pascal/CVPPP recipes), imsize x 2*imsize otherwise (the
cityscapes aspect). Outputs are resized back to each image's native
size.

Deliberate divergence from the evaluator: the class label here is
``argmax over foreground classes only`` (index 0 = <eos> is excluded),
so every kept instance gets a usable label — the reference/evaluator
convention (np.argmax over ALL classes, reference: src/eval.py:272) can
label an instance <eos>, which the dataset-bound eval path then handles
via class_th/max_class machinery this generic CLI doesn't have.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from ..config import Config, config_from_args
from ..data.base import IMAGENET_MEAN, IMAGENET_STD
from ..device import resolve_device
from ..evals.evaluator import resize_mask
from ..evals.forward import HostForward
from ..kernels import mask as maskUtils
from ..train.checkpoint import model_dir
from .eval import exact_fp32, load_eval_variables

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def list_images(spec: str) -> list[str]:
    """Image files from a file path, a directory, or a glob pattern."""
    if os.path.isfile(spec):
        return [spec]
    if os.path.isdir(spec):
        return sorted(
            os.path.join(spec, f) for f in os.listdir(spec)
            if f.lower().endswith(IMAGE_EXTS))
    return sorted(f for f in glob.glob(spec)
                  if f.lower().endswith(IMAGE_EXTS))


def _network_hw(cfg: Config) -> tuple[int, int]:
    return ((cfg.imsize, cfg.imsize) if cfg.resize
            else (cfg.imsize, 2 * cfg.imsize))


def predict_images(cfg: Config, variables, paths: list[str],
                   class_names: list[str] | None = None,
                   forward: HostForward | None = None) -> list[dict]:
    """Run the forward (default: a ``HostForward`` on cuda) over image
    files; returns per-image dicts {path, height, width, instances: [{t,
    class_id, class_name, score, rle, bbox}]}. Masks travel as RLE only —
    native-size uint8 masks are decoded on demand in write_outputs so a
    large input directory doesn't accumulate gigabytes of host memory."""
    from PIL import Image

    h, w = _network_hw(cfg)
    fwd = forward or HostForward(cfg)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    results = []
    bs = max(cfg.batch_size, 1)
    for lo in range(0, len(paths), bs):
        chunk = paths[lo:lo + bs]
        native, batch = [], []
        for p in chunk:
            im = Image.open(p).convert("RGB")
            native.append((im.height, im.width))
            x = np.asarray(im.resize((w, h), Image.BILINEAR), np.float32)
            batch.append((x / 255.0 - mean) / std)
        x = np.stack(batch)
        masks, clss, stops = fwd(variables, x)
        for s, p in enumerate(chunk):
            nh, nw = native[s]
            instances = []
            for t in range(masks.shape[1]):
                if float(stops[s, t, 0]) < cfg.stop_th:
                    continue
                rle, is_valid, _ = resize_mask(
                    cfg, masks[s, t].reshape(h, w), nh, nw)
                if not is_valid:
                    continue
                class_id = int(np.argmax(clss[s, t, 1:])) + 1  # skip <eos>
                score = float(clss[s, t, class_id]) * float(stops[s, t, 0])
                instances.append({
                    "t": t, "class_id": class_id,
                    "class_name": (class_names[class_id]
                                   if class_names else str(class_id)),
                    "score": score, "rle": rle,
                    "bbox": [float(v) for v in maskUtils.toBbox(rle)]})
            results.append({"path": p, "height": nh, "width": nw,
                            "instances": instances})
    return results


def write_outputs(cfg: Config, results: list[dict], out_dir: str) -> dict:
    """Write label PNGs and/or predictions.json per cfg.predict_format."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    coco = []
    written = {"png": [], "json": None}
    for res in results:
        stem = os.path.splitext(os.path.basename(res["path"]))[0]
        if cfg.predict_format in ("png", "both"):
            label = np.zeros((res["height"], res["width"]), np.uint8)
            for k, inst in enumerate(res["instances"], start=1):
                label[maskUtils.decode(inst["rle"]) > 0] = k
            out_png = os.path.join(out_dir, f"{stem}_instances.png")
            Image.fromarray(label, mode="L").save(out_png)
            written["png"].append(out_png)
        for inst in res["instances"]:
            rle = inst["rle"]
            counts = rle["counts"]
            if isinstance(counts, bytes):
                rle = {"size": rle["size"],
                       "counts": counts.decode("ascii")}
            coco.append({"image_id": stem,
                         "category_id": inst["class_id"],
                         "category_name": inst["class_name"],
                         "segmentation": rle, "bbox": inst["bbox"],
                         "score": inst["score"]})
    if cfg.predict_format in ("coco", "both"):
        out_json = os.path.join(out_dir, "predictions.json")
        with open(out_json, "w") as fp:
            json.dump(coco, fp)
        written["json"] = out_json
    return written


def main(argv=None, device=None):
    """Returns {"images", "forward_s", "written" (write_outputs' dict),
    "instances"}. The run is on the CUDA device unless the caller passes
    another device; without a card it raises."""
    device = resolve_device(device, "cli.predict")
    exact_fp32()
    cfg = config_from_args(argv)
    if not cfg.predict_input:
        raise SystemExit("predict: -predict_input is required "
                         "(file, directory, or glob)")
    model_cfg, variables = load_eval_variables(cfg)
    paths = list_images(cfg.predict_input)
    if not paths:
        raise SystemExit(f"predict: no images match {cfg.predict_input!r}")
    out_dir = cfg.predict_output or os.path.join(model_dir(cfg),
                                                 "predictions")
    print(f"predicting {len(paths)} images "
          f"(T={model_cfg.maxseqlen}, input {_network_hw(model_cfg)})")
    forward = HostForward(model_cfg, device=device)
    results = predict_images(model_cfg, variables, paths, forward=forward)
    written = write_outputs(model_cfg, results, out_dir)
    n_inst = sum(len(r["instances"]) for r in results)
    print(f"wrote {len(written['png'])} label images"
          + (f" and {written['json']}" if written["json"] else "")
          + f" ({n_inst} instances) to {out_dir}")
    return {"images": forward.images, "forward_s": forward.seconds,
            "written": written, "instances": n_inst}


if __name__ == "__main__":
    main()
