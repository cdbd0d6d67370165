"""Training monitor: one JSON line of metrics per logged step.

Counterpart of ``rsis_tpu/utils/monitor.py::Monitor`` (``log``, ``close``):
``metrics.jsonl`` in the model directory, appended to, one object per
train or val batch with the same keys (``t`` seconds since the monitor
opened, ``split``, ``epoch``, ``batch``, ``total``, ``iou``, ``stop``,
``class`` and any extra keyword such as ``T``). The mask snapshots, visdom
and the dashboard are not in the port yet (the train loop raises on
``--visdom``).
"""

from __future__ import annotations

import json
import os
import time


class Monitor:
    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        self._fp = open(os.path.join(model_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, split: str, epoch: int, batch: int, total: float,
            iou: float, stop: float, cls: float, **extra) -> None:
        rec = {"t": round(time.time() - self._t0, 3), "split": split,
               "epoch": epoch, "batch": batch,
               "total": float(total), "iou": float(iou),
               "stop": float(stop), "class": float(cls)}
        rec.update(extra)
        self._fp.write(json.dumps(rec) + "\n")
        self._fp.flush()

    def close(self) -> None:
        self._fp.close()
