"""Host data pipeline: shuffled, batched, prefetched numpy batches.

Counterpart of ``rsis_tpu/data/pipeline.py::DataLoader``: the same seeded
epoch order (one numpy generator shuffles every epoch), ``drop_last``, a
thread pool that maps the dataset's ``__getitem__`` (numpy work releases
the GIL), and a bounded queue that keeps the next batches ready while the
device runs the current step. Batches are (images uint8 (B, H, W, 3),
targets uint8 (B, N, H*W + 3)) numpy arrays; the train loop copies them to
the device (``train/loop.py``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._epoch_rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._epoch_rng.shuffle(idx)
        for b in range(len(self)):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if len(chunk) == 0:
                return
            yield chunk

    @staticmethod
    def _collate(samples) -> Tuple[np.ndarray, np.ndarray]:
        return (np.stack([s[0] for s in samples]),
                np.stack([s[1] for s in samples]))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Queue item unless the consumer has gone; False then."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk in self._batch_indices():
                        samples = list(pool.map(self.dataset.__getitem__,
                                                chunk))
                        if not put(self._collate(samples)):
                            return
            except Exception as e:  # surface worker errors to the consumer
                put(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early (an exception, a break) ends the
            # producer instead of leaving it blocked on a full queue
            stop.set()
            t.join(timeout=10)
