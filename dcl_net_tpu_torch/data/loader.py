"""Host-side batch loader with background prefetch.

Counterpart of dcl_net_tpu/data/loader.py::BatchLoader with thread workers:
a thread pool maps dataset.__getitem__, the samples are stacked into
fixed-shape batches (schema.make_batch, padded to the batch size), and a
producer thread keeps up to PREFETCH batches ready in a bounded queue.
Batches are dicts of numpy arrays; the consumer moves them to the device.
The process pool, multi-host blocks, the collate/batch_transform hooks and
samples_per_item are not ported yet.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from dcl_net_tpu_torch.data.schema import make_batch

PREFETCH = 4  # batches the producer keeps ready


class BatchLoader:
    """Shuffling, dropping-last batch iterator over a map-style dataset.

    The shuffle of epoch e is seeded by seed + e; skip_next > 0 makes the
    next iteration skip that many leading batches (a mid-epoch resume
    replays exactly the batches not yet consumed) and is then reset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8, seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(int(num_workers), 1)
        self.seed = int(seed)
        self.epoch = 0
        self.skip_next = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator:
        idx = self._indices()
        bs = self.batch_size
        batches = [idx[i * bs:(i + 1) * bs] for i in range(len(self))]
        if self.skip_next:
            batches = batches[self.skip_next:]
            self.skip_next = 0
        self.epoch += 1

        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has gone, so an
            # abandoned iterator does not pin this thread on a full queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, b))
                        if not put(make_batch(samples, pad_to=bs).to_dict()):
                            return
                put(None)
            except BaseException as exc:  # re-raised in the consumer
                put(exc)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
