"""Host-side batch loaders with background prefetch.

Counterparts of dcl_net_tpu/data/loader.py's BatchLoader and
EvalFrameLoader with thread workers. BatchLoader: a thread pool maps
dataset.__getitem__, the samples are stacked into fixed-shape batches
(schema.make_batch, padded to the batch size), and a producer thread keeps
up to PREFETCH batches ready in a bounded queue. EvalFrameLoader flattens
a frame-style eval dataset (YCB-V test) into padded instance batches.
Batches are dicts of numpy arrays; the consumer moves them to the device.
The process pool, multi-host blocks, the collate/batch_transform hooks and
samples_per_item are not ported yet.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List

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


class EvalFrameLoader:
    """Flatten a frame-style eval dataset (__getitem__ -> {"samples",
    "lost", ...}, as YCBVTestDataset) into fixed-size padded instance
    batches, in frame order: each frame's detected samples, then its lost
    detections as valid=0 rows carrying their true labels; the last batch
    is filled with pad=1 rows (schema.make_batch).

    Frames are read by a pool of num_workers threads with a bounded
    look-ahead of max(2 * num_workers, 4) frames, so the host never holds
    more than that many decoded frames ahead of the consumer. Thread
    workers only: worker_type "process", collate and batch_transform raise
    (not ported yet)."""

    def __init__(self, dataset, batch_size: int = 16, num_workers: int = 8,
                 worker_type: str = "thread", collate=None, batch_transform=None):
        if worker_type != "thread":
            raise NotImplementedError(
                f"worker_type {worker_type!r}: the port's loaders run thread workers only")
        if collate is not None or batch_transform is not None:
            raise NotImplementedError("collate / batch_transform hooks: not ported yet")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.num_workers = max(int(num_workers), 1)

    def _frames(self):
        window = max(2 * self.num_workers, 4)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futs = deque()
            for i in range(len(self.dataset)):
                futs.append(pool.submit(self.dataset.__getitem__, i))
                if len(futs) >= window:
                    yield futs.popleft().result()
            while futs:
                yield futs.popleft().result()

    def _lost_row(self, lost) -> dict:
        row = self.dataset.invalid_row()
        row.update(rot_gt=lost["rot_gt"], trans_gt=lost["trans_gt"],
                   obj_idx=np.int32(lost["obj_idx"]), valid=0.0)
        return row

    def __iter__(self):
        pending: List[dict] = []
        bs = self.batch_size
        for frame in self._frames():
            pending.extend(frame["samples"])
            pending.extend(self._lost_row(lost) for lost in frame["lost"])
            while len(pending) >= bs:
                yield make_batch(pending[:bs], pad_to=bs).to_dict()
                del pending[:bs]
        if pending:
            yield make_batch(pending, pad_to=bs).to_dict()
