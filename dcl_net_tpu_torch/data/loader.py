"""Host-side batch loaders with background prefetch.

Counterparts of dcl_net_tpu/data/loader.py's BatchLoader and
EvalFrameLoader. BatchLoader: a worker pool maps
dataset.__getitem__, the samples are collated into fixed-shape batches
(schema.make_batch by default, padded to the batch size), an optional
batch_transform runs on each, and a producer thread keeps up to PREFETCH
batches ready in a bounded queue. EvalFrameLoader flattens a frame-style
eval dataset (YCB-V test) into padded instance batches.

Data parallelism (parallel/mesh.py): with process_count W > 1 the batch
size is the global batch B, every process builds the same global batches,
and process r yields only its contiguous block of rows [r*B/W, (r+1)*B/W)
of each, padded to B/W, so the ranks' blocks together are the single
process's batch. BatchLoader reads only its block's items; EvalFrameLoader
reads every frame (a frame's rows fall into any block).

Workers are threads (worker_type "thread", the default: enough for
in-memory datasets and for I/O that releases the GIL) or processes
(worker_type "process": the readers' numpy preprocessing holds the GIL, as
the reference's 10 DataLoader worker processes work around). Process
workers are forked once per loader from a forkserver, get the dataset
through the pool's initializer and their own numpy and random seeds, and
are reused across epochs; items travel as numpy arrays, and a worker never
touches CUDA. The forkserver imports the caller's __main__ module, so a
script's work must sit under `if __name__ == "__main__":`, and a __main__
that is not a file (a REPL, stdin, a notebook) cannot run process
workers: their start fails or times out and raises. When the last open
process pool closes, the forkserver is stopped and waited for, so no
process of the loaders outlives the program (left alone, the server exits
only after its parent has, a second or so later, with torch's teardown).
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
WORKER_TYPES = ("thread", "process")

_WORKER_DATASET = None  # the dataset of a worker process (set by _init_worker)
_open_pools = 0  # _ProcessPools of this process not yet closed


def _init_worker(dataset, seed_counter=None, base_seed: int = 0) -> None:
    """Initializer of a worker process: keep the dataset and seed np.random
    and random from (base_seed, worker id) through a SeedSequence, so the
    workers' streams differ from each other, from adjacent base seeds' and
    from the loaders' shuffle RandomStates (forkserver workers would all
    inherit one state otherwise)."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    if seed_counter is not None:
        import random

        with seed_counter.get_lock():
            worker_id = seed_counter.value
            seed_counter.value += 1
        seed = int(np.random.SeedSequence((int(base_seed), worker_id)).generate_state(1)[0])
        np.random.seed(seed)
        random.seed(seed)


def _worker_get(i):
    return _WORKER_DATASET[int(i)]


def _worker_ping():
    import os

    return os.getpid()


def _stop_forkserver() -> None:
    """Stop multiprocessing's forkserver, if it runs, and wait until it has
    exited. Closing its alive pipe is how the server is told to stop; the
    next pool starts a new one."""
    from multiprocessing import forkserver

    forkserver._forkserver._stop()


class _ProcessPool:
    """A forkserver multiprocessing.Pool behind the two calls the loaders
    make of a ThreadPoolExecutor (map, submit). The dataset is pickled once
    per worker through the initializer, so an item moves only its index and
    its result. It stays alive across epochs (its `with` block does not
    close it); close() ends it. forkserver, not fork: the parent has
    threads (the producer, torch's), and a child forked from a threaded
    process can deadlock on a lock held at the fork.

    start_timeout: seconds within which a worker must answer a ping, else
    the pool is terminated and RuntimeError raised (a worker that dies at
    spawn would otherwise leave the first map waiting forever)."""

    def __init__(self, num_workers: int, dataset, base_seed: int = 0,
                 start_timeout: float = 180.0):
        import multiprocessing as mp

        ctx = mp.get_context("forkserver")
        # the server imports the caller's __main__, this module (and with it
        # torch) and the dataset's module once; the workers fork from it
        # with those imported, instead of each importing torch anew
        ctx.set_forkserver_preload(["__main__", __name__, type(dataset).__module__])
        counter = ctx.Value("i", 0)  # hands out the worker ids
        global _open_pools
        _open_pools += 1
        self._open = True
        try:
            self._pool = ctx.Pool(num_workers, initializer=_init_worker,
                                  initargs=(dataset, counter, base_seed))
        except BaseException:
            self._release()
            raise
        self._num_workers = num_workers
        try:
            self._pool.apply_async(_worker_ping).get(start_timeout)
        except mp.TimeoutError:
            self.close()
            raise RuntimeError(
                f"process workers did not start within {start_timeout:.0f} s: a __main__ "
                "that is not a file (a REPL, stdin, a notebook) kills forkserver workers "
                "at spawn (use worker_type 'thread'), or the dataset does not unpickle "
                "in a fresh process") from None

    def map(self, _fn, indices):
        idx = [int(i) for i in indices]
        chunk = max(1, len(idx) // (self._num_workers * 2))
        return self._pool.map(_worker_get, idx, chunk)

    def submit(self, _fn, i):
        ar = self._pool.apply_async(_worker_get, (int(i),))

        class _Future:  # .result() as concurrent.futures'
            def result(self, timeout=None):
                return ar.get(timeout)

        return _Future()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False  # persistent: outlives the epoch's `with` block

    def close(self) -> None:
        if not self._open:
            return
        self._pool.terminate()
        self._pool.join()
        self._release()

    def _release(self) -> None:
        global _open_pools
        self._open = False
        _open_pools -= 1
        if _open_pools == 0:
            _stop_forkserver()


class _LoaderBase:
    """What both loaders share: the worker pool (a thread pool per
    iteration, or one persistent process pool, closed by close() or when
    the loader goes) and the collate and batch_transform hooks."""

    _proc_pool = None
    process_id = 0
    process_count = 1

    @property
    def local_batch_size(self) -> int:
        """The rows of this process's block of a global batch."""
        return self.batch_size // self.process_count

    def _stride(self, process_id: int, process_count: int) -> None:
        self.process_id = int(process_id)
        self.process_count = max(int(process_count), 1)
        if self.batch_size % self.process_count:
            raise ValueError(f"global batch size {self.batch_size} is not divisible by "
                             f"process_count {self.process_count}")

    def _collate(self, samples: List[dict], fill: bool = False) -> dict:
        """A batch of this process's block, padded to the local batch size.
        fill: the block of a short last global batch is empty, and
        `samples` holds one row of that batch only to give the block its
        shapes: every row is then a pad row (pad 1, valid 0)."""
        if self.collate is not None:
            d = self.collate(samples, pad_to=self.local_batch_size)
        else:
            d = make_batch(samples, pad_to=self.local_batch_size).to_dict()
        if fill:
            d["pad"][:] = 1.0
            d["valid"][:] = 0.0
        return d if self.batch_transform is None else self.batch_transform(d)

    def _check_worker_type(self, worker_type: str) -> str:
        if worker_type not in WORKER_TYPES:
            raise NotImplementedError(
                f"worker_type {worker_type!r}: not ported; the port runs 'thread' and "
                "'process' workers")
        return worker_type

    def _make_pool(self):
        if self.worker_type == "thread":
            return ThreadPoolExecutor(max_workers=self.num_workers)
        if self._proc_pool is None:
            self._proc_pool = _ProcessPool(self.num_workers, self.dataset,
                                           base_seed=getattr(self, "seed", 0))
        return self._proc_pool

    def close(self) -> None:
        if self._proc_pool is not None:
            self._proc_pool.close()
            self._proc_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the pool may be half gone
            pass


class BatchLoader(_LoaderBase):
    """Shuffling, dropping-last batch iterator over a map-style dataset.

    The shuffle of epoch e is seeded by seed + e; skip_next > 0 makes the
    next iteration skip that many leading batches (a mid-epoch resume
    replays exactly the batches not yet consumed) and is then reset.

    samples_per_item: how many samples each __getitem__ returns (as a
    list; a raw-mode reader's samples_per_frame): a batch then reads
    batch_size / samples_per_item items and flattens them.

    process_id, process_count: data parallelism (dcl_net_tpu/data/loader.py
    :181-233, 270-284). batch_size is the global batch; every process
    draws the same seeded shuffle and reads only the items of its block
    (items are the unit with samples_per_item > 1), so lengths, epochs and
    mid-epoch resumes agree on every process. The global batch must divide
    by process_count and the block by samples_per_item. drop_last=False
    with a dataset that does not fill the last global batch is refused over
    several processes (a rank would get an empty block) unless fill_tail:
    then such a rank's block is one of the batch's items as pad rows (the
    eval loaders).
    collate(samples, pad_to) -> batch: schema.make_batch's dict by default
    (device preprocessing passes device_preprocess.make_raw_batch).
    batch_transform(batch) -> batch runs after it in the producer thread
    (device_preprocess.DevicePreprocessor), so it overlaps the consumer's
    work like any prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8, seed: int = 0,
                 worker_type: str = "thread", collate=None, batch_transform=None,
                 samples_per_item: int = 1, process_id: int = 0,
                 process_count: int = 1, fill_tail: bool = False):
        self.samples_per_item = max(int(samples_per_item), 1)
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self._stride(process_id, process_count)
        if self.local_batch_size % self.samples_per_item:
            raise ValueError(f"per-process batch size {self.local_batch_size} is not "
                             f"divisible by samples_per_item {samples_per_item}")
        items = self.batch_size // self.samples_per_item
        if self.process_count > 1 and not drop_last and not fill_tail \
                and len(dataset) % items:
            raise ValueError(
                f"loading over {self.process_count} processes needs drop_last=True when "
                f"the dataset length ({len(dataset)}) is not a multiple of the global "
                f"batch ({items} items): the last batch would leave a process an empty "
                "block")
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(int(num_workers), 1)
        self.worker_type = self._check_worker_type(worker_type)
        self.seed = int(seed)
        self.collate = collate
        self.batch_transform = batch_transform
        self.epoch = 0
        self.skip_next = 0

    def __len__(self) -> int:
        n = len(self.dataset)  # items, each samples_per_item samples
        items = self.batch_size // self.samples_per_item
        if self.drop_last:
            return n // items
        return (n + items - 1) // items

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator:
        idx = self._indices()
        items = self.batch_size // self.samples_per_item
        local = self.local_batch_size // self.samples_per_item
        lo = self.process_id * local
        # this process's items of each global batch, and a first item of
        # the batch for a block the short last batch leaves empty
        batches = [(idx[i * items + lo:i * items + lo + local], idx[i * items])
                   for i in range(len(self))]
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
                with self._make_pool() as pool:
                    for b, first in batches:
                        if stop.is_set():
                            return
                        fill = len(b) == 0
                        samples = list(pool.map(self.dataset.__getitem__,
                                                [first] if fill else b))
                        if self.samples_per_item > 1:
                            samples = [s for item in samples for s in item]
                        # an all-invalid batch is yielded too (a zero-weight
                        # step): dropping it would desynchronise the batch
                        # count that a mid-epoch resume replays
                        if not put(self._collate(samples, fill)):
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


class EvalFrameLoader(_LoaderBase):
    """Flatten a frame-style eval dataset (__getitem__ -> {"samples",
    "lost", ...}, as YCBVTestDataset) into fixed-size padded instance
    batches, in frame order: each frame's detected samples, then its lost
    detections as valid=0 rows carrying their true labels; the last batch
    is filled with pad=1 rows.

    Frames are read by num_workers threads or processes (worker_type) with
    a bounded look-ahead of max(2 * num_workers, 4) frames, so the host
    never holds more than that many decoded frames ahead of the consumer.
    collate and batch_transform as in BatchLoader; both run in the
    iterating thread (the device-preprocessing eval path passes
    make_raw_batch and DevicePreprocessor(augment=False, ...)).

    process_id, process_count: data parallelism. batch_size is the global
    batch; every process reads every frame and yields its block of each
    global batch's rows. The last global batch is filled with pad rows, so
    that no process gets an empty block."""

    def __init__(self, dataset, batch_size: int = 16, num_workers: int = 8,
                 worker_type: str = "thread", collate=None, batch_transform=None,
                 process_id: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self._stride(process_id, process_count)
        self.num_workers = max(int(num_workers), 1)
        self.worker_type = self._check_worker_type(worker_type)
        self.collate = collate
        self.batch_transform = batch_transform

    def _frames(self):
        window = max(2 * self.num_workers, 4)
        with self._make_pool() as pool:
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

    def _block(self, rows: List[dict]) -> dict:
        """This process's block of the global batch `rows`."""
        lo = self.process_id * self.local_batch_size
        block = rows[lo:lo + self.local_batch_size]
        return self._collate(block or rows[:1], fill=not block)

    def __iter__(self):
        pending: List[dict] = []
        bs = self.batch_size
        for frame in self._frames():
            pending.extend(frame["samples"])
            pending.extend(self._lost_row(lost) for lost in frame["lost"])
            while len(pending) >= bs:
                yield self._block(pending[:bs])
                del pending[:bs]
        if pending:
            yield self._block(pending)
