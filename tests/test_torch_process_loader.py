"""The port's loaders with process workers (data/loader.py): a forkserver
pool gives the same batches as thread workers where the items do not
depend on the workers' random state (the synthetic dataset draws from
per-index seeds; raw-mode YCB-V test rows draw nothing), each worker seeds
its own numpy and random streams from (seed, worker id), samples_per_item
keeps a frame's draws together in one batch, a pool whose workers
cannot start raises within its start timeout instead of hanging, and
closing the last open pool stops the forkserver, so no process of the
loaders outlives the program.
"""

import operator
import os
import random
import time

import numpy as np
import pytest

from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data import device_preprocess as dp
from dcl_net_tpu_torch.data import loader as loader_mod
from dcl_net_tpu_torch.data import ycbv
from dcl_net_tpu_torch.data.loader import BatchLoader, EvalFrameLoader
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from tests import fixtures
from tests.test_torch_ycbv_data import assert_same

SYN = dict(n_objects=3, n_points=64, unit_voxel_extent=(0.024,) * 3,
           voxel_num_limit=(16,) * 3, seed=0)


@pytest.mark.parametrize("spf", [1, 2])
def test_process_workers_give_the_thread_workers_batches(spf):
    ds = SyntheticPoseDataset(length=8, frame_mode=spf > 1, samples_per_frame=spf, **SYN)
    kw = dict(batch_size=4, num_workers=2, seed=5, samples_per_item=spf)
    thread = list(BatchLoader(ds, worker_type="thread", **kw))
    loader = BatchLoader(ds, worker_type="process", **kw)
    try:
        proc = list(loader)
        again = list(loader)  # the next epoch reuses the pool
        pool = loader._proc_pool
        assert pool is not None
        assert list(loader) and loader._proc_pool is pool
    finally:
        loader.close()
    assert loader._proc_pool is None
    assert len(proc) == len(thread) == 8 * spf // 4
    assert_same(proc, thread, "batches")
    assert len(again) == len(proc)


def test_samples_per_item_packs_a_frame_into_one_batch():
    ds = SyntheticPoseDataset(length=6, frame_mode=True, samples_per_frame=2, **SYN)
    loader = BatchLoader(ds, batch_size=4, num_workers=2, seed=1, samples_per_item=2)
    assert len(loader) == 3  # 6 frames, 2 a batch
    order = loader._indices()
    for b, batch in enumerate(loader):
        for j, frame in enumerate(order[2 * b:2 * b + 2]):
            for k, sample in enumerate(ds[frame]):
                np.testing.assert_array_equal(batch["inp"]["feats"][2 * j + k],
                                              sample["inp_feats"])
        cls = batch["labels"]["obj_idx"]
        assert cls[0] == cls[1] and cls[2] == cls[3]
    with pytest.raises(ValueError, match="samples_per_item"):
        BatchLoader(ds, batch_size=5, samples_per_item=2)


class SeedProbe:
    """Each item: the worker's pid and its next np.random and random draws.
    The first item a worker reads waits at a barrier of `parties`, so every
    worker takes one of the first `parties` items."""

    def __init__(self, parties: int):
        import multiprocessing as mp

        self.barrier = mp.get_context("forkserver").Barrier(parties)
        self.parties = parties

    def __len__(self):
        return self.parties

    def __getitem__(self, i):
        self.barrier.wait(60)
        return {"pid": np.int64(os.getpid()), "np": np.int64(np.random.randint(1 << 62)),
                "py": random.random()}


def test_process_workers_have_distinct_seeded_streams():
    """Worker k seeds np.random and random with SeedSequence((seed, k)): the
    streams differ between workers and are the expected ones."""
    pool = loader_mod._ProcessPool(3, SeedProbe(3), base_seed=11)
    try:
        rows = pool.map(None, range(3))
    finally:
        pool.close()
    assert len({int(r["pid"]) for r in rows}) == 3
    want = {}
    for worker in range(3):
        seed = int(np.random.SeedSequence((11, worker)).generate_state(1)[0])
        want[int(np.random.RandomState(seed).randint(1 << 62))] = random.Random(seed).random()
    assert {int(r["np"]): r["py"] for r in rows} == want


class Unloadable:
    """Pickles fine; unpickling it in a worker raises (ZeroDivisionError),
    so every worker dies at start."""

    def __reduce__(self):
        return operator.truediv, (1, 0)


def test_a_pool_whose_workers_cannot_start_raises_within_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not start within 5 s"):
        loader_mod._ProcessPool(2, Unloadable(), start_timeout=5.0)
    assert time.monotonic() - t0 < 30.0


def _running(pid: int) -> bool:
    """Whether pid is a live process (a zombie has exited)."""
    try:
        stat = open(f"/proc/{pid}/stat").read()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def test_closing_the_last_pool_stops_the_forkserver():
    from multiprocessing import forkserver

    ds = SyntheticPoseDataset(length=4, **SYN)
    first = loader_mod._ProcessPool(2, ds)
    second = loader_mod._ProcessPool(2, ds)
    server = forkserver._forkserver._forkserver_pid
    workers = [p.pid for pool in (first, second) for p in pool._pool._pool]
    assert server is not None and _running(server)
    first.close()
    first.close()  # a second close is a no-op
    assert forkserver._forkserver._forkserver_pid == server and _running(server)
    assert len(second.map(None, range(4))) == 4  # the open pool still works
    second.close()
    assert forkserver._forkserver._forkserver_pid is None
    assert not _running(server)
    assert not any(_running(pid) for pid in workers)
    third = loader_mod._ProcessPool(2, ds)  # the next pool starts a new server
    try:
        assert len(third.map(None, range(2))) == 2
    finally:
        third.close()
    assert forkserver._forkserver._forkserver_pid is None


def test_eval_frame_loader_process_workers_give_the_thread_batches(tmp_path):
    """YCB-V test rows in raw mode draw nothing on the host when no mask
    has more pixels than device_cand_k: process and thread workers give the
    same raw batches, lost rows included."""
    root, assets = fixtures.make_ycbv_fixture(str(tmp_path), second_video=True)
    cfg = Config({"input_size": 64, "tmp_size": 64, "unit_voxel_extent": [0.024] * 3,
                  "voxel_num_limit": [16, 16, 16], "device_preprocess": True})
    ds = ycbv.YCBVTestDataset(cfg, root, assets_dir=assets)
    kw = dict(batch_size=4, num_workers=2, collate=dp.make_raw_batch)
    thread = list(EvalFrameLoader(ds, worker_type="thread", **kw))
    loader = EvalFrameLoader(ds, worker_type="process", **kw)
    try:
        proc = list(loader)
    finally:
        loader.close()
    assert_same(proc, thread, "batches")
    assert sum(int((b["valid"] == 0).sum() - b["pad"].sum()) for b in proc) == 1
    assert max(int(b["n_cand"].max()) for b in proc) < ds.cand_k
