"""Process striding of the port's loaders (data parallelism) against the JAX
package's: BatchLoader(process_count=2, process_id=r) yields, rank by rank,
exactly the rows of the JAX BatchLoader at the same seed (samples_per_item
1 and 2), refuses what the JAX loader refuses, and fills a block that the
last batch leaves empty with pad rows when asked (the eval loaders);
EvalFrameLoader's blocks together are the single process's batches; and
DevicePreprocessor draws its own stream on each rank, the same stream as
before at one process."""

import numpy as np
import pytest
import torch

from dcl_net_tpu.data.loader import BatchLoader as JaxBatchLoader
from dcl_net_tpu_torch.data.device_preprocess import DevicePreprocessor
from dcl_net_tpu_torch.data.loader import BatchLoader, EvalFrameLoader
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset

torch.set_num_threads(2)

BASE = [SyntheticPoseDataset(n_objects=2, n_points=16, length=2)[i] for i in range(2)]


class Items:
    """n items, each a sample (samples_per_item 1) or a list of k samples,
    labelled by obj_idx = 10 * item + draw."""

    def __init__(self, n, k=1):
        self.n, self.k = n, k

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rows = [dict(BASE[(i + j) % 2], obj_idx=np.int32(10 * i + j)) for j in range(self.k)]
        return rows[0] if self.k == 1 else rows


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + key + "/")
        elif value is not None:
            yield prefix + key, np.asarray(value)


@pytest.mark.parametrize("samples_per_item", [1, 2])
def test_batch_loader_striding_matches_jax_rank_by_rank(samples_per_item):
    ds = Items(13, samples_per_item)
    for rank in range(2):
        kw = dict(batch_size=8, seed=5, num_workers=2, process_id=rank, process_count=2,
                  samples_per_item=samples_per_item)
        port = BatchLoader(ds, **kw)
        jax_loader = JaxBatchLoader(ds, to_jax=False, **kw)
        assert len(port) == len(jax_loader) == 13 // (8 // samples_per_item)
        for epoch in range(2):  # the shuffle follows the epoch
            port.epoch = jax_loader.epoch = epoch
            got, want = list(port), list(jax_loader)
            assert len(got) == len(want) == len(port)
            for g, w in zip(got, want):
                g, w = dict(_leaves(g)), dict(_leaves(w))
                for key in w:
                    np.testing.assert_array_equal(g[key], w[key], err_msg=key)
                assert g["labels/obj_idx"].shape == (4,)


def test_batch_loader_blocks_make_the_single_process_batches():
    ds = Items(16)
    one = [b["labels"]["obj_idx"] for b in BatchLoader(ds, batch_size=8, seed=3)]
    blocks = [[b["labels"]["obj_idx"] for b in BatchLoader(
        ds, batch_size=8, seed=3, process_id=r, process_count=2)] for r in range(2)]
    for k, whole in enumerate(one):
        np.testing.assert_array_equal(np.concatenate([blocks[0][k], blocks[1][k]]), whole)


def test_batch_loader_refusals_match_jax():
    ds = Items(13)
    for loader in (BatchLoader, JaxBatchLoader):
        kw = {} if loader is BatchLoader else {"to_jax": False}
        with pytest.raises(ValueError, match="not divisible by process_count"):
            loader(ds, batch_size=9, process_count=2, **kw)
        with pytest.raises(ValueError, match="drop_last"):
            loader(ds, batch_size=8, drop_last=False, process_count=2, **kw)
        with pytest.raises(ValueError, match="samples_per_item"):
            loader(Items(13, 4), batch_size=4, process_count=2, samples_per_item=4, **kw)
        loader(ds, batch_size=8, drop_last=True, process_count=2, **kw)
        loader(Items(16), batch_size=8, drop_last=False, process_count=2, **kw)


def test_batch_loader_fill_tail_gives_an_empty_block_pad_rows():
    ds = Items(9)
    blocks = [list(BatchLoader(ds, batch_size=8, shuffle=False, drop_last=False,
                               process_id=r, process_count=2, fill_tail=True))
              for r in range(2)]
    assert [len(b) for b in blocks] == [2, 2]
    last0, last1 = blocks[0][1], blocks[1][1]
    assert last0["pad"].tolist() == [0, 1, 1, 1] and last0["valid"].tolist() == [1, 0, 0, 0]
    assert last0["labels"]["obj_idx"][0] == 80
    assert last1["pad"].tolist() == [1] * 4 and last1["valid"].tolist() == [0] * 4


class Frames:
    """Frames of 0-3 detected samples and 0-1 lost detections."""

    SIZES = [(3, 1), (0, 1), (2, 0), (3, 0), (1, 1), (1, 0)]

    def __len__(self):
        return len(self.SIZES)

    def __getitem__(self, i):
        n, lost = self.SIZES[i]
        samples = [dict(BASE[j % 2], obj_idx=np.int32(10 * i + j)) for j in range(n)]
        return {"samples": samples,
                "lost": [{"rot_gt": np.eye(3, dtype=np.float32),
                          "trans_gt": np.zeros(3, np.float32), "obj_idx": 10 * i + 9}] * lost}

    def invalid_row(self):
        return dict(BASE[0], valid=0.0)


def _real(batch):
    keep = batch["pad"] == 0
    return list(zip(batch["labels"]["obj_idx"][keep].tolist(), batch["valid"][keep].tolist()))


def test_eval_frame_loader_blocks_make_the_single_process_batches():
    """13 rows at a global batch of 6 over 2 processes: blocks of 3, the
    last global batch (1 row) leaving rank 1 a block of pad rows."""
    one = list(EvalFrameLoader(Frames(), batch_size=6, num_workers=1))
    ranks = [list(EvalFrameLoader(Frames(), batch_size=6, num_workers=1,
                                  process_id=r, process_count=2)) for r in range(2)]
    assert len(one) == len(ranks[0]) == len(ranks[1]) == 3
    for k, whole in enumerate(one):
        assert ranks[0][k]["valid"].shape == (3,)
        assert _real(ranks[0][k]) + _real(ranks[1][k]) == _real(whole)
    assert ranks[1][2]["pad"].tolist() == [1.0] * 3
    with pytest.raises(ValueError, match="not divisible by process_count"):
        EvalFrameLoader(Frames(), batch_size=5, process_count=2)


def _preprocessor(**kw):
    return DevicePreprocessor(n_points=16, unit_voxel_extent=(0.024,) * 3,
                              voxel_num_limit=(16,) * 3, seed=7, device="cpu", **kw)


def test_device_preprocessor_streams_per_rank():
    draws = [_preprocessor(process_id=r, process_count=2)._uniform(4, 1.0)
             for r in range(2)]
    assert not torch.equal(draws[0], draws[1])
    # one process: the stream of the seed itself, as before
    single = _preprocessor()._uniform(4, 1.0)
    want = torch.rand((4, 3), generator=torch.Generator().manual_seed(7)) * 2.0 - 1.0
    assert torch.equal(single, want)
    assert torch.equal(_preprocessor(process_id=0, process_count=1)._uniform(4, 1.0), single)
    assert not torch.equal(draws[0], single)
