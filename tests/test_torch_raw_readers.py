"""The readers' raw-candidate mode (device_preprocess: True) and the
synthetic dataset's frame mode against the JAX package's, on the on-disk
fixtures of tests/fixtures.py: both packages run the same numpy code from
the same global seeds, so every raw sample is equal array for array (the
candidate pixels, their count, the camera, the labels, the template
branch). YCB-V train (samples_per_frame 1 and 2: one decode, several
instance draws) and test (the rows of EvalFrameLoader through
make_raw_batch, lost detections included), LM train (occlusion
augmentation on the host, samples_per_frame 2) and eval, LMO eval (its lost
row keeps its class); a device_cand_k below the masks' pixel counts thins
the candidates with the same draw.
"""

import os
import random

import numpy as np
import pytest

from dcl_net_tpu.config import Config as JaxConfig
from dcl_net_tpu.data import device_preprocess as jdp
from dcl_net_tpu.data import linemod as jlm
from dcl_net_tpu.data import ycbv as jycbv
from dcl_net_tpu.data.loader import BatchLoader as JaxBatchLoader
from dcl_net_tpu.data.loader import EvalFrameLoader as JaxEvalFrameLoader
from dcl_net_tpu.data.synthetic import SyntheticPoseDataset as JaxSynthetic
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data import device_preprocess as dp
from dcl_net_tpu_torch.data import linemod as lm
from dcl_net_tpu_torch.data import ycbv
from dcl_net_tpu_torch.data.loader import BatchLoader, EvalFrameLoader
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from tests import fixtures
from tests.test_torch_lm_data import LOST_LM, LOST_LMO, blank_png
from tests.test_torch_ycbv_data import assert_same

YCBV_DS = {"input_size": 256, "tmp_size": 256, "unit_voxel_extent": [0.006] * 3,
           "voxel_num_limit": [64, 64, 64], "voxelization_mode": 4,
           "device_preprocess": True}
LM_DS = {**YCBV_DS, "unit_voxel_extent": [0.005] * 3}


def cfgs(base, **extra):
    d = {**base, **extra}
    return Config(d), JaxConfig(d)


def seeded(fn, seed):
    np.random.seed(seed)
    random.seed(seed)
    return fn()


def items(ds, seed):
    return seeded(lambda: [ds[i] for i in range(len(ds))], seed)


@pytest.fixture(scope="module")
def ycbv_tree(tmp_path_factory):
    return fixtures.make_ycbv_fixture(str(tmp_path_factory.mktemp("ycbv_raw")),
                                      second_video=True)


@pytest.fixture(scope="module")
def lm_trees(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("lm_raw"))
    lm_root = fixtures.make_linemod_fixture(tmp)
    lmo_root, masks = fixtures.make_lmo_fixture(tmp, lm_root)
    blank_png(os.path.join(lm_root, "segnet_results", f"{LOST_LM:02d}_label", "0000_label.png"))
    blank_png(os.path.join(masks, LOST_LMO, "0.png"))
    return {"lm": lm_root, "lmo": lmo_root, "masks": masks,
            "models": os.path.join(lm_root, "models")}


@pytest.mark.parametrize("spf", [1, 2])
@pytest.mark.parametrize("cand_k", [8192, 512])
def test_ycbv_train_raw_samples_match_jax(ycbv_tree, spf, cand_k):
    root, assets = ycbv_tree
    cfg, jcfg = cfgs(YCBV_DS, samples_per_frame=spf, device_cand_k=cand_k)
    ds = ycbv.YCBVTrainDataset(cfg, root, assets_dir=assets)
    jds = jycbv.YCBVTrainDataset(jcfg, root, assets_dir=assets)
    assert (ds.raw_mode, ds.samples_per_frame, ds.cand_k) == (
        jds.raw_mode, jds.samples_per_frame, jds.cand_k) == (True, spf, cand_k)
    assert ds.device_min_points == 50
    for seed in (0, 1):
        got, want = items(ds, seed), items(jds, seed)
        assert_same(got, want, f"seed {seed}")
    flat = [s for it in got for s in (it if spf > 1 else [it])]
    assert len(flat) == len(ds) * spf
    valid = [s for s in flat if s["valid"] > 0]
    assert valid and all(0 < s["n_cand"] <= cand_k for s in valid)
    if cand_k == 512:
        assert any(s["n_cand"] == 512 for s in valid)  # thinned


def test_ycbv_train_raw_batches_match_jax(ycbv_tree):
    """BatchLoader with samples_per_item 2 and make_raw_batch: one thread,
    the same shuffle and draws, the same raw batches."""
    root, assets = ycbv_tree
    cfg, jcfg = cfgs(YCBV_DS, samples_per_frame=2)
    ds = ycbv.YCBVTrainDataset(cfg, root, assets_dir=assets)
    jds = jycbv.YCBVTrainDataset(jcfg, root, assets_dir=assets)
    kw = dict(batch_size=4, num_workers=1, seed=3, samples_per_item=2)
    got = seeded(lambda: list(BatchLoader(ds, collate=dp.make_raw_batch, **kw)), 5)
    want = seeded(lambda: list(JaxBatchLoader(jds, collate=jdp.make_raw_batch,
                                              to_jax=False, **kw)), 5)
    assert len(got) == len(want) == len(ds) // 2
    assert_same(got, want, "batches")


def test_ycbv_test_raw_rows_match_jax(ycbv_tree):
    root, assets = ycbv_tree
    cfg, jcfg = cfgs(YCBV_DS)
    ds = ycbv.YCBVTestDataset(cfg, root, assets_dir=assets)
    jds = jycbv.YCBVTestDataset(jcfg, root, assets_dir=assets)
    assert ds.samples_per_frame == 1
    assert_same(ds.invalid_row(), jds.invalid_row(), "invalid_row")
    got, want = items(ds, 0), items(jds, 0)
    assert_same(got, want, "frames")
    assert sum(len(f["lost"]) for f in got) == 1
    for f in got:
        for s in f["samples"]:
            n = int(s["n_cand"])
            # rows and columns of detected pixels, depth nonzero
            assert n > 0 and (s["cand_depth"][:n] > 0).all() and not s["cand_depth"][n:].any()
    loaders = (EvalFrameLoader(ds, batch_size=4, num_workers=1, collate=dp.make_raw_batch),
               JaxEvalFrameLoader(jds, batch_size=4, num_workers=1,
                                  collate=jdp.make_raw_batch))
    got_b, want_b = (seeded(lambda: list(loader), 0) for loader in loaders)
    assert_same(got_b, want_b, "batches")
    assert int(sum(b["valid"].sum() for b in got_b)) == sum(len(f["samples"]) for f in got)


@pytest.mark.parametrize("mode, spf", [("train", 1), ("train", 2), ("eval", 1)])
def test_lm_raw_samples_match_jax(lm_trees, mode, spf):
    cfg, jcfg = cfgs(LM_DS, samples_per_frame=spf)
    ds = lm.LineMODDataset(mode, cfg, lm_trees["lm"])
    jds = jlm.LineMODDataset(mode, jcfg, lm_trees["lm"])
    assert (ds.raw_mode, ds.samples_per_frame, ds.device_min_points) == (
        jds.raw_mode, jds.samples_per_frame, jds.device_min_points) == (True, spf, 128)
    idx = range(len(ds)) if mode == "train" else range(0, len(ds), 10)
    for seed in (0, 1):
        got = seeded(lambda: [ds[i] for i in idx], seed)
        want = seeded(lambda: [jds[i] for i in idx], seed)
        assert_same(got, want, f"{mode} seed {seed}")
    flat = [s for it in got for s in (it if spf > 1 else [it])]
    lost = [s["valid"] == 0 for s in flat]
    if mode == "eval":  # the empty SegNet label
        assert lost == [ds.list_obj[i] == LOST_LM for i in idx]
    else:
        assert not any(lost)
    assert all(s["cam"][4] == 1000.0 for s in flat if s["valid"])


def test_lmo_raw_samples_match_jax(lm_trees):
    cfg, jcfg = cfgs(LM_DS)
    args = ("eval", lm_trees["lmo"], lm_trees["models"])
    ds = lm.OcclusionLineMODDataset(args[0], cfg, *args[1:], masks_dir=lm_trees["masks"])
    jds = jlm.OcclusionLineMODDataset(args[0], jcfg, *args[1:], masks_dir=lm_trees["masks"])
    assert (ds.raw_mode, ds.device_min_points) == (jds.raw_mode, jds.device_min_points) == (
        True, 0)
    for seed in (0, 1):
        assert_same(items(ds, seed), items(jds, seed), f"lmo seed {seed}")
    got = items(ds, 0)
    lost = lm.LMO_OBJLIST.index(next(k for k, v in lm.LMO_ID2NAME.items() if v == LOST_LMO))
    assert [r["valid"] for r in got] == [0.0 if i == lost else 1.0 for i in range(8)]
    assert [int(r["obj_idx"]) for r in got] == list(range(8))
    assert got[lost]["n_cand"] == 0


@pytest.mark.parametrize("spf", [1, 2, 3])
def test_synthetic_frame_mode_matches_jax(spf):
    kw = dict(n_objects=3, n_points=64, unit_voxel_extent=(0.024,) * 3,
              voxel_num_limit=(16,) * 3, length=6, seed=2, frame_mode=True,
              samples_per_frame=spf)
    ds, jds = SyntheticPoseDataset(**kw), JaxSynthetic(**kw)
    got, want = [ds[i] for i in range(6)], [jds[i] for i in range(6)]
    assert_same(got, want, "frames")
    if spf > 1:
        # one scene a frame: each frame's draws share the object, differ in pose
        for frame in got:
            assert len({int(s["obj_idx"]) for s in frame}) == 1
            assert not np.array_equal(frame[0]["rot_gt"], frame[1]["rot_gt"])
    # frame_mode off: the same samples as before
    plain = SyntheticPoseDataset(**{**kw, "frame_mode": False})
    assert_same(plain[4], JaxSynthetic(**{**kw, "frame_mode": False})[4], "plain")
