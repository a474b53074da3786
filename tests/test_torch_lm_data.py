"""The port's LineMOD readers against the JAX package's, on the on-disk
fixtures of tests/fixtures.py (13 LineMOD objects and 8 Occlusion-LineMOD
objects, one frame each), with one lost detection written into each tree:
an empty SegNet label for LM object 04 and an empty HybridPose mask for the
LMO cat. Both packages' readers run the same numpy code from the same
global seeds (np.random and Python's random), so every array is equal and
floats exact: LM in the modes train (the occlusion augmentation and the
SE(3) draws), test and eval, LMO in eval; also the file lists, the template
banks, the CAD clouds and the diameters. The port's mask_to_bbox (scipy,
no cv2) is held to the JAX package's cv2 contours on random masks with
ties; and what the port refuses.
"""

import os
import random

import numpy as np
import pytest

from dcl_net_tpu.config import Config as JaxConfig
from dcl_net_tpu.data import linemod as jlm
from dcl_net_tpu.data import preprocess as jpp
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data import linemod as lm
from dcl_net_tpu_torch.data import preprocess as pp
from dcl_net_tpu_torch.data.png import imread
from tests import fixtures
from tests.test_torch_ycbv_data import assert_same

DS = {"input_size": 256, "tmp_size": 256, "unit_voxel_extent": [0.005] * 3,
      "voxel_num_limit": [64, 64, 64], "voxelization_mode": 4}
CFG, JCFG = Config(DS), JaxConfig(DS)
LOST_LM = 4        # LineMOD object whose SegNet label is empty
LOST_LMO = "cat"   # Occlusion-LineMOD object whose mask is empty


def blank_png(path: str) -> None:
    from PIL import Image

    Image.fromarray(np.zeros_like(imread(path))).save(path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("lm"))
    lm_root = fixtures.make_linemod_fixture(tmp)
    lmo_root, masks = fixtures.make_lmo_fixture(tmp, lm_root)
    blank_png(os.path.join(lm_root, "segnet_results", f"{LOST_LM:02d}_label", "0000_label.png"))
    blank_png(os.path.join(masks, LOST_LMO, "0.png"))
    return {"lm": lm_root, "lmo": lmo_root, "masks": masks,
            "models": os.path.join(lm_root, "models")}


def _seeded(fn, seed):
    np.random.seed(seed)
    random.seed(seed)
    return fn()


def _rows(ds, seed):
    return _seeded(lambda: [ds[i] for i in range(len(ds))], seed)


@pytest.mark.parametrize("mode, rows", [("train", 13), ("test", 13), ("eval", 130)])
def test_lm_reader_matches_jax(trees, mode, rows):
    """test mode keeps every 10th line of an object's test.txt (the fixture
    lists its frame 10 times), eval mode every line."""
    ds = lm.LineMODDataset(mode, CFG, trees["lm"])
    jds = jlm.LineMODDataset(mode, JCFG, trees["lm"])
    assert len(ds) == len(jds) == rows
    for attr in ("list_rgb", "list_depth", "list_label", "list_obj", "list_rank",
                 "index_ranges"):
        assert getattr(ds, attr) == getattr(jds, attr), attr
    for seed in (0, 1) if rows < 100 else (0,):
        got, want = _rows(ds, seed), _rows(jds, seed)
        assert_same(got, want, f"{mode} seed {seed}")
    lost = [r["valid"] == 0 for r in got]
    if mode == "eval":  # the empty SegNet label: lost detections
        assert lost == [obj == LOST_LM for obj in ds.list_obj]
    else:
        assert not any(lost)
    assert {int(r["obj_idx"]) for r in got if r["valid"]} <= set(range(13))
    sym = {o for r, o in zip(got, ds.list_obj) if r["valid"] and r["sym_flag"] > 0}
    assert sym == {10, 11}  # eggbox and glue


def test_lm_train_reader_occludes_and_augments(trees):
    """In train mode the sample moves with the draws: the augmentation runs
    (a second seed gives other points), and the paste of another object's
    crop draws from both global generators."""
    ds = lm.LineMODDataset("train", CFG, trees["lm"])
    a, b = _seeded(lambda: ds[5], 0), _seeded(lambda: ds[5], 1)
    assert not np.array_equal(a["inp_feats"], b["inp_feats"])
    assert not np.array_equal(a["rot_gt"], b["rot_gt"])
    img = imread(ds.list_rgb[5])[:, :, :3]
    depth = imread(ds.list_depth[5])
    label = imread(ds.list_label[5])
    jds = jlm.LineMODDataset("train", JCFG, trees["lm"])
    got = _seeded(lambda: ds.occlude_with_another_object(
        img.copy(), depth.copy(), label.copy(), ds.list_obj[5]), 3)
    want = _seeded(lambda: jds.occlude_with_another_object(
        img.copy(), depth.copy(), label.copy(), jds.list_obj[5]), 3)
    assert_same(list(got), list(want), "occlusion")
    assert not np.array_equal(got[0], img)  # the paste ran


def test_lmo_reader_matches_jax(trees):
    args = ("eval", trees["lmo"], trees["models"])
    ds = lm.OcclusionLineMODDataset(args[0], CFG, *args[1:], masks_dir=trees["masks"])
    jds = jlm.OcclusionLineMODDataset(args[0], JCFG, *args[1:], masks_dir=trees["masks"])
    assert len(ds) == len(jds) == 8
    for attr in ("list_rgb", "list_depth", "list_label", "list_obj"):
        assert getattr(ds, attr) == getattr(jds, attr), attr
    assert_same(ds.list_rot, jds.list_rot, "list_rot")
    assert_same(ds.list_trans, jds.list_trans, "list_trans")
    for seed in (0, 1):
        got, want = _rows(ds, seed), _rows(jds, seed)
        assert_same(got, want, f"lmo seed {seed}")
    lost = lm.LMO_OBJLIST.index(next(k for k, v in lm.LMO_ID2NAME.items() if v == LOST_LMO))
    assert [r["valid"] for r in got] == [0.0 if i == lost else 1.0 for i in range(8)]
    assert [int(r["obj_idx"]) for r in got] == list(range(8))  # a lost row keeps its class
    for r in got[:lost] + got[lost + 1:]:  # the flipped, composed rotation is one
        np.testing.assert_allclose(r["rot_gt"] @ r["rot_gt"].T, np.eye(3), atol=1e-5)


def test_lmo_read_pose_matches_jax(tmp_path):
    path = tmp_path / "7.txt"
    path.write_text("rotation:\n0.1 -0.99 0.0\n0.99 0.1 0.0\n0 0 1\n"
                    "center:\n0.01 -0.02 0.93\n123\n")
    assert_same(list(lm.OcclusionLineMODDataset._read_pose(str(path))),
                list(jlm.OcclusionLineMODDataset._read_pose(str(path))), "pose")
    for name in lm.LMO_ID2NAME.values():
        assert_same(list(lm.linemod_to_occlusion_transformation(name)),
                    list(jlm.linemod_to_occlusion_transformation(name)), name)


def test_template_bank_clouds_and_diameters_match_jax(trees):
    ds = lm.LineMODDataset("eval", CFG, trees["lm"])
    jds = jlm.LineMODDataset("eval", JCFG, trees["lm"])
    assert_same(ds.template_bank(), jds.template_bank(), "lm bank")
    assert ds.template_bank()["feats"].shape == (13, 256, 7)
    assert_same(ds.diameters(), jds.diameters(), "lm diameters")
    np.testing.assert_allclose(ds.diameters(), 0.008, atol=1e-9)  # 80 mm x 0.1 in metres
    want = np.stack([jds.pc_cad[o] / 1000.0 for o in jds.objlist]).astype(np.float32)
    assert_same(ds.model_points_array(), want, "lm model points")
    assert ds.radius == jds.radius
    info = os.path.join(trees["models"], "models_info.yml")
    args = ("eval", trees["lmo"], trees["models"])
    lmo = lm.OcclusionLineMODDataset(args[0], CFG, *args[1:], masks_dir=trees["masks"])
    jlmo = jlm.OcclusionLineMODDataset(args[0], JCFG, *args[1:], masks_dir=trees["masks"])
    assert_same(lmo.template_bank(), jlmo.template_bank(), "lmo bank")
    assert_same(lmo.diameters(info), jlmo.diameters(info), "lmo diameters")


def test_mask_to_bbox_and_snap_match_cv2():
    """The largest 8-connected component's box, ties to the last in raster
    order, as cv2's contours give it; on sparse and dense random masks,
    rings with holes, equal-area blobs and the empty mask."""
    rng = np.random.RandomState(0)
    masks = [np.zeros((48, 64), np.uint8)]
    for t in range(300):
        m = (rng.rand(48, 64) < (0.02, 0.1, 0.3, 0.5)[t % 4]).astype(np.uint8) * 255
        masks.append(m)
        blobs = np.zeros((48, 64), bool)
        for _ in range(1 + t % 4):  # equal areas: a tie between blobs
            r, c = rng.randint(0, 44), rng.randint(0, 60)
            blobs[r:r + 3, c:c + 3] = True
        masks.append(blobs)
    ring = np.zeros((48, 64), bool)
    ring[5:20, 5:30] = True
    ring[7:18, 7:28] = False
    masks.append(ring)
    for m in masks:
        assert pp.mask_to_bbox(m, 64, 48) == jpp.mask_to_bbox(m, 64, 48)
    for _ in range(200):
        box = [int(v) for v in rng.randint(-20, 700, 4)]
        assert lm.lm_bbox_snap(box) == jlm.lm_bbox_snap(box)


@pytest.mark.parametrize("extra", [{"device_preprocess": True}, {"samples_per_frame": 2}])
def test_raw_mode_is_refused(trees, extra):
    with pytest.raises(NotImplementedError, match="A 6"):
        lm.LineMODDataset("train", Config({**DS, **extra}), trees["lm"])
    with pytest.raises(NotImplementedError, match="A 6"):
        lm.OcclusionLineMODDataset("eval", Config({**DS, **extra}), trees["lmo"],
                                   trees["models"], masks_dir=trees["masks"])


def test_lm_tree_writer_reads_alike_in_both_packages(tmp_path):
    """scripts/lm_tree.py (no PIL), which chip_smoke.py runs on the card:
    its PNGs decode as PIL decodes them, both packages' readers give the
    same rows from it, and its lost rows are where it says."""
    import importlib.util
    from pathlib import Path

    from PIL import Image

    path = Path(__file__).resolve().parent.parent / "scripts" / "lm_tree.py"
    spec = importlib.util.spec_from_file_location("lm_tree", path)
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)
    out = str(tmp_path)
    info = writer.write_lm_tree(out, frames=2, repeats=2)
    lmo_info = writer.write_lmo_tree(out, images=1, repeats=writer.LMO_LOST_EVERY)
    assert (info["eval_rows"], info["lost"], info["train_rows"]) == (52, 26, 26)
    assert (lmo_info["eval_rows"], lmo_info["lost"]) == (8 * writer.LMO_LOST_EVERY, 8)
    root = info["root"]
    for png_path in (f"{root}/data/01/rgb/0000.png", f"{root}/data/01/depth/0001.png",
                     f"{root}/data/01/mask/0000.png",
                     f"{root}/segnet_results/01_label/0000_label.png",
                     f"{lmo_info['masks']}/duck/3.png"):
        np.testing.assert_array_equal(imread(png_path), np.array(Image.open(png_path)))
    ds = lm.LineMODDataset("eval", CFG, root)
    got, want = _rows(ds, 0), _rows(jlm.LineMODDataset("eval", JCFG, root), 0)
    assert_same(got, want, "written lm eval")
    assert [r["valid"] for r in got] == [1.0, 1.0, 0.0, 0.0] * 13  # frame 0001: lost
    train = lm.LineMODDataset("train", CFG, root)
    assert_same(_rows(train, 0), _rows(jlm.LineMODDataset("train", JCFG, root), 0), "train")
    models = os.path.join(root, "models")
    args = ("eval", lmo_info["root"], models)
    lmo = lm.OcclusionLineMODDataset(*args[:1], CFG, *args[1:], masks_dir=lmo_info["masks"])
    jlmo = jlm.OcclusionLineMODDataset(*args[:1], JCFG, *args[1:], masks_dir=lmo_info["masks"])
    got = _rows(lmo, 0)
    assert_same(got, _rows(jlmo, 0), "written lmo")
    assert sum(r["valid"] == 0 for r in got) == 8
    # the written poses place each object: its points lie on its sphere
    diam = writer.diameters_mm()
    for r, obj in zip(got, lmo.list_obj):
        if r["valid"]:
            dist = np.linalg.norm(r["inp_feats"][:, 4:7] - r["trans_gt"], axis=1)
            np.testing.assert_allclose(dist, diam[obj] / 2000.0, atol=1e-3)


def test_level_occupancy_script_counts_the_backbone_masks():
    """scripts/lm_level_occupancy.py's mask path gives the occupancies of
    the pyramid levels the model's backbone builds, which K2 compacts."""
    import importlib.util
    from pathlib import Path

    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.ops.voxelize import voxelize_dense

    path = Path(__file__).resolve().parent.parent / "scripts" / "lm_level_occupancy.py"
    spec = importlib.util.spec_from_file_location("lm_level_occupancy", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    model = DCLNet(unit_voxel_extent=(0.024,) * 3, voxel_num_limit=(16,) * 3, device="cpu")
    ds = SyntheticPoseDataset(n_objects=2, n_points=64, unit_voxel_extent=(0.024,) * 3,
                              voxel_num_limit=(16,) * 3, seed=0)
    batch = make_batch([ds[i] for i in range(3)]).to_dict()
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        grid, count = voxelize_dense(tb["inp"]["feats"], tb["inp"]["voxel_idx"],
                                     model.grid_shape)
        pyramid = model.backbone_inp(grid, (count > 0).float())
    want = np.stack([(m > 0).reshape(3, -1).sum(1).numpy() for _, m in pyramid], 1)
    got = script.level_rows(batch["inp"]["voxel_idx"], model, dilate=True)
    np.testing.assert_array_equal(got, want)
    pooled_alone = script.level_rows(batch["inp"]["voxel_idx"], model, dilate=False)
    assert (pooled_alone <= got).all() and (pooled_alone < got).any()
