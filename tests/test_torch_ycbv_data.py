"""The port's YCB-V data layer against the JAX package's, on the on-disk
fixture of tests/fixtures.py (3 classes, videos 0001 and 0060, one lost
detection): the native PNG decode against the JAX decode and PIL, the PLY
reader, both YCB-V readers sample for sample under the same global seeds
(the same numpy code, so arrays are equal and floats exact), the template
bank and eval clouds, EvalFrameLoader's batches, and the synthetic
dataset's cad_dir branch; also the PIL-free tree writer that chip_smoke.py
uses, and what the port refuses.
"""

import importlib.util
import os
import random
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dcl_net_tpu.config import Config as JaxConfig
from dcl_net_tpu.data import ycbv as jycbv
from dcl_net_tpu.data.loader import EvalFrameLoader as JaxEvalFrameLoader
from dcl_net_tpu.data.ply import read_ply as jax_read_ply
from dcl_net_tpu.data.png import imread as jax_imread
from dcl_net_tpu.data.synthetic import SyntheticPoseDataset as JaxSynthetic
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data import png, ycbv
from dcl_net_tpu_torch.data.loader import EvalFrameLoader
from dcl_net_tpu_torch.data.ply import read_ply
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from tests import fixtures

ROOT = Path(__file__).resolve().parent.parent
DS = {"input_size": 256, "tmp_size": 256, "unit_voxel_extent": [0.006] * 3,
      "voxel_num_limit": [64, 64, 64], "voxelization_mode": 4}
CFG, JCFG = Config(DS), JaxConfig(DS)


def _tree_writer():
    spec = importlib.util.spec_from_file_location("ycbv_tree", ROOT / "scripts" / "ycbv_tree.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return fixtures.make_ycbv_fixture(str(tmp_path_factory.mktemp("ycbv")), second_video=True)


def assert_same(got, want, where="sample"):
    """Equal structure, keys, values and dtypes; arrays element for element."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


def _seeded(fn, seed):
    np.random.seed(seed)
    random.seed(seed)
    return fn()


@pytest.mark.parametrize("suffix", ["color", "depth", "label"])
def test_imread_matches_jax_and_pil_on_fixture(tree, suffix):
    root, _ = tree
    for frame in ("data/0001/000001", "data/0060/000002"):
        path = f"{root}/{frame}-{suffix}.png"
        got = png.imread(path)
        want = np.array(Image.open(path))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_imread(path))
    assert {"color": 3, "depth": 2, "label": 2}[suffix] == got.ndim


@pytest.mark.parametrize("width", [1, 2, 3, 5, 127])
def test_imread_odd_widths(tmp_path, width):
    rng = np.random.RandomState(width)
    for arr in (rng.randint(0, 256, (9, width, 3)).astype(np.uint8),
                rng.randint(0, 9999, (9, width)).astype(np.uint16),
                rng.randint(0, 22, (9, width)).astype(np.uint8)):
        path = str(tmp_path / f"w{width}_{arr.dtype}_{arr.ndim}.png")
        Image.fromarray(arr).save(path)
        got = png.imread(path)
        np.testing.assert_array_equal(got, np.array(Image.open(path)))
        np.testing.assert_array_equal(got, arr)
        assert got.dtype == arr.dtype


def test_imread_reads_sub_byte_depths_through_pil(tmp_path):
    # mode "1" is written as a 1-bit PNG: the decoder reports it unsupported
    arr = np.random.RandomState(0).rand(13, 17) > 0.5
    path = str(tmp_path / "bits.png")
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(png.imread(path), np.array(Image.open(path)))


def test_imread_raises_on_what_it_cannot_read(tmp_path):
    arr = np.arange(30 * 40, dtype=np.uint8).reshape(30, 40)
    bmp = str(tmp_path / "x.bmp")
    Image.fromarray(arr).save(bmp, format="BMP")
    with pytest.raises(ValueError, match="not a PNG"):
        png.imread(bmp)
    path = str(tmp_path / "t.png")
    Image.fromarray(np.random.RandomState(1).randint(0, 256, (20, 20, 3)).astype(np.uint8)
                    ).save(path)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(ValueError):
        png.imread(path)


def _png(width, height, idat: bytes) -> bytes:
    """An 8-bit grayscale PNG of the given size whose one IDAT chunk holds
    `idat` (a zlib stream), chunk CRCs included."""
    import struct
    import zlib

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat)
            + chunk(b"IEND", b""))


def test_imread_raises_on_an_idat_stream_that_inflates_short(tmp_path):
    """A complete zlib stream that holds fewer rows than the header gives
    must not decode: its missing rows would be stale bytes. The same
    stream with every row decodes."""
    import zlib

    width, height = 16, 12
    rows = np.random.RandomState(2).randint(0, 256, (height, width)).astype(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)  # filter 0
    good = tmp_path / "good.png"
    good.write_bytes(_png(width, height, zlib.compress(raw.tobytes())))
    np.testing.assert_array_equal(png.imread(str(good)), rows)
    short = tmp_path / "short.png"
    short.write_bytes(_png(width, height, zlib.compress(raw[: height // 2].tobytes())))
    with pytest.raises(ValueError, match="decode failed"):
        png.imread(str(short))


@pytest.mark.parametrize("cxx, match", [("no-such-compiler-dclx", "needs a C\\+\\+ compiler"),
                                        ("false", "failed")])
def test_host_library_build_raises_without_a_working_compiler(tmp_path, cxx, match):
    with pytest.raises(RuntimeError, match=match):
        png.build(cxx=cxx, build_dir=tmp_path)
    assert not list(tmp_path.iterdir())


def test_read_ply_matches_jax(tree):
    _, assets = tree
    path = os.path.join(assets, "CADs", "obj_01_pc.ply")
    assert_same(read_ply(path), jax_read_ply(path))


def test_test_dataset_matches_jax_frame_for_frame(tree):
    root, assets = tree
    got = ycbv.YCBVTestDataset(CFG, root, assets_dir=assets)
    want = jycbv.YCBVTestDataset(JCFG, root, assets_dir=assets)
    assert len(got) == len(want) == 4
    n_lost = 0
    for i in range(len(want)):
        g = _seeded(lambda: got[i], 10 + i)
        w = _seeded(lambda: want[i], 10 + i)
        assert_same(g, w, f"frame {i}")
        n_lost += len(w["lost"])
    assert n_lost == 1  # the fixture's one lost detection
    assert_same(got.model_points_array(), want.model_points_array())
    assert_same(got.template_bank(), want.template_bank())
    assert_same(got.invalid_row(), want.invalid_row())
    assert got.class_names == want.class_names
    frames = [_seeded(lambda: list(ds.frames(pad_to=4)), 9) for ds in (got, want)]
    assert_same(*frames, "frames()")


def test_train_dataset_matches_jax_with_both_cameras(tree):
    root, assets = tree
    got = ycbv.YCBVTrainDataset(CFG, root, assets_dir=assets)
    want = jycbv.YCBVTrainDataset(JCFG, root, assets_dir=assets)
    assert [p[:9] for p in got.list] == ["data/0001"] * 2 + ["data/0060"] * 2
    assert got._intrinsics(got.list[2]) is ycbv.CAM_2
    for i in range(len(want)):
        for seed in (3, 4):
            g = _seeded(lambda: got[i], seed * 100 + i)
            w = _seeded(lambda: want[i], seed * 100 + i)
            assert_same(g, w, f"frame {i} seed {seed}")
            assert g["valid"] == 1.0
    assert_same(got.template_bank(), want.template_bank())
    for c in want.pc_cad:
        assert_same(got.pc_cad[c], want.pc_cad[c])
        assert got.radius[c] == want.radius[c]


def test_cad_loading_restores_the_global_generator(tree):
    root, assets = tree
    np.random.seed(7)
    ycbv.YCBVTestDataset(CFG, root, assets_dir=assets)
    after = np.random.rand()
    np.random.seed(7)
    assert after == np.random.rand()


def test_eval_frame_loader_matches_jax(tree):
    root, assets = tree
    loaders = (EvalFrameLoader(ycbv.YCBVTestDataset(CFG, root, assets_dir=assets),
                               batch_size=4, num_workers=1),
               JaxEvalFrameLoader(jycbv.YCBVTestDataset(JCFG, root, assets_dir=assets),
                                  batch_size=4, num_workers=1, worker_type="thread"))
    got, want = (_seeded(lambda: list(loader), 5) for loader in loaders)
    assert len(got) == len(want) == 3  # 12 rows: 11 samples, 1 lost
    for g, w in zip(got, want):
        assert_same(g, w, "batch")
    valid = np.concatenate([b["valid"] for b in got])
    pad = np.concatenate([b["pad"] for b in got])
    assert int((valid == 0).sum()) == 1 and not pad.any()
    # a batch size that does not divide the rows: fill rows at the end
    (last,) = list(EvalFrameLoader(loaders[0].dataset, batch_size=16, num_workers=2))
    assert last["pad"].tolist() == [0.0] * 12 + [1.0] * 4
    assert last["valid"][12:].tolist() == [0.0] * 4


def test_synthetic_cad_dir_matches_jax(tree):
    _, assets = tree
    kw = dict(n_objects=0, n_points=128, unit_voxel_extent=(0.006,) * 3,
              voxel_num_limit=(64,) * 3, length=8, cad_dir=os.path.join(assets, "CADs"))
    got, want = SyntheticPoseDataset(**kw), JaxSynthetic(**kw)
    assert len(got.cad_points) == len(want.cad_points) == 3
    assert got.sym_flags == want.sym_flags == [0.0] * 3
    for i in range(4):
        assert_same(got[i], want[i], f"item {i}")
    assert_same(got.template_bank(), want.template_bank())
    with pytest.raises(FileNotFoundError):
        SyntheticPoseDataset(cad_dir=assets)


def test_tree_writer_pngs_decode_as_written():
    writer = _tree_writer()
    rng = np.random.RandomState(2)
    import io

    for arr in (rng.randint(0, 256, (70, 33, 3)).astype(np.uint8),
                rng.randint(0, 65536, (70, 33)).astype(np.uint16),
                rng.randint(0, 22, (7, 1)).astype(np.uint8),
                rng.randint(0, 256, (600, 640, 3)).astype(np.uint8)):  # several IDAT chunks
        data = writer.png_bytes(arr)
        np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(data))), arr)


def test_tree_writer_tree_reads_like_the_fixture(tmp_path):
    """A 21-class tree of the writer (the YCB-V class count, so the sym
    flags engage): its PNGs decode as PIL decodes them, and both packages'
    readers find every instance, one lost a frame."""
    info = _tree_writer().write_tree(str(tmp_path), n_classes=21, n_frames=2)
    root, assets = info["root"], info["assets"]
    for suffix in ("color", "depth", "label"):
        path = f"{root}/data/0001/000002-{suffix}.png"
        np.testing.assert_array_equal(png.imread(path), np.array(Image.open(path)))
    got = ycbv.YCBVTestDataset(CFG, root, assets_dir=assets)
    want = jycbv.YCBVTestDataset(JCFG, root, assets_dir=assets)
    rows = lost = 0
    for i in range(len(want)):
        g = _seeded(lambda: got[i], i)
        assert_same(g, _seeded(lambda: want[i], i), f"frame {i}")
        rows += len(g["samples"]) + len(g["lost"])
        lost += len(g["lost"])
        for s in g["samples"]:
            assert s["sym_flag"] == float(int(s["obj_idx"]) in ycbv.SYMMETRY_OBJ_IDX)
    assert (rows, lost) == (info["instances"], info["lost"]) == (42, 2)
    kw = dict(n_objects=0, n_points=64, length=4, cad_dir=os.path.join(assets, "CADs"))
    syn = SyntheticPoseDataset(**kw)
    assert syn.sym_flags == JaxSynthetic(**kw).sym_flags
    assert [i for i, f in enumerate(syn.sym_flags) if f] == ycbv.SYMMETRY_OBJ_IDX


@pytest.mark.parametrize("extra", [{"device_preprocess": True}, {"samples_per_frame": 2}])
def test_raw_mode_is_refused(tree, extra):
    """What raw-candidate mode refuses, as the JAX reader does or more
    strictly: the per-frame protocol iteration (frames() needs the numpy
    path), and samples_per_frame > 1 in a train reader without
    device_preprocess (the numpy path draws one instance a frame)."""
    root, assets = tree
    cfg = Config({**DS, **extra})
    if "device_preprocess" in extra:
        with pytest.raises(ValueError, match="numpy path"):
            next(ycbv.YCBVTestDataset(cfg, root, assets_dir=assets).frames())
        with pytest.raises(ValueError, match="numpy pipeline"):
            next(jycbv.YCBVTestDataset(JaxConfig({**DS, **extra}), root,
                                       assets_dir=assets).frames())
    else:
        with pytest.raises(ValueError, match="needs device_preprocess"):
            ycbv.YCBVTrainDataset(cfg, root, assets_dir=assets)


@pytest.mark.parametrize("kw", [{"worker_type": "fiber"}])
def test_eval_frame_loader_refuses_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError):
        EvalFrameLoader([], batch_size=4, **kw)
