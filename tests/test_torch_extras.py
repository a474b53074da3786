"""The port's extras (dcl_net_tpu_torch/ops/extras.py) against the JAX package's.

Every function of dcl_net_tpu/ops/extras.py on the same numpy-seeded
inputs: the numpy ones (nms, points_to_voxel and VoxelGenerator, including
the scan that stops at max_voxels, ballquery_batch_p, bfs_cluster,
get_iou) exact; the torch ones (sparse_field_max_pool, sec_mean, sec_min,
sec_max, roipool) within 1e-6, their integer and mask outputs exact, with
empty segments and a segment-less tail row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.ops import extras as jx
from dcl_net_tpu_torch.ops import extras as tx

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def _assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_nms_matches_jax():
    rng = np.random.RandomState(0)
    xy = rng.rand(60, 2) * 20
    boxes = np.concatenate([xy, xy + rng.rand(60, 2) * 6 + 1], -1).astype(np.float32)
    boxes[5] = boxes[4]  # an exact duplicate (iou 1)
    boxes[7] = boxes[6] + np.float32([10, 0, 10, 0])  # touching edges: no overlap
    scores = rng.rand(60).astype(np.float32)
    for kw in (dict(), dict(pre_max_size=30, post_max_size=8)):
        for thr in (0.1, 0.5, 1.0):
            _assert_same(tx.nms(boxes, scores, thr, **kw), jx.nms(boxes, scores, thr, **kw))


@pytest.mark.parametrize("max_voxels", [20000, 12])
def test_points_to_voxel_and_generator_match_jax(max_voxels):
    rng = np.random.RandomState(1)
    pts = np.concatenate([rng.rand(400, 3) * 4 - 0.5, rng.rand(400, 1)], -1).astype(np.float32)
    args = ([0.5, 0.5, 0.5], [0, 0, 0, 3, 3, 3])
    _assert_same(tx.points_to_voxel(pts, *args, max_points=5, max_voxels=max_voxels),
                 jx.points_to_voxel(pts, *args, max_points=5, max_voxels=max_voxels))
    tg, jg = (m.VoxelGenerator(*args, max_num_points=5, max_voxels=max_voxels) for m in (tx, jx))
    np.testing.assert_array_equal(tg.grid_size, jg.grid_size)
    _assert_same(tg.generate(pts), jg.generate(pts))


@pytest.mark.parametrize("kernel, stride", [(3, 2), (2, 2), (3, 1)])
def test_sparse_field_max_pool_matches_jax(kernel, stride):
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 7, 7, 7, 3, 4).astype(np.float32)
    mask = (rng.rand(2, 7, 7, 7) < 0.4).astype(np.float32)
    mask[1, -3:, -3:, -3:] = 0.0
    want = jx.sparse_field_max_pool(jnp.asarray(feats), jnp.asarray(mask), kernel, stride)
    got = tx.sparse_field_max_pool(T(feats), T(mask), kernel, stride)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("name", ["sec_mean", "sec_min", "sec_max"])
def test_segment_reductions_match_jax(name):
    rng = np.random.RandomState(3)
    feats = rng.randn(23, 5).astype(np.float32)
    # segments of 4, 0 (empty), 7, 1 and 10 rows; the last row past them all
    offsets = np.array([0, 4, 4, 11, 12, 22], np.int32)
    want = getattr(jx, name)(jnp.asarray(feats), jnp.asarray(offsets), 6)
    got = getattr(tx, name)(T(feats), T(offsets), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_roipool_matches_jax():
    rng = np.random.RandomState(4)
    feats = rng.randn(30, 6).astype(np.float32)
    offsets = np.array([0, 5, 5, 17, 30], np.int32)
    want = jx.roipool(jnp.asarray(feats), jnp.asarray(offsets))
    got = tx.roipool(T(feats), T(offsets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ball_query_bfs_cluster_and_iou_match_jax():
    rng = np.random.RandomState(5)
    xyz = rng.rand(90, 3).astype(np.float32)
    offsets = np.array([0, 40, 90], np.int32)
    got = tx.ballquery_batch_p(xyz, offsets, 0.2, 16)
    _assert_same(got, jx.ballquery_batch_p(xyz, offsets, 0.2, 16))
    labels = rng.randint(0, 3, 90)
    ball_idx, start_len = got
    for threshold in (1, 3):
        _assert_same(tx.bfs_cluster(labels, ball_idx, start_len, threshold),
                     jx.bfs_cluster(labels, ball_idx, start_len, threshold))
    cluster_idx, cluster_offsets = tx.bfs_cluster(labels, ball_idx, start_len, 3)
    inst = rng.randint(-1, 4, 90)
    inst[inst < 0] = -100
    pointnum = np.array([(inst == i).sum() for i in range(4)], np.int32)
    _assert_same(tx.get_iou(cluster_idx, cluster_offsets, inst, pointnum),
                 jx.get_iou(cluster_idx, cluster_offsets, inst, pointnum))


@pytest.mark.parametrize("module", [
    "ops", "ops.extras", "ops.pointnet_modules", "ops.knn", "ops.sparse_conv", "ops.voxelize",
    "ops.cpu_voxelizer", "ops.grid_interp", "geometry", "geometry.rotation",
    "geometry.transform", "geometry.wigner"])
def test_every_public_function_of_the_jax_module_has_a_counterpart(module):
    """Each public function or class that the JAX module defines or
    exports has one of the same name in the port's module (the *_jax
    functions of wigner.py are *_torch there); what holds each to its JAX
    function are the tests of tests/test_torch_*.py."""
    import importlib
    import inspect

    jmod = importlib.import_module(f"dcl_net_tpu.{module}")
    tmod = importlib.import_module(f"dcl_net_tpu_torch.{module}")
    names = [n for n, v in vars(jmod).items()
             if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
             and (v.__module__.startswith("dcl_net_tpu.") or module in ("ops", "geometry"))]
    assert names
    for n in names:
        port_name = n[:-4] + "_torch" if n.endswith("_jax") else n
        assert callable(getattr(tmod, port_name, None)), f"{module}.{port_name}"
