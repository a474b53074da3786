"""The port's device-side preprocessing (dcl_net_tpu_torch/data/
device_preprocess.py) against the JAX package's on the CPU, at the 16^3
test shapes (24 mm voxels, 64 points, 256 candidates).

preprocess_core takes the same raw batch and the same injected draws (aug
angles, translation jitter, candidate indices) in both packages; the
outputs agree within 3e-5 (the JAX einsums at HIGHEST against f32 with TF32
off, and sums taken in other orders), the voxel indices exactly except
where a coordinate sits on a voxel boundary, where they may differ by one.
The cases: augmentation on and off; the eval keep-clamp at 32 (YCB-V test)
and at 0 (LM eval); LMO's min_points 0 without the clamp; a row without
candidates, a host-invalid row and a fill row. The production draws are
held to their contract: only kept candidates, distinct above N, with
replacement at N and below, as the host path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.data import device_preprocess as jdp
from dcl_net_tpu_torch.data import device_preprocess as dp
from dcl_net_tpu_torch.data.schema import DeviceBatch, batch_to_torch

torch.set_num_threads(2)

UNIT = 0.024
LIM = 16
N = 64
K = 256
TOL = 3e-5


def raw_samples(rng, n_rows=5):
    """Raw candidate samples: blobs near 1 m in front of the camera, one
    spread along depth so that only a few candidates lie in the volume
    (the keep-clamp decides it), one without candidates, one invalid."""
    out = []
    for i in range(n_rows):
        n = K if i % 2 == 0 else K - 37
        rows = rng.randint(200, 260, n)
        cols = rng.randint(300, 360, n)
        depth = rng.randint(9800, 10200, n)
        if i == 1:  # 20 candidates near the centroid, the rest far off
            depth[20:] = np.where(rng.rand(n - 20) < 0.5, 4000, 16000)
            depth[:20] = 10000
        cand_depth = np.zeros(K, np.uint16)
        cand_rc = np.zeros((K, 2), np.int16)
        cand_rgb = np.zeros((K, 3), np.uint8)
        cand_depth[:n], cand_rc[:n, 0], cand_rc[:n, 1] = depth, rows, cols
        cand_rgb[:n] = rng.randint(0, 256, (n, 3))
        s = {"cand_depth": cand_depth, "cand_rc": cand_rc, "cand_rgb": cand_rgb,
             "n_cand": np.int32(n),
             "cam": np.asarray([320.0, 240.0, 1066.0, 1067.0, 10000.0], np.float32),
             "tmp_feats": rng.randn(N, 7).astype(np.float32),
             "tmp_voxel_idx": rng.randint(0, LIM, (N, 3)).astype(np.int32),
             "rot_gt": np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32),
             "trans_gt": np.asarray([0.01, -0.02, 1.0], np.float32),
             "obj_idx": np.int32(i % 3), "sym_flag": np.float32(i % 2), "valid": 1.0,
             "radius": np.float32(0.05)}
        if i == 3:
            s["n_cand"] = np.int32(0)
        if i == 4:
            s["valid"] = 0.0
        out.append(s)
    return out


def draws(rng, raw):
    """Injected draws: angles, jitter, and N candidate indices per row
    below its candidate count."""
    b = raw["valid"].shape[0]
    angles = rng.uniform(-np.pi / 36, np.pi / 36, (b, 3)).astype(np.float32)
    tjit = rng.uniform(-0.03, 0.03, (b, 3)).astype(np.float32)
    idx = np.stack([rng.randint(0, max(int(c), 1), N) for c in raw["n_cand"]]).astype(np.int32)
    return angles, tjit, idx


def run_both(raw, angles, tjit, idx, **kw):
    keys = dp.RAW_KEYS
    static = dict(n_points=N, unit=(UNIT,) * 3, total=(UNIT * LIM,) * 3, limit=(LIM,) * 3, **kw)
    want = jdp.preprocess_core({k: jnp.asarray(raw[k]) for k in keys}, jnp.asarray(angles),
                               jnp.asarray(tjit), jnp.asarray(idx), None, **static)
    got = dp.preprocess_core({k: dp._to_device(raw[k], torch.device("cpu")) for k in keys},
                             torch.from_numpy(angles), torch.from_numpy(tjit),
                             torch.from_numpy(idx), None, **static)
    return {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()}


def assert_core_close(got, want):
    assert set(got) == set(want)
    for k in ("inp_feats", "rot_gt", "trans_gt"):
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["inp_voxel_idx"].dtype == np.int32
    diff = np.abs(got["inp_voxel_idx"].astype(np.int64) - want["inp_voxel_idx"])
    assert diff.max() <= 1
    # a flip only where the coordinate sits within TOL of a voxel boundary
    xyz = want["inp_feats"][..., 4:7]
    pos = (xyz + UNIT * LIM * 0.5) / UNIT
    near = np.abs(pos - np.round(pos)) * UNIT < TOL
    assert not (diff.astype(bool) & ~near).any()


def test_euler_xyz_to_matrix_matches_jax():
    rng = np.random.RandomState(0)
    angles = rng.uniform(-0.4, 0.4, (32, 3)).astype(np.float32)
    got = dp.euler_xyz_to_matrix(torch.from_numpy(angles)).numpy()
    want = np.asarray(jdp.euler_xyz_to_matrix(jnp.asarray(angles)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_make_raw_batch_matches_jax():
    """Invalid rows take the first valid row's inputs, fill rows too (pad
    1, valid 0); labels stay each row's own."""
    samples = raw_samples(np.random.RandomState(1))
    samples[0]["valid"] = 0.0  # the template is then row 1
    got, want = dp.make_raw_batch(samples, pad_to=8), jdp.make_raw_batch(samples, pad_to=8)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["cand_depth"][0], samples[1]["cand_depth"])
    np.testing.assert_array_equal(got["pad"], [0] * 5 + [1] * 3)
    with pytest.raises(ValueError):
        dp.make_raw_batch(samples, pad_to=3)


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("clamp", [None, 32, 0], ids=["min50", "clamp32", "clamp0"])
def test_core_matches_jax_with_injected_draws(augment, clamp):
    rng = np.random.RandomState(2)
    raw = dp.make_raw_batch(raw_samples(rng), pad_to=6)
    angles, tjit, idx = draws(rng, raw)
    kw = (dict(eval_keep_clamp=False, min_points=50) if clamp is None else
          dict(eval_keep_clamp=True, keep_clamp_threshold=clamp, min_points=50))
    got, want = run_both(raw, angles, tjit, idx, augment=augment, **kw)
    assert_core_close(got, want)
    if clamp is None:
        # row 1 keeps 20 of its candidates: invalid at min_points 50
        np.testing.assert_array_equal(got["valid"], [1, 0, 1, 0, 0, 0])
    else:
        np.testing.assert_array_equal(got["valid"], [1, 1, 1, 0, 0, 0])
    # invalid and fill rows carry row 0's inputs
    for r in (3, 4, 5):
        np.testing.assert_array_equal(got["inp_feats"][r], got["inp_feats"][0])


def test_core_matches_jax_lmo_min_points_0():
    """LMO: no keep-clamp; a row is invalid only when nothing survives the
    volume filter (min_points 0)."""
    rng = np.random.RandomState(3)
    samples = raw_samples(rng)
    samples[2]["cand_depth"][:] = np.where(samples[2]["cand_depth"] > 0, 30000, 0)
    raw = dp.make_raw_batch(samples)
    angles, tjit, idx = draws(rng, raw)
    got, want = run_both(raw, angles, tjit, idx, augment=False, eval_keep_clamp=False,
                         min_points=0)
    assert_core_close(got, want)
    # row 2 lies 3 m deep, centred: its candidates stay inside (centering),
    # so only the row without candidates and the host-invalid one drop
    np.testing.assert_array_equal(got["valid"], [1, 1, 1, 0, 0])


def kept_mask(rng, b, k, counts):
    keep = np.zeros((b, k), bool)
    for i, c in enumerate(counts):
        keep[i, rng.choice(k, c, replace=False)] = True
    return torch.from_numpy(keep)


def test_production_draws_come_from_kept_candidates():
    """Above N kept candidates: N distinct kept ones; at N and below: iid
    draws over the kept set (with replacement, as the host path and the
    reference draw at exactly N too), never an unkept one."""
    rng = np.random.RandomState(4)
    counts = [N + 1, N, N - 1, 3, 200, 1]
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        keep = kept_mask(rng, len(counts), K, counts)
        idx = dp._draw_cand_idx(keep, N, gen)
        assert idx.shape == (len(counts), N)
        assert bool(torch.gather(keep, 1, idx.long()).all())
        for row, c in enumerate(counts):
            distinct = len(set(idx[row].tolist()))
            if c > N:
                assert distinct == N
            else:
                assert distinct <= c
        assert len(set(idx[1].tolist())) < N  # with replacement at N


def test_production_draws_match_the_host_boundary():
    """The host path (data/preprocess.py::filter_and_resample) draws
    without replacement only above N; so does the device draw."""
    from dcl_net_tpu_torch.data import preprocess as pp

    cloud = np.zeros((N, 3), np.float32)
    rgb = np.zeros((N, 3), np.float32)
    cloud[:, 0] = np.arange(N) * 1e-4
    host = pp.filter_and_resample(cloud, rgb, np.full(3, 1.0, np.float32), N,
                                  np.random.RandomState(0), 0)[0][:, 0]
    assert len(set(host.tolist())) < N
    keep = torch.ones((1, N), dtype=torch.bool)
    dev = dp._draw_cand_idx(keep, N, torch.Generator().manual_seed(1))
    assert len(set(dev[0].tolist())) < N
    keep = torch.ones((1, N + 1), dtype=torch.bool)
    dev = dp._draw_cand_idx(keep, N, torch.Generator().manual_seed(1))
    assert len(set(dev[0].tolist())) == N


@pytest.mark.parametrize("augment", [False, True])
def test_device_preprocessor_batch_matches_jax_layout(augment):
    """DevicePreprocessor on the CPU: the JAX preprocessor's batch keys,
    shapes, types and validity; seeded draws repeat; batch_to_torch takes
    the DeviceBatch without a copy."""
    rng = np.random.RandomState(5)
    raw = dp.make_raw_batch(raw_samples(rng), pad_to=6)
    kw = dict(n_points=N, unit_voxel_extent=(UNIT,) * 3, voxel_num_limit=(LIM,) * 3,
              augment=augment, min_points=50)
    got = dp.DevicePreprocessor(seed=3, device="cpu", **kw)(raw)
    again = dp.DevicePreprocessor(seed=3, device="cpu", **kw)(raw)
    want = jdp.DevicePreprocessor(seed=3, **kw)(raw)
    assert isinstance(got, DeviceBatch)

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, v

    got_f, want_f, again_f = dict(flat(got)), dict(flat(want)), dict(flat(again))
    assert set(got_f) == set(want_f)
    for k, w in want_f.items():
        w = np.asarray(w)
        assert tuple(got_f[k].shape) == w.shape, k
        assert got_f[k].numpy().dtype == w.dtype, k
        assert torch.equal(got_f[k], again_f[k]), k
    np.testing.assert_array_equal(got["valid"].numpy(), want_f["valid"])
    for k in ("tmp.feats", "labels.obj_idx", "sym_flag", "pad"):
        np.testing.assert_array_equal(got_f[k].numpy(), np.asarray(want_f[k]))
    # the draws lie in the kept set: the points sit inside the volume
    pts = got["inp"]["feats"][..., 4:7][got["valid"] > 0]
    assert bool((pts.abs() < UNIT * LIM / 2).all())
    moved = batch_to_torch(got, "cpu")
    assert moved["inp"]["feats"].data_ptr() == got["inp"]["feats"].data_ptr()
