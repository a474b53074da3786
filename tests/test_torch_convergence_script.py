"""scripts/torch_synthetic_convergence.py at a small size on the CPU.

Its body runs at a 16^3 grid (the volume of the 64^3 grid at 6 mm), 64
points, batch 4, 2 stage-1 steps and 1 refiner step, bar 0. The result
carries the JAX script's keys; its identity-pose baseline equals the one
the JAX script computes from the JAX package's SyntheticPoseDataset and
metrics on the same held-out rows (the split and the metric are copies);
the weights that --save writes load through scripts/bf16_fullwidth_drift.py
--weights; and the bars pass or fail as the JAX script's assertions do.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bf16_fullwidth_drift  # noqa: E402
import torch_synthetic_convergence as conv  # noqa: E402

torch.set_num_threads(4)

SIDE, N = 16, 64
JAX_KEYS = {"protocol", "config", "samples_per_frame", "steps", "batch", "identity_auc",
            "stage1_auc", "stage2_auc", "wall_min"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    save = tmp_path_factory.mktemp("weights")
    args = conv.parse_args(["--steps", "2", "--stage2-steps", "1", "--batch", "4",
                            "--auc-bar", "0", "--workers", "1", "--worker-type", "thread",
                            "--device", "cpu", "--save", str(save)])
    return args, conv.run(args, grid_side=SIDE, n_points=N, log=lambda s: None), save


def test_result_has_the_jax_keys(run):
    args, res, _ = run
    assert JAX_KEYS <= set(res)
    assert res["steps"] == 2 and res["batch"] == 4 and res["config"] == "per-instance"
    assert res["samples_per_frame"] is None and res["protocol"] == "adds_auc"
    for k in ("identity_auc", "stage1_auc", "stage2_auc"):
        assert 0.0 <= res[k] <= 100.0, k
    assert res["evals"] == [[2, res["stage1_auc"]]]
    assert res["losses"][-1][0] == 2 and np.isfinite(res["losses"][-1][1])
    assert res["loader_wait_s"] >= 0.0 and res["samples_per_s"] > 0.0
    d = res["bf16_drift"]
    assert all(np.isfinite(v) and v >= 0.0 for v in d.values())
    assert conv.bars(res, 0.0) == {"stage1 >= 0.0": True}


def test_identity_baseline_equals_the_jax_scripts(run):
    """The JAX script's baseline (scripts/train_synthetic_convergence.py),
    computed from the JAX package on the same held-out rows."""
    from dcl_net_tpu.data.schema import make_batch
    from dcl_net_tpu.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu.eval.metrics import add_s_batch, per_class_auc_acc

    _, res, _ = run
    unit = (conv.UNIT_AT_64 * 64 / SIDE,) * 3
    heldout = SyntheticPoseDataset(n_objects=8, n_points=N, unit_voxel_extent=unit,
                                   voxel_num_limit=(SIDE,) * 3,
                                   length=conv.TRAIN_LEN + conv.HELD_LEN, seed=0)
    model_points = np.stack([heldout.model_points(c, 256) for c in range(8)])
    dists, clss = [], []
    for k in range(4):
        b = make_batch([heldout[conv.TRAIN_LEN + k * 128 + i] for i in range(128)]).to_dict()
        pts = jnp.asarray(model_points)[b["labels"]["obj_idx"]]
        eye = jnp.tile(jnp.eye(3)[None], (pts.shape[0], 1, 1))
        adds = np.asarray(add_s_batch(pts, eye, jnp.zeros((pts.shape[0], 3)),
                                      jnp.asarray(b["labels"]["rot_gt"]),
                                      jnp.asarray(b["labels"]["trans_gt"])))
        dists += [float(x) for x in adds]
        clss += [int(c) for c in b["labels"]["obj_idx"]]
    want = per_class_auc_acc(dists, clss, num_classes=8)["auc_mean"]
    # the ADD-S distances of the two packages differ in their last f32 bits
    assert res["identity_auc"] == pytest.approx(want, abs=1e-6)


def test_saved_weights_load_through_the_drift_script(run):
    from dcl_net_tpu_torch.models import DCLNet, Refiner
    from dcl_net_tpu_torch.tools.common import load_model_weights
    from dcl_net_tpu_torch.train.checkpoints import load_checkpoint

    _, _, save = run
    stage1 = save / "stage1" / "epoch_2"
    saved = load_checkpoint(str(stage1))
    assert saved["opt_state"] == {} and saved["step"] == 2
    width = dict(unit_voxel_extent=(conv.UNIT_AT_64 * 64 / SIDE,) * 3,
                 voxel_num_limit=(SIDE,) * 3, interp_mode="pallas", device="cpu", seed=0)
    models = {"f32": DCLNet(**width), "bf16": DCLNet(dtype=torch.bfloat16, **width)}
    seeded = {k: v.clone() for k, v in models["f32"].state_dict().items()}
    bf16_fullwidth_drift.load_weights(models, str(stage1))
    for m in models.values():
        state = m.state_dict()
        assert all(torch.equal(state[k], v) for k, v in saved["model"].items())
    assert any(not torch.equal(seeded[k], v) for k, v in saved["model"].items())
    refiner = load_model_weights(Refiner(n_inp=N, device="cpu", seed=7),
                                 str(save / "stage2" / "epoch_1"))
    assert isinstance(refiner, Refiner)


@pytest.mark.parametrize("res, ok", [
    ({"stage1_auc": 95.0, "stage2_auc": 94.6, "identity_auc": 83.9}, [True, True, True]),
    ({"stage1_auc": 89.9, "stage2_auc": 95.0, "identity_auc": 70.0}, [False, True, True]),
    ({"stage1_auc": 92.0, "stage2_auc": 91.4, "identity_auc": 83.0}, [True, False, False]),
], ids=["pass", "below-bar", "near-identity-stage2-worse"])
def test_bars_are_the_jax_scripts_assertions(res, ok):
    assert list(conv.bars(res, 90.0).values()) == ok


def _build(*argv):
    args = conv.parse_args(["--batch", "4", "--workers", "1", "--worker-type", "thread",
                            "--device", "cpu", *argv])
    return conv.build(args, grid_side=SIDE, n_points=N)


def test_seed_changes_the_weights_and_shuffle_not_the_split():
    """--seed 1 draws other weights and another shuffle; the datasets stay at
    seed 0, as in the JAX script, so the held-out rows and the identity
    baseline are seed 0's."""
    runs = {seed: _build("--seed", str(seed)) for seed in (0, 1)}
    a, b = runs[0].model.state_dict(), runs[1].model.state_dict()
    assert any(not torch.equal(a[k], b[k]) for k in a if a[k].is_floating_point())
    assert (runs[0].loader.seed, runs[1].loader.seed) == (0, 1)
    for x, y in zip(runs[0].eval_batches, runs[1].eval_batches):
        for k in ("feats", "voxel_idx"):
            np.testing.assert_array_equal(x["inp"][k], y["inp"][k])
        np.testing.assert_array_equal(x["labels"]["rot_gt"], y["labels"]["rot_gt"])
    np.testing.assert_array_equal(runs[0].model_points, runs[1].model_points)
    assert conv.parse_args([]).seed == 0  # the default run is the seed-0 run


def test_cad_dir_reads_the_clouds_of_a_directory(tmp_path):
    """--cad-dir: the *_pc.ply clouds of a directory in place of the
    procedural shapes; --classes 0 takes every cloud found."""
    from tests.fixtures import _write_ply_ascii

    rng = np.random.RandomState(5)
    clouds = []
    for name in ("002_master_chef_can", "003_cracker_box", "004_sugar_box"):
        pts = ((rng.rand(300, 3) - 0.5) * 0.08).astype(np.float32)
        _write_ply_ascii(str(tmp_path / f"{name}_pc.ply"), pts,
                         rng.randint(0, 256, (300, 3)).astype(np.uint8))
        clouds.append(pts)
    w = _build("--cad-dir", str(tmp_path), "--classes", "0")
    assert w.n_classes == 3 and w.model_points.shape[0] == 3
    for got, want in zip(w.train_ds.cad_points, clouds):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    cls = np.concatenate([b["labels"]["obj_idx"] for b in w.eval_batches])
    assert set(cls.tolist()) == {0, 1, 2}
    assert conv.parse_args(["--cad-dir", str(tmp_path)]).cad_dir == str(tmp_path)
