"""The port's solver pieces against the JAX package's: AutoClip, the LR
schedules, the optimizer chain, whole train steps, the non-finite skip,
checkpoints and the batch loader.

Whole steps run in f64 on both sides (JAX under enable_x64), for the reason
given in tests/test_torch_train_model.py: in f32 the gradient of the small
network is ill-conditioned. Even in f64 the two gradients differ by ~1e-5
of a leaf's scale (JAX's SVD JVP), and Adam maps a gradient entry g to
about g / (|g| + eps) of the step, so with the configs' eps = 1e-6 every
entry whose gradient is below that difference may take a step of either
sign. The whole-step test therefore takes eps = 1 (the update is then
close to linear in the gradient); the optimizer chain itself is compared
with the configs' eps on identical gradients.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dcl_net_tpu.config import Config as JaxConfig
from dcl_net_tpu.models import dcl_losses as jax_dcl_losses
from dcl_net_tpu.train import solver as jsolver
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data.loader import BatchLoader
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
from dcl_net_tpu_torch.train import solver as tsolver
from dcl_net_tpu_torch.train.checkpoints import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from dcl_net_tpu_torch.weights import load_jax_variables, to_jax_variables
from tests.test_torch_train_model import (
    GRID,
    KW,
    N,
    UNIT,
    as_f64,
    build_setup,
    leaves,
    torch_batch,
)

torch.set_num_threads(2)

OPT_CFG = {
    "optimizer": {"type": "Adam", "lr": 0.001, "betas": [0.5, 0.999], "eps": 1e-6},
    "lr_scheduler_cyc": {"max_lr": 0.001, "base_lr": 1e-6, "step_size_up": 3,
                         "step_size_down": 2},
    "clip_percentile": 50,
}


def test_autoclip_matches_jax_over_a_wrapping_ring():
    norms = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.3, 0.5, 8.9, 7.9, 3.2]
    for pct in (50.0, 25.0, 90.0):
        jclip = jsolver.autoclip(percentile=pct, history_len=4)
        jstate = jclip.init(None)
        tclip = tsolver.AutoClip(percentile=pct, history_len=4)
        tstate = tclip.init()
        for norm in norms:
            upd, jstate = jclip.update({"g": jnp.asarray([norm], jnp.float32)}, jstate)
            scale, tstate = tclip(torch.tensor(norm), tstate)
            # the same f32 arithmetic: equal to rounding of the last operation
            np.testing.assert_allclose(float(scale) * norm, float(upd["g"][0]),
                                       rtol=1e-6)
            np.testing.assert_array_equal(tstate["history"].numpy(),
                                          np.asarray(jstate.history))
            assert int(tstate["count"]) == int(jstate.count)


def test_lr_schedules_match_jax():
    steps = np.arange(0, 40)
    pairs = [
        (tsolver.cyclic_lr(1e-6, 1e-3, 7, 5), jsolver.cyclic_lr(1e-6, 1e-3, 7, 5)),
        (tsolver.cyclic_lr(1e-6, 1e-3, 6), jsolver.cyclic_lr(1e-6, 1e-3, 6)),
        (tsolver.step_lr(1e-3, 8, 0.5), jsolver.step_lr(1e-3, 8, 0.5)),
    ]
    for tsched, jsched in pairs:
        got = tsched(torch.as_tensor(steps)).numpy()
        want = np.asarray(jsched(jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert float(tsched(5)) == pytest.approx(float(jsched(5)), rel=1e-6)
    step_cfg = {"optimizer": {"lr": 0.01},
                "lr_scheduler": {"type": "StepLR", "step_size": 2, "gamma": 0.1}}
    for cfg in (OPT_CFG, step_cfg, {"optimizer": {"lr": 0.01}}):
        got = tsolver.build_lr_schedule(Config(cfg), 4)(torch.as_tensor(steps)).numpy()
        want = np.asarray(jsolver.build_lr_schedule(JaxConfig(cfg), 4)(jnp.asarray(steps)))
        np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=1e-6)


def test_optimizer_chain_matches_optax_on_the_same_gradients():
    rng = np.random.RandomState(9)
    tx, _ = jsolver.build_optimizer(JaxConfig(OPT_CFG), 1)
    opt, _ = tsolver.build_optimizer(Config(OPT_CFG), 1)
    params = {"a": rng.randn(40).astype(np.float32), "b": rng.randn(7, 3).astype(np.float32)}
    jstate = tx.init(params)
    tstate = opt.init(61)
    for k in range(6):
        # norms that rise and fall, so AutoClip clips some steps
        scale = (1.0, 5.0, 0.5, 8.0, 2.0, 0.1)[k]
        grads = {n: (rng.randn(*v.shape) * scale).astype(np.float32)
                 for n, v in params.items()}
        want, jstate = tx.update(grads, jstate, params)
        flat = torch.from_numpy(np.concatenate([grads["a"], grads["b"].ravel()]))
        got, tstate = opt.update(flat, torch.sqrt(torch.sum(flat * flat)), tstate)
        want_flat = np.concatenate([np.asarray(want["a"]), np.asarray(want["b"]).ravel()])
        # the same f32 formulas; pow and the norm round differently: 1e-5,
        # and 1e-9 (a millionth of the learning rate) where mu nearly cancels
        np.testing.assert_allclose(got.numpy(), want_flat, rtol=1e-5, atol=1e-9)
    clip_state, adam_state = jstate[0], jstate[1]
    np.testing.assert_allclose(tstate["clip_history"].numpy(),
                               np.asarray(clip_state.history), rtol=1e-6)
    assert int(tstate["count"]) == int(adam_state.count) == int(clip_state.count) == 6
    np.testing.assert_allclose(tstate["mu"].numpy(), np.concatenate(
        [np.asarray(adam_state.mu["a"]), np.asarray(adam_state.mu["b"]).ravel()]),
        rtol=1e-5, atol=1e-7)  # f32 rounding of moments of size ~1


STEP_CFG = dict(OPT_CFG, optimizer=dict(OPT_CFG["optimizer"], eps=1.0),
                lr_scheduler_cyc={"max_lr": 0.001, "base_lr": 0.0001,
                                  "step_size_up": 2, "step_size_down": 2})


def _jax_steps(jmodel, variables, batch, n_steps):
    tx, _ = jsolver.build_optimizer(JaxConfig(STEP_CFG), 1)
    step = jax.jit(jsolver.make_train_step(jmodel, tx, jax_dcl_losses))
    state = jsolver.TrainState(step=jnp.zeros((), jnp.int32),
                               params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]))
    jb = jax.tree.map(jnp.asarray, batch)
    out = []
    for _ in range(n_steps):
        state, metrics = step(state, jb)
        out.append((jax.tree.map(np.asarray, state.params),
                    jax.tree.map(np.asarray, state.batch_stats),
                    {k: float(v) for k, v in metrics.items()}))
    return out


def test_train_steps_match_jax_make_train_step():
    jmodel, variables, batch, _ = build_setup()
    v64, b64 = as_f64(variables), as_f64(batch)
    with jax.enable_x64(True):
        want = _jax_steps(jmodel, v64, b64, 3)
    model = load_jax_variables(DCLNet(device="cpu", **KW), v64).double()
    opt, _ = tsolver.build_optimizer(Config(STEP_CFG), 1)
    step = tsolver.make_train_step(model, opt, dcl_losses)
    numel = sum(p.numel() for p in model.parameters())
    state = tsolver.TrainState(opt.init(numel))
    tb = torch_batch(batch, torch.float64)
    for k, (want_params, want_stats, want_metrics) in enumerate(want):
        metrics = step(state, tb)
        assert state.step == k + 1
        if k not in (0, 2):
            continue  # parameters after 1 and 3 steps
        got = to_jax_variables(model)
        # f64, eps = 1: after 3 steps the parameters agree to ~1e-7, a
        # ten-thousandth of the learning rate (1e-3); held to 1e-6
        for path, w in leaves(want_params):
            g = dict(leaves(got["params"]))[path]
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg="/".join(path))
        for path, w in leaves(want_stats):
            g = dict(leaves(got["batch_stats"]))[path]
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg="/".join(path))
        for key in ("loss_all", "grad_norm", "overflow_frac", "skipped_nonfinite"):
            np.testing.assert_allclose(float(metrics[key]), want_metrics[key],
                                       rtol=1e-5, err_msg=key)


def _tiny():
    ds = SyntheticPoseDataset(n_objects=2, n_points=64, unit_voxel_extent=UNIT,
                              voxel_num_limit=GRID, seed=0, length=6)
    return ds, DCLNet(device="cpu", seed=3, **KW)


def _snapshot(model, state):
    return ([t.clone() for t in model.state_dict().values()],
            {k: v.clone() for k, v in state.opt_state.items()})


def test_nonfinite_step_leaves_every_piece_of_state_unchanged():
    ds, model = _tiny()
    opt, _ = tsolver.build_optimizer(Config(OPT_CFG), 1)
    step = tsolver.make_train_step(model, opt, dcl_losses)
    state = tsolver.TrainState(opt.init(sum(p.numel() for p in model.parameters())))
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch

    batch = make_batch([ds[0], ds[1]]).to_dict()
    good = step(state, batch_to_torch(batch, "cpu"))
    assert float(good["skipped_nonfinite"]) == 0.0
    before_model, before_opt = _snapshot(model, state)
    bad = dict(batch, labels=dict(batch["labels"]))
    bad["labels"]["trans_gt"] = batch["labels"]["trans_gt"].copy()
    bad["labels"]["trans_gt"][0, 0] = np.nan
    metrics = step(state, batch_to_torch(bad, "cpu"))
    assert float(metrics["skipped_nonfinite"]) == 1.0
    assert not np.isfinite(float(metrics["loss_all"]))
    assert state.step == 2  # the step counts, nothing else moves
    after_model, after_opt = _snapshot(model, state)
    # parameters and BN running statistics (the forward wrote them)
    for a, b in zip(before_model, after_model):
        assert torch.equal(a, b)
    # Adam moments and count, the AutoClip ring
    assert set(before_opt) == set(after_opt) == {"clip_history", "count", "mu", "nu"}
    for k in before_opt:
        assert torch.equal(before_opt[k], after_opt[k]), k
    # and the next finite step proceeds from there
    assert float(step(state, batch_to_torch(batch, "cpu"))["skipped_nonfinite"]) == 0.0
    assert int(state.opt_state["count"]) == 2


def test_checkpoint_round_trip_and_solver_restore(tmp_path):
    ds, model = _tiny()
    cfg = Config(dict(OPT_CFG, max_epoch=1, per_write=1, per_save=1,
                      per_save_steps=2))
    loader = BatchLoader(ds, batch_size=2, num_workers=2, seed=1)
    solver = tsolver.Solver(model, dcl_losses, cfg, loader, device="cpu",
                            checkpoint_dir=str(tmp_path))
    solver.initialize()
    solver.solve()
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_1")
    mid = load_checkpoint(str(tmp_path / "epoch_0"))  # step 2 of epoch 0
    assert mid["meta"]["consumed_batches"] == 3 and mid["step"] == 3
    end = load_checkpoint(str(tmp_path / "epoch_1"))
    assert end["meta"]["consumed_batches"] == 0 and end["step"] == 3
    _, fresh = _tiny()
    other = tsolver.Solver(fresh, dcl_losses, cfg,
                           BatchLoader(ds, batch_size=2, num_workers=2, seed=1),
                           device="cpu")
    other.initialize()
    other.restore(str(tmp_path / "epoch_1"))
    assert other.epoch == 1 and other.state.step == 3
    for (n, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n
    for k, v in solver.state.opt_state.items():
        assert torch.equal(v, other.state.opt_state[k]), k
    # a mid-epoch checkpoint makes the loader skip the consumed batches
    other.restore(str(tmp_path / "epoch_0"))
    assert other.epoch == 0 and other.loader.skip_next == 3
    save_checkpoint(str(tmp_path), fresh, other.state, 7, meta={"consumed_batches": 1})
    assert latest_checkpoint(str(tmp_path)).endswith("epoch_7")


def test_batch_loader_order_padding_and_skip():
    class Items:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            ds_item = base[i % 2]
            return dict(ds_item, obj_idx=np.int32(i))

    base = [SyntheticPoseDataset(n_objects=2, n_points=16, length=2)[i] for i in range(2)]
    loader = BatchLoader(Items(), batch_size=3, num_workers=2, seed=5)
    assert len(loader) == 2
    first = [b["labels"]["obj_idx"].tolist() for b in loader]
    order = np.arange(7)
    np.random.RandomState(5).shuffle(order)
    assert first == [order[:3].tolist(), order[3:6].tolist()]
    loader.epoch = 0
    loader.skip_next = 1
    assert [b["labels"]["obj_idx"].tolist() for b in loader] == first[1:]
    assert loader.skip_next == 0 and loader.epoch == 1
    keep = BatchLoader(Items(), batch_size=3, shuffle=False, drop_last=False)
    batches = list(keep)
    assert len(batches) == 3
    assert batches[-1]["pad"].tolist() == [0.0, 1.0, 1.0]  # padded to the batch
    assert batches[-1]["valid"].tolist() == [1.0, 0.0, 0.0]


@pytest.mark.parametrize("entry", ["Solver", "make_train_step", "make_stage2_train_step"])
def test_training_entry_points_turn_tf32_off(entry, monkeypatch):
    """Training runs in f32: building a Solver or a train step directly turns
    off TF32 for matmuls and cuDNN convolutions (both on before)."""
    from dcl_net_tpu_torch.models.refiner import Refiner
    from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    ds, model = _tiny()
    opt, _ = tsolver.build_optimizer(Config(OPT_CFG), 1)
    if entry == "Solver":
        cfg = Config(dict(OPT_CFG, max_epoch=1, per_write=1, per_save=0))
        tsolver.Solver(model, dcl_losses, cfg, BatchLoader(ds, batch_size=2, num_workers=1),
                       device="cpu")
    elif entry == "make_train_step":
        tsolver.make_train_step(model, opt, dcl_losses)
    else:
        make_stage2_train_step(model, Refiner(n_inp=64, device="cpu"), opt, 2,
                               torch.zeros(2, 8, 3))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
