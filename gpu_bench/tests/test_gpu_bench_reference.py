"""The frozen reference against the program's plain CPU path at 16^3, and
the harness's comparison on the CPU: each cell of BENCHMARK.json, cut to a
small size, comes out correct, and comes out not correct once the timed
path is broken underneath it."""

import numpy as np
import pytest
import torch

from gpu_bench.harness import check
from gpu_bench.reference import model as ref
from gpu_bench.tests.small import SEED, run_small, small_cell


def test_reference_forward_matches_the_program_at_16():
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from gpu_bench.harness.data import Objects, stack_batch
    from gpu_bench.harness.weights import make_weights, shapes_of

    cell = small_cell("ycbv-train-b32")
    model = DCLNet.from_config(cell.config["model"], device="cpu")
    w = make_weights(shapes_of(model), SEED, "cpu")
    model.load_state_dict(w)
    batch = stack_batch(Objects(cell.config, SEED).rows(SEED, 1, 4))
    tb = check._as_device(batch, "cpu")
    for train in (False, True):
        model.train(train)
        with torch.no_grad():
            got = model(tb)
        enc = [ref.encode(tb[s]["feats"], tb[s]["voxel_idx"], w, s, cell.config["model"], train)
               for s in ("inp", "tmp")]
        want = ref.fuse(*enc, w, train)
        for k in ("rot_pred", "trans_pred", "conf", "Xo_pred", "Yc_pred"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=f"{k} train={train}")
        assert torch.equal(got["overflow"], want["overflow"])


@pytest.mark.parametrize("name", ["ycbv-eval-b512", "ycbv-train-b32", "lm-serve-frames"])
def test_a_small_cell_is_correct(name):
    _, res, numbers, correct = run_small(name)
    assert res.units >= 1
    assert correct, numbers


def _alter_one_answer(monkeypatch):
    """The fault "an answer altered where it is produced": row 0's rotation
    and translation off, as the fuse returns them."""
    from dcl_net_tpu_torch.models import dcl_net

    fuse = dcl_net.DCLNet.fuse

    def altered(self, obs, tmp):
        out = dict(fuse(self, obs, tmp))
        rot = out["rot_pred"].clone()
        rot[0] = rot[0][[1, 2, 0]]
        out["rot_pred"] = rot
        out["trans_pred"] = out["trans_pred"] + 0.01 * (
            torch.arange(len(rot), device=rot.device) == 0)[:, None]
        return out

    monkeypatch.setattr(dcl_net.DCLNet, "fuse", altered)


def _half_the_rows(monkeypatch):
    """The fault "half of the batch left out": the second half of the rows
    are given the first half's answers."""
    from dcl_net_tpu_torch.models import dcl_net

    fuse = dcl_net.DCLNet.fuse

    def half(self, obs, tmp):
        out = dict(fuse(self, obs, tmp))
        b = out["rot_pred"].shape[0]
        for k in ("rot_pred", "trans_pred"):
            v = out[k].clone()
            v[b // 2:b // 2 * 2] = v[:b // 2]
            out[k] = v
        return out

    monkeypatch.setattr(dcl_net.DCLNet, "fuse", half)


@pytest.mark.parametrize("name", ["ycbv-eval-b512", "lm-serve-frames"])
@pytest.mark.parametrize("fault", [_alter_one_answer, _half_the_rows])
def test_a_broken_answer_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    _, _, numbers, correct = run_small(name)
    assert not correct, numbers


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from dcl_net_tpu_torch.train import solver

    update = solver.Optimizer.update

    def no_step(self, grad, norm, state):
        upd, new = update(self, grad, norm, state)
        return torch.zeros_like(upd), new

    monkeypatch.setattr(solver.Optimizer, "update", no_step)
    _, _, numbers, correct = run_small("ycbv-train-b32")
    assert not correct and numbers["change_leaf_gap"] >= 0.99


def test_half_the_batch_with_the_mean_over_the_rest_is_not_correct(monkeypatch):
    from dcl_net_tpu_torch.models import dcl_net

    losses = dcl_net.dcl_losses

    def half(pred, batch):
        b = dict(batch)
        v = b["valid"].clone()
        v[v.shape[0] // 2:] = 0.0
        b["valid"] = v
        return losses(pred, b)

    monkeypatch.setattr(dcl_net, "dcl_losses", half)
    _, _, numbers, correct = run_small("ycbv-train-b32")
    assert not correct, numbers
