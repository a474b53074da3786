"""model.remat (the backbones under torch.utils.checkpoint) is a trade of
memory for compute and nothing else, on the CPU at 16^3, in f32 and bf16:
one train-mode forward and backward gives the same loss (torch.equal) and
gradients (within 1e-6 of the largest entry of a leaf) with and without it,
and after one train step (make_train_step: the Solver's step) the BN
running statistics are equal, so the recomputation does not update them a
second time; a non-finite step restores them as without remat. The JAX
counterpart is tests/test_model.py::test_remat_matches_baseline_loss_and_grads.
Also the train-mode MaskedBatchNorm that keeps only its input and the
statistics for the backward (the other half of the large-batch memory),
against autograd of its expression.
"""

import pytest
import torch

from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
from dcl_net_tpu_torch.train.solver import (
    TrainState, bn_statistics, build_optimizer, make_train_step,
)

torch.set_num_threads(2)

GRID = (16, 16, 16)
UNIT = (0.024, 0.024, 0.024)
N = 128
DTYPES = {"f32": None, "bf16": torch.bfloat16}
OPT = Config({"optimizer": {"type": "Adam", "lr": 0.001, "betas": [0.5, 0.999],
                            "eps": 1e-6}, "clip_percentile": 50})


def batch():
    ds = SyntheticPoseDataset(n_objects=3, n_points=N, unit_voxel_extent=UNIT,
                              voxel_num_limit=GRID, seed=0)
    return batch_to_torch(make_batch([ds[i] for i in range(4)]).to_dict(), "cpu")


def model(remat: bool, dtype):
    return DCLNet(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=(256, 64, 16, 8),
                  interp_mode="pallas", device="cpu", seed=0, dtype=dtype, remat=remat)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_remat_gives_the_same_loss_and_gradients(dtype):
    b = batch()
    out = {}
    for remat in (False, True):
        m = model(remat, dtype).train()
        loss = dcl_losses(m(b), b)["loss_all"]
        params = [p for p in m.parameters() if p.requires_grad]
        out[remat] = (loss.detach(), torch.autograd.grad(loss, params),
                      [s.clone() for s in bn_statistics(m)])
    assert torch.equal(out[False][0], out[True][0])
    for g0, g1 in zip(out[False][1], out[True][1]):
        assert float((g1 - g0).abs().max()) <= 1e-6 * float(g0.abs().max()) + 1e-12
    # the backward's recomputation leaves the statistics as the forward left them
    for s0, s1 in zip(out[False][2], out[True][2]):
        assert torch.equal(s0, s1)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_remat_train_step_updates_bn_statistics_once(dtype):
    b = batch()
    after = {}
    for remat in (False, True):
        m = model(remat, dtype)
        before = [s.clone() for s in bn_statistics(m)]
        opt, _ = build_optimizer(OPT)
        state = TrainState(opt.init(sum(p.numel() for p in m.parameters()), "cpu"))
        metrics = make_train_step(m, opt, dcl_losses)(state, b)
        assert float(metrics["skipped_nonfinite"]) == 0.0
        stats = [s.clone() for s in bn_statistics(m)]
        assert all(not torch.equal(s, s0) for s, s0 in zip(stats, before))
        after[remat] = (metrics["loss_all"], stats, [p.detach().clone() for p in m.parameters()])
    assert torch.equal(after[False][0], after[True][0])
    for s0, s1 in zip(after[False][1], after[True][1]):
        assert torch.equal(s0, s1)
    for p0, p1 in zip(after[False][2], after[True][2]):
        torch.testing.assert_close(p1, p0, rtol=0, atol=1e-6)


def test_remat_nonfinite_step_restores_bn_statistics():
    b = batch()
    m = model(True, None)
    before = [s.clone() for s in bn_statistics(m)]
    params0 = [p.detach().clone() for p in m.parameters()]
    opt, _ = build_optimizer(OPT)
    state = TrainState(opt.init(sum(p.numel() for p in m.parameters()), "cpu"))

    def nan_losses(pred, batch):
        losses = dcl_losses(pred, batch)
        return {**losses, "loss_all": losses["loss_all"] * float("nan")}

    metrics = make_train_step(m, opt, nan_losses)(state, b)
    assert float(metrics["skipped_nonfinite"]) == 1.0
    for s, s0 in zip(bn_statistics(m), before):
        assert torch.equal(s, s0)
    for p, p0 in zip(m.parameters(), params0):
        assert torch.equal(p, p0)


def test_remat_from_config_and_eval_mode():
    """model.remat reaches the model; in eval mode (and under no_grad) the
    backbone runs without the checkpoint and gives the same poses."""
    cfg = {"unit_voxel_extent": list(UNIT), "voxel_num_limit": list(GRID),
           "capacities": [256, 64, 16, 8], "interp_mode": "pallas"}
    m0 = DCLNet.from_config(cfg, device="cpu", seed=0)
    m1 = DCLNet.from_config({**cfg, "remat": True}, device="cpu", seed=0)
    assert (m0.remat, m1.remat) == (False, True)
    b = batch()
    with torch.no_grad():
        p0, p1 = m0(b), m1(b)
    assert torch.equal(p0["rot_pred"], p1["rot_pred"])
    assert torch.equal(p0["trans_pred"], p1["trans_pred"])


def bn_by_autograd(x, mask, weight, bias, eps=1e-5):
    """Train-mode MaskedBatchNorm as plain autograd of its expression."""
    from dcl_net_tpu_torch.models.blocks import _stat_dtype
    from dcl_net_tpu_torch.ops.sparse_conv import masked_batch_norm_stats

    mean, var = masked_batch_norm_stats(x.to(_stat_dtype(x)), mask)
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5),
                                         (torch.bfloat16, None)],
                         ids=["f64", "f32", "bf16"])
@pytest.mark.parametrize("chunked", [False, True], ids=["one_chunk", "chunks"])
def test_lean_masked_batch_norm_matches_autograd(monkeypatch, dtype, rtol, chunked):
    """The train-mode MaskedBatchNorm that keeps only x, the mask and the
    statistics for its backward (models/blocks.py::_MaskedBatchNormTrain):
    its output torch.equal to the expression's, the gradients of x, weight
    and bias within rtol of autograd's (bf16: x's gradient within one bf16
    ulp of autograd's, which rounds each of its two terms to bf16 too), in
    one chunk and in chunks of the leading dim."""
    from dcl_net_tpu_torch.models import blocks

    if chunked:
        monkeypatch.setattr(blocks, "_CHUNK_ELEMENTS", 5 * 4 * 4 * 6)
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(7, 4, 4, 4, 6, generator=g, dtype=torch.float64) * 2 + 0.5).to(dtype)
    mask = (torch.rand(7, 4, 4, 4, generator=g) < 0.4).to(torch.float32)
    x = x * mask[..., None].to(dtype)
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    weight = (torch.rand(6, generator=g, dtype=torch.float64) + 0.5).to(pdt)
    bias = torch.randn(6, generator=g, dtype=torch.float64).to(pdt)
    gy = torch.randn(7, 4, 4, 4, 6, generator=g, dtype=torch.float64)
    outs = {}
    for name in ("lean", "autograd"):
        xi, wi, bi = (t.clone().requires_grad_(True) for t in (x, weight, bias))
        if name == "lean":
            y = blocks._MaskedBatchNormTrain.apply(xi, mask, wi, bi, 1e-5)[0]
        else:
            y = bn_by_autograd(xi, mask, wi, bi)
        grads = torch.autograd.grad(y, (xi, wi, bi), gy.to(y.dtype))
        outs[name] = (y.detach(), grads)
    (y0, g0), (y1, g1) = outs["lean"], outs["autograd"]
    assert y0.dtype == y1.dtype and torch.equal(y0, y1)
    assert [g.dtype for g in g0] == [g.dtype for g in g1] == [dtype, pdt, pdt]
    for a, b in zip(g0[1:] if rtol is None else g0, g1[1:] if rtol is None else g1):
        torch.testing.assert_close(a, b, rtol=rtol or 1e-5, atol=(rtol or 1e-5) * float(
            b.abs().max()))
    if rtol is None:  # bf16: within one ulp of autograd's bf16 gradient
        a, b = g0[0].float(), g1[0].float()
        ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(a.abs(), b.abs())
        assert bool(((a - b).abs() <= ulp + 1e-30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_window_sum_in_batch_chunks_equals_one_call(monkeypatch, dtype):
    """window_sum sums a large batch in chunks (each avg_pool3d call below
    WINDOW_SUM_CHUNK elements): the same values and gradients as one call."""
    from dcl_net_tpu_torch.ops import sparse_conv

    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 6, 6, 6, 4, generator=g).to(dtype)
    mask = (torch.rand(5, 6, 6, 6, generator=g) < 0.5).to(dtype)
    w = torch.randn(5, 3, 3, 3, 4, generator=g).to(dtype)
    outs = []
    for chunk in (1 << 30, 2 * 4 * 8 ** 3):  # one call; chunks of 2 samples
        monkeypatch.setattr(sparse_conv, "WINDOW_SUM_CHUNK", chunk)
        xi = x.clone().requires_grad_(True)
        out = sparse_conv.window_sum(xi, 3, 2, 1, mask=mask)
        (grad,) = torch.autograd.grad((out * w).sum(), xi)
        outs.append((out.detach(), grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
