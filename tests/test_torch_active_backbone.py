"""The eval-mode backbone on active sites (models/backbone.py::
SparseBackbone._forward_active) against its dense path (_forward_dense).

At 16^3 and 32^3, batch 3 (one empty sample, one full, one random sparse),
with BN running statistics drawn away from the identity: the four pooled
levels' masks torch.equal, their features within 1e-5 relative / 1e-6
absolute in f32 and within the bf16 model tests' relative L2
(tests/test_torch_bf16_model.py::FEAT_REL_L2) in bf16, exact zeros at
inactive sites; K2's occupancy and the overflow flags of
MultiScalePointFeatures equal on both pyramids; two forwards torch.equal,
and a sample's levels torch.equal in batches of 4 and of 2 and on any
number of threads.
Which forwards take the path: an eval forward opens the span
model.backbone.active, a train forward and a direct ServeStage1 call do
not, and the exported serving module holds convolutions and no
data-dependent site list.
"""

import copy

import numpy as np
import pytest
import torch

from dcl_net_tpu_torch import serving, telemetry
from dcl_net_tpu_torch.models.backbone import MultiScalePointFeatures, SparseBackbone
from dcl_net_tpu_torch.models.blocks import MaskedBatchNorm, init_weights
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.ops import cuda_compact
from dcl_net_tpu_torch.ops.voxelize import point_to_voxel_index

torch.set_num_threads(2)

F32_RTOL, F32_ATOL = 1e-5, 1e-6
BF16_REL_L2 = 3e-3  # tests/test_torch_bf16_model.py::FEAT_REL_L2
UNIT = 0.024
N = 64


def _backbone(dtype, seed=1):
    bb = SparseBackbone(dtype=dtype)
    init_weights(bb, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in bb.modules():
            if isinstance(m, MaskedBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
    return bb.eval()


def _inputs(d, dtype, seed=0):
    """grid [3, d, d, d, 7], mask [3, d, d, d]: empty, full, 5 % random."""
    gen = torch.Generator().manual_seed(seed)
    mask = torch.zeros(3, d, d, d)
    mask[1] = 1.0
    mask[2] = (torch.rand((d, d, d), generator=gen) < 0.05).float()
    grid = torch.randn((3, d, d, d, 7), generator=gen) * mask[..., None]
    return grid.to(dtype or torch.float32), mask


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / a.norm().clamp(min=1e-30))


@pytest.fixture(scope="module")
def pyramids():
    out = {}
    for d in (16, 32):
        for dtype in (None, torch.bfloat16):
            bb = _backbone(dtype)
            grid, mask = _inputs(d, dtype)
            with torch.inference_mode():
                out[d, dtype] = (bb._forward_dense(grid, mask), bb._forward_active(grid, mask),
                                 bb._forward_active(grid, mask))
    return out


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_active_levels_equal_dense_levels(pyramids, d, dtype):
    dense, active, _ = pyramids[d, dtype]
    assert len(dense) == len(active) == 4
    for level, ((fd, md), (fa, ma)) in enumerate(zip(dense, active)):
        assert torch.equal(md, ma), level
        assert fa.dtype == fd.dtype == (dtype or torch.float32) and fa.shape == fd.shape
        inactive = ma == 0
        assert torch.equal(fa[inactive], torch.zeros_like(fa[inactive])), level
        assert fa[0].abs().max() == 0 and fa[1].abs().max() > 0  # empty and full samples
        if dtype is None:
            torch.testing.assert_close(fa, fd, rtol=F32_RTOL, atol=F32_ATOL)
        else:
            assert _rel_l2(fd, fa) <= BF16_REL_L2, level


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_two_active_forwards_are_equal(pyramids, dtype):
    _, first, second = pyramids[32, dtype]
    for (fa, ma), (fb, mb) in zip(first, second):
        assert torch.equal(fa, fb) and torch.equal(ma, mb)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_a_samples_levels_do_not_depend_on_its_batch(dtype):
    """Each sample's levels torch.equal whether it runs in a batch of 4 or
    of 2, and on one thread or several, as on the dense path (the
    data-parallel evaluators rely on it)."""
    bb = _backbone(dtype, seed=2)
    gen = torch.Generator().manual_seed(3)
    mask = (torch.rand((4, 16, 16, 16), generator=gen) < 0.1).float()
    grid = (torch.randn((4, 16, 16, 16, 7), generator=gen) * mask[..., None]).to(
        dtype or torch.float32)
    threads = torch.get_num_threads()
    with torch.inference_mode():
        whole = bb._forward_active(grid, mask)
        halves = [bb._forward_active(grid[i:i + 2], mask[i:i + 2]) for i in (0, 2)]
        torch.set_num_threads(1)
        try:
            alone = bb._forward_active(grid, mask)
        finally:
            torch.set_num_threads(threads)
    for level, (f, m) in enumerate(whole):
        assert torch.equal(f, torch.cat([h[level][0] for h in halves])), level
        assert torch.equal(m, torch.cat([h[level][1] for h in halves])), level
        assert torch.equal(f, alone[level][0]), level


def test_compaction_and_overflow_equal_on_both_paths(pyramids):
    """K2's occupancy and coords per level, and MultiScalePointFeatures'
    overflow flags, with capacities that the full sample overflows."""
    dense, active, _ = pyramids[32, None]
    caps = (64, 64, 64, 1)
    for (fd, md), (fa, ma), cap in zip(dense, active, caps):
        cd, _, _, occ_d = cuda_compact.dense_to_sparse(fd.contiguous(), md.contiguous(), cap)
        ca, _, _, occ_a = cuda_compact.dense_to_sparse(fa.contiguous(), ma.contiguous(), cap)
        assert torch.equal(occ_d, occ_a) and torch.equal(cd, ca)
    pf = MultiScalePointFeatures(unit_voxel_extent=(UNIT,) * 3, voxel_num_limit=(32,) * 3,
                                 capacities=caps)
    points = (torch.rand((3, N, 3), generator=torch.Generator().manual_seed(2)) - 0.5) \
        * (0.9 * UNIT * 32)
    with torch.inference_mode():
        feats_d, over_d = pf(points, dense)
        feats_a, over_a = pf(points, active)
    assert torch.equal(over_d, over_a) and over_a.tolist()[:2] == [False, True]
    torch.testing.assert_close(feats_a, feats_d, rtol=F32_RTOL, atol=F32_ATOL)


def _cloud(rng, b):
    pts = (rng.rand(b, N, 3).astype(np.float32) - 0.5) * 0.15
    rgb = rng.rand(b, N, 3).astype(np.float32) - 0.5
    feats = np.concatenate([np.ones((b, N, 1), np.float32), rgb, pts], -1)
    vi = point_to_voxel_index(torch.from_numpy(pts), (UNIT,) * 3, (16,) * 3)
    return torch.from_numpy(feats), vi


def _span_names(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name()[len(telemetry.PREFIX):] for e in prof.profiler.kineto_results.events()
            if e.name().startswith(telemetry.PREFIX)}


@pytest.fixture(scope="module")
def served():
    rng = np.random.RandomState(0)
    model = DCLNet(unit_voxel_extent=(UNIT,) * 3, voxel_num_limit=(16,) * 3,
                   capacities=(256, 64, 16, 8), device="cpu", seed=3)
    bank_feats, bank_vi = _cloud(rng, 2)
    cache = serving.encode_template_cache(
        model, {"feats": bank_feats.numpy(), "voxel_idx": bank_vi.numpy()})
    feats, vi = _cloud(rng, 2)
    return model, serving.make_serve_fn(model, cache), feats, vi, torch.tensor([0, 1])


def test_eval_forward_takes_the_active_path_and_train_the_dense(served):
    model, _, feats, vi, _ = served
    batch = {"inp": {"feats": feats, "voxel_idx": vi}}
    with torch.inference_mode():
        eval_spans = _span_names(lambda: model.encode_observed(batch))
    assert {"model.backbone", "model.backbone.rulebook", "model.backbone.active"} <= eval_spans
    trained = copy.deepcopy(model).train()  # a train forward updates the BN statistics
    train_spans = _span_names(lambda: trained.encode_observed(batch))
    assert "model.backbone" in train_spans
    assert not {"model.backbone.rulebook", "model.backbone.active"} & train_spans


def test_serving_module_keeps_the_dense_path(served):
    model, serve, feats, vi, obj_idx = served
    with torch.inference_mode():
        spans = _span_names(lambda: serve(feats, vi, obj_idx))
    assert "model.backbone" in spans and "model.backbone.active" not in spans
    program = torch.export.export(serve, (feats, vi, obj_idx))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    # the observed backbone's 8 convolutions (the template branch is cached)
    assert sum(t.startswith(("aten.conv3d", "aten.convolution")) for t in targets) == 8
    assert not [t for t in targets if "nonzero" in t or "searchsorted" in t]
