"""What the data-parallel tests run in each rank, and in one process.

Each case takes (group, inputs): group None is the single process on the
whole global batch; a group is one rank of it, on its block
(parallel/mesh.py::shard_batch). tests/test_torch_parallel.py runs the
cases in 2 gloo ranks (run_ranks) and in the test's own process, and
compares. This module imports torch and the port only, so a spawned rank
starts without JAX.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.models.blocks import PointMLP, _MaskedBatchNormTrain, init_weights
from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
from dcl_net_tpu_torch.parallel import mesh
from dcl_net_tpu_torch.train import solver as tsolver

GRID = (16, 16, 16)
UNIT = (0.024, 0.024, 0.024)
N = 64
CAPS = (256, 64, 16, 8)
KW = dict(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=CAPS)
# the whole-step optimizer of tests/test_torch_train_solver.py: Adam with
# eps = 1, so the update is close to linear in the gradient
STEP_CFG = {
    "optimizer": {"type": "Adam", "lr": 0.001, "betas": [0.5, 0.999], "eps": 1.0},
    "lr_scheduler_cyc": {"max_lr": 0.001, "base_lr": 0.0001, "step_size_up": 2,
                         "step_size_down": 2},
    "clip_percentile": 50,
}
BATCH = 8  # the global batch: 4 rows a rank at world 2


def dataset(length: int = 16) -> SyntheticPoseDataset:
    return SyntheticPoseDataset(n_objects=4, n_points=N, unit_voxel_extent=UNIT,
                                voxel_num_limit=GRID, seed=0, length=length)


def global_batch(start: int = 0) -> Dict[str, Any]:
    """BATCH rows of the synthetic set as a numpy batch."""
    ds = dataset()
    return make_batch([ds[i] for i in range(start, start + BATCH)]).to_dict()


def model_points() -> np.ndarray:
    ds = dataset()
    return np.stack([ds.model_points(c, 32) for c in range(4)])


def _floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def block(batch, group, dtype=torch.float32):
    """This rank's block of a numpy batch, as tensors on the CPU."""
    return _floats(batch_to_torch(mesh.shard_batch(batch, group), "cpu"), dtype)


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------
def bn_inputs(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    feats = rng.randn(BATCH, 8, 8, 8, 6).astype(np.float32) * 2.0 + 0.5
    mask = (rng.rand(BATCH, 8, 8, 8) < 0.3).astype(np.float32)
    mask[5] = 0.0  # one sample without an occupied voxel
    return {"feats": feats * mask[..., None], "mask": mask,
            "gy": rng.randn(BATCH, 8, 8, 8, 6).astype(np.float32),
            "points": rng.randn(BATCH, 32, 12).astype(np.float32),
            "gp": rng.randn(BATCH, 32, 8).astype(np.float32)}


def case_masked_bn(group, inp):
    """The train-mode masked BN's forward and backward on the block."""
    b = mesh.shard_batch({k: inp[k] for k in ("feats", "mask", "gy")}, group)
    x = torch.from_numpy(b["feats"]).requires_grad_()
    w = torch.linspace(0.5, 1.5, 6).requires_grad_()
    bias = torch.linspace(-0.2, 0.3, 6).requires_grad_()
    y, mean, var, count = _MaskedBatchNormTrain.apply(
        x, torch.from_numpy(b["mask"]), w, bias, 1e-5, group)
    gx, gw, gb = torch.autograd.grad(y, (x, w, bias), torch.from_numpy(b["gy"]))
    return {"y": y.detach(), "mean": mean, "var": var, "count": count,
            "gx": gx, "gw": gw, "gb": gb}


def case_point_mlp(group, inp):
    """PointMLP's flax-style BN in train mode: forward, the input's and the
    parameters' gradients, the running statistics."""
    b = mesh.shard_batch({k: inp[k] for k in ("points", "gp")}, group)
    mlp = PointMLP(12, (16, 8), ("relu", "relu"), (True, True), bn_before_act=True)
    init_weights(mlp, 7)
    mlp.train()
    x = torch.from_numpy(b["points"]).requires_grad_()
    params = list(mlp.parameters())
    with mesh.sharded(group):
        y = mlp(x)
        grads = torch.autograd.grad((y * torch.from_numpy(b["gp"])).sum(), [x] + params)
    return {"y": y.detach(), "gx": grads[0], "gparams": flat(grads[1:]),
            "stats": flat(tsolver.bn_statistics(mlp))}


class _Recorder:
    """Keeps every flat gradient the optimizer is given (after the
    all-reduce)."""

    def __init__(self, opt):
        self.grads = []
        update = opt.update

        def record(grad, norm, state):
            self.grads.append(grad.clone())
            return update(grad, norm, state)

        opt.update = record


def train_steps(group, batch, steps: int = 1, interp_mode: str = "pallas",
                remat: bool = False, variables=None, dtype=torch.float32,
                template_bank=None):
    """`steps` stage-1 train steps through make_parallel_train_step on this
    rank's block of `batch`: per step the metrics, the flat gradient and
    the flat parameters after it."""
    model = DCLNet(device="cpu", seed=3, interp_mode=interp_mode, remat=remat, **KW)
    if variables is not None:
        from dcl_net_tpu_torch.weights import load_jax_variables

        load_jax_variables(model, variables)
    model = model.to(dtype)
    opt, _ = tsolver.build_optimizer(Config(STEP_CFG), 1)
    rec = _Recorder(opt)
    bank = None if template_bank is None else _floats(
        batch_to_torch(template_bank, "cpu"), dtype)
    step = mesh.make_parallel_train_step(model, opt, dcl_losses, group,
                                         template_bank=bank)
    params = [p for p in model.parameters() if p.requires_grad]
    state = tsolver.TrainState(opt.init(sum(p.numel() for p in params)))
    b = block(batch, group, dtype)
    before = flat(params)
    out = []
    for _ in range(steps):
        metrics = step(state, b)
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "grad": rec.grads[-1] if rec.grads else None,
                    "params": flat(params),
                    "stats": flat(tsolver.bn_statistics(model))})
    return {"steps": out, "before": before}


def nan_batch():
    """The global batch with a NaN target in row 5: rank 1's block only."""
    batch = global_batch()
    batch["labels"]["trans_gt"] = batch["labels"]["trans_gt"].copy()
    batch["labels"]["trans_gt"][5, 0] = np.nan
    return batch


def unequal_batch():
    """Rank 0's block holds 4 valid rows, rank 1's 1."""
    batch = global_batch()
    batch["valid"] = np.asarray([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    return batch


def case_stage2_step(group, inp):
    """One refiner train step on a frozen stage 1 (seeded)."""
    from dcl_net_tpu_torch.models.refiner import Refiner
    from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step

    main_model = DCLNet(device="cpu", seed=3, **KW)
    refiner = Refiner(n_inp=N, device="cpu", seed=5)
    mesh.replicate(refiner, group)
    opt, _ = tsolver.build_optimizer(Config(STEP_CFG), 1)
    rec = _Recorder(opt)
    step = make_stage2_train_step(main_model, refiner, opt, 2,
                                  torch.from_numpy(inp["model_points"]), group=group)
    state = tsolver.TrainState(opt.init(sum(p.numel() for p in refiner.parameters())))
    metrics = step(state, block(inp["batch"], group))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grad": rec.grads[-1], "params": flat(refiner.parameters())}


def case_ddp(group, inp):
    """Does DistributedDataParallel all-reduce anything when the step takes
    its gradient with torch.autograd.grad? The rank's own gradient, and the
    .grad fields afterwards."""
    from torch.nn.parallel import DistributedDataParallel

    model = DCLNet(device="cpu", seed=3, **KW)
    ddp = DistributedDataParallel(model)
    model.train()
    b = block(inp["batch"], group)
    params = [p for p in model.parameters() if p.requires_grad]
    loss = dcl_losses(ddp(b), b)["loss_all"]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    own = flat([g if g is not None else torch.zeros_like(p)
                for g, p in zip(grads, params)])
    return {"grad": own, "dot_grad_set": any(p.grad is not None for p in params)}


def case_eval(group, inp):
    """Evaluator and Stage2Evaluator over the global batches of inp."""
    from dcl_net_tpu_torch.eval.evaluator import Evaluator, Stage2Evaluator
    from dcl_net_tpu_torch.models.refiner import Refiner

    model = DCLNet(device="cpu", seed=3, **KW)
    refiner = Refiner(n_inp=N, device="cpu", seed=5)
    batches = [mesh.shard_batch(b, group) for b in inp["eval_batches"]]
    kw = dict(device="cpu", group=group, template_bank=inp["bank"])
    s1 = Evaluator(model, inp["model_points"], **kw).evaluate(iter(batches))
    s2 = Stage2Evaluator(model, refiner, inp["model_points"], iterations=2,
                         **kw).evaluate(iter(batches))
    return {"stage1": s1, "stage2": s2}


def case_serve_mesh(group, inp):
    """Each data-parallel artifact of inp["sharded"] loaded over the group
    and called with the global request on every rank; and whether loading
    a one-process artifact over the group raises."""
    from dcl_net_tpu_torch import serving

    outs = []
    for data in inp["sharded"]:
        module = serving.load_serve(data, group=group)
        with torch.inference_mode():
            outs.append(module(*inp["request"]))
    try:
        serving.load_serve(inp["single"], group=group)
        refused = False
    except ValueError:
        refused = True
    # rows of the types gloo carries as others: bf16 (as f32) and bool (as uint8)
    r = group.rank
    rows = {"bf16": (torch.arange(3, dtype=torch.float32) / 3 + r).to(torch.bfloat16),
            "bool": torch.tensor([r == 0, True, False])}
    gathered = {k: mesh.allgather_rows(v, group) for k, v in rows.items()}
    return {"outputs": outs, "refused_single": refused, "gathered": gathered}


CASES: Dict[str, Callable] = {
    "masked_bn": case_masked_bn,
    "point_mlp": case_point_mlp,
    "step": lambda g, inp: train_steps(g, inp["batch"], steps=2),
    "step_fused": lambda g, inp: train_steps(g, inp["batch"], interp_mode="pallas_fused"),
    "step_bank": lambda g, inp: train_steps(g, inp["batch"],
                                            template_bank=inp["bank"]),
    "step_unequal": lambda g, inp: train_steps(g, unequal_batch()),
    "step_nan": lambda g, inp: train_steps(g, nan_batch()),
    "step_remat": lambda g, inp: train_steps(g, inp["batch"], remat=True),
    "step_f64": lambda g, inp: train_steps(g, inp["batch"], steps=3, interp_mode="exact",
                                           variables=inp["variables"],
                                           dtype=torch.float64),
    "stage2": case_stage2_step,
    "ddp": case_ddp,
    "eval": case_eval,
}
# cases a test starts by name, outside the set tests/test_torch_parallel.py
# runs whole: the data-parallel serving artifact (tests/test_torch_serving_mesh.py)
RANK_CASES: Dict[str, Callable] = {**CASES, "serve_mesh": case_serve_mesh}


def _rank(rank: int, world: int, init: str, out: str, inputs, cases) -> None:
    torch.set_num_threads(1)
    group = mesh.init_distributed(init, world, rank, device="cpu")
    try:
        results = {name: RANK_CASES[name](group, inputs) for name in cases}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.destroy(group)


def start_ranks(tmp_dir: str, inputs, cases, world: int = 2):
    """Start `world` gloo ranks on the CPU running `cases`; join() them with
    finish_ranks. They meet through a file:// rendezvous in tmp_dir."""
    init = "file://" + os.path.join(tmp_dir, "rendezvous")
    return torch.multiprocessing.start_processes(
        _rank, args=(world, init, tmp_dir, inputs, tuple(cases)), nprocs=world,
        join=False, start_method="spawn")


def finish_ranks(context, tmp_dir: str, world: int = 2, timeout: float = 300.0):
    """Wait for the ranks (a rank that fails ends the others and raises
    here) and return their results, by rank."""
    import time

    deadline = time.time() + timeout
    while not context.join(timeout=1.0):
        if time.time() > deadline:
            for p in context.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not end within {timeout:.0f} s")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def single(cases, inputs) -> Dict[str, Any]:
    """The cases in this process, without a group."""
    return {name: CASES[name](None, inputs) for name in cases}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def concat(parts, key: Optional[str] = None):
    return torch.cat([p if key is None else p[key] for p in parts])
