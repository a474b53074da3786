#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's stage-1 inference and training on one NVIDIA GPU.

Usage, from the root of the repository:  python3 chip_smoke.py

Phases, any failure exits non-zero:
 1. device: a CUDA card must be present; prints its name and power limit and
    turns TF32 off;
 2. build: compiles the hand-written kernels from dcl_net_tpu_torch/csrc/;
 3. kernels: holds each kernel (K1 voxelize, K2 compaction, K3 3-NN
    interpolation, K4 its backward, K5 the compaction's backward) to its
    plain PyTorch version on the card, at the shapes the main paths give it
    (batch 32, 64^3 grid, 1024 points), and times the kernel, the plain
    version and a PyTorch library call computing the same function where
    one exists, with CUDA events;
 4. eval path: the full-width DCLNet of configs/config_YCBV_bs32.yaml
    (random weights from a seed) through Evaluator over the synthetic
    dataset's 16-class template bank and several batches of 32; checks
    finite outputs, the kernels' launch counts per encode, and one batch
    against the same path with the plain versions on the card;
 5. training path: Solver with that config's model, optimizer, schedule and
    batch 32 on the synthetic dataset, a warm-up step and a few timed
    steps; checks finite losses and gradient norms, changed parameters and
    BN statistics, and the launch counts per step (K1 2, K2-K5 8 each);
 6. one train step's losses and gradients from the same state through the
    kernels and through their plain versions;
 7. prints the per-kernel JSON line, then the result line
    {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 32
N_BATCHES = 6
N_CLASSES = 16
MODEL_POINTS = 1024
TRAIN_STEPS = 5  # timed training steps after one warm-up step
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Tolerances of kernel vs plain version, with their reasons:
VOX_ATOL = 1e-5    # K1: f32 atomics sum each voxel in another order than the plain serial sum
INTERP_ATOL = 1e-5  # K3: the weighted sum and weights round like the plain version's to a few ulp
POSE_ATOL = 1e-4   # whole path: K1's summation order feeds 8 convs and the pose heads
# K4: f32 atomics add each center's w * g terms in a run-dependent order; a
# sum of n terms in any order is within (n - 1) * 2^-24 of sum |terms|, and
# at most a few hundred terms land on one row of the main path: 1e-5 of
# sum |w * g| per element. K5 writes each value once: bit-equal.
INTERP_BWD_RTOL = 1e-5
# One train step, kernel path vs plain path: f32 sums in run-dependent order
# (K1's and K4's atomics, the plain versions' index_add_) move the losses by
# a few ulp and the gradient, whose f32 conditioning is poor (the neck's BN
# backward cancels nearly all of a near-uniform confidence average; see
# tests/test_torch_train_model.py), by more: losses within 1e-5 relative;
# the flat gradient within 5e-3 in relative L2 norm. On an H100 the kernel
# path differed from itself between two runs by 3.5e-4 to 5.5e-4 and from
# the plain path by 3.6e-4 to 1.2e-3; a kernel that dropped or misplaced a
# neighbour's or a voxel's gradient moves it by far more.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL_L2 = 5e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one CUDA event pair per run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    """Least time on the card for the work: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


@contextmanager
def plain_versions():
    """Route the model's five kernel calls (K1-K3 forward, K4-K5 backward)
    to their plain versions, on whatever device the tensors are, for the
    comparison runs."""
    from dcl_net_tpu_torch.models import dcl_net
    from dcl_net_tpu_torch.ops import cuda_compact, cuda_interp, cuda_voxelize

    routes = [
        (dcl_net, "voxelize_cuda", cuda_voxelize.voxelize_reference),
        (cuda_compact, "dense_to_sparse_cuda", cuda_compact.dense_to_sparse_reference),
        (cuda_compact, "dense_to_sparse_bwd_cuda",
         cuda_compact.dense_to_sparse_bwd_reference),
        (cuda_interp, "nn_interpolate_cuda", cuda_interp.nn_interpolate_reference),
        (cuda_interp, "nn_interpolate_bwd_cuda", cuda_interp.nn_interpolate_bwd_reference),
    ]
    saved = [getattr(mod, name) for mod, name, _ in routes]
    for mod, name, plain in routes:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(routes, saved):
            setattr(mod, name, fn)


KERNEL_COUNTERS = (  # (entry name, module, counter attribute)
    ("voxelize", "cuda_voxelize", "launches"),
    ("compact", "cuda_compact", "launches"),
    ("interp", "cuda_interp", "launches"),
    ("interp_bwd", "cuda_interp", "bwd_launches"),
    ("compact_bwd", "cuda_compact", "bwd_launches"),
)


def _counter_module(name: str):
    import importlib

    return importlib.import_module(f"dcl_net_tpu_torch.ops.{name}")


def reset_counts() -> None:
    for _, mod, attr in KERNEL_COUNTERS:
        setattr(_counter_module(mod), attr, 0)


def read_counts() -> dict:
    return {key: getattr(_counter_module(mod), attr) for key, mod, attr in KERNEL_COUNTERS}


def train_phase(cfg, card, device="cuda"):
    """Solver at full width: a warm-up step, then TRAIN_STEPS counted and
    timed steps through train_epoch. Returns (launch counts over the timed
    steps, the solver, one device batch of the run)."""
    import numpy as np
    import torch

    from dcl_net_tpu_torch.data.loader import BatchLoader
    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
    from dcl_net_tpu_torch.train.solver import Solver, bn_statistics

    dev = torch.device(device)
    mcfg = cfg.model
    bs = int(cfg.hyper_dataloader_train.bs)
    check(bs == BATCH, f"config batch {bs}")
    ds = SyntheticPoseDataset(
        n_objects=N_CLASSES, n_points=int(mcfg.n_inp),
        unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
        voxel_num_limit=tuple(int(d) for d in mcfg.voxel_num_limit),
        length=bs * (TRAIN_STEPS + 1), seed=0)
    loader = BatchLoader(ds, batch_size=bs, num_workers=8, seed=int(cfg.get("rd_seed", 1)))
    model = DCLNet.from_config(mcfg, seed=0, device=dev)
    train_cfg = cfg.merge({"per_write": 1, "per_save": 0})
    solver = Solver(model, dcl_losses, train_cfg, loader, device=dev)
    solver.initialize()
    params0 = [p.detach().clone() for p in model.parameters()]
    stats0 = [b.clone() for b in bn_statistics(model)]

    # warm-up step (cuDNN algorithm choice, allocator), not counted; the
    # epoch below starts after it (skip_next), on the same shuffle
    t0 = time.perf_counter()
    first = batch_to_torch(next(iter(loader)), dev)
    warm = solver.train_step(solver.state, first)
    torch.cuda.synchronize()
    print(f"train warm-up step {time.perf_counter() - t0:.3f} s, "
          f"loss_all {float(warm['loss_all']):.5f}", flush=True)
    loader.skip_next = 1
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    avg = solver.train_epoch()
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_counts()
    steps = solver.state.step - 1
    check(steps == TRAIN_STEPS, f"{steps} timed steps")
    per_step = {"voxelize": 2, "compact": 8, "interp": 8, "interp_bwd": 8, "compact_bwd": 8}
    print(f"train path launches {launches} over {steps} steps", flush=True)
    check(launches == {k: n * steps for k, n in per_step.items()},
          f"train launch counts {launches} are not 2/8/8/8/8 per step")
    for key in ("loss_all", "loss_pose", "loss_Xo", "loss_Yc", "loss_conf", "grad_norm"):
        check(bool(np.isfinite(avg[key])), f"train {key} not finite: {avg[key]}")
    check(avg["skipped_nonfinite"] == 0.0, "a training step was skipped as non-finite")
    check(all(not torch.equal(a, p) for a, p in zip(params0, model.parameters())),
          "some parameter did not change")
    check(all(not torch.equal(a, b) for a, b in zip(stats0, bn_statistics(model))),
          "some BN running statistic did not change")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = steps * bs / t_train
    print(f"train path on {card}: {steps} steps of batch {bs} in {t_train:.3f} s = "
          f"{rate:.2f} samples/s, T_step mean {avg['T_step']:.4f} s, T_data mean "
          f"{avg['T_data']:.4f} s, peak memory {peak:.2f} GiB; mean loss_all "
          f"{avg['loss_all']:.5f} grad_norm {avg['grad_norm']:.3f} "
          f"overflow_frac {avg['overflow_frac']:.4f}", flush=True)
    return launches, solver, first


def train_step_vs_plain(solver, batch) -> None:
    """Losses and parameter gradients of one train-mode forward and backward
    from the same state, through the kernels and through the plain versions.
    The BN running statistics are put back after each pass."""
    import torch

    from dcl_net_tpu_torch.train.solver import bn_statistics

    model = solver.model
    model.train()
    params = list(model.parameters())
    stats = bn_statistics(model)
    saved = [b.clone() for b in stats]

    def one_pass():
        from dcl_net_tpu_torch.models.dcl_net import dcl_losses

        losses = dcl_losses(model(batch), batch)
        grads = torch.autograd.grad(losses["loss_all"], params)
        with torch.no_grad():
            for b, s in zip(stats, saved):
                b.copy_(s)
        return ({k: float(v.detach()) for k, v in losses.items()},
                torch.cat([g.reshape(-1) for g in grads]))

    reset_counts()
    lk, gk = one_pass()
    counts = read_counts()
    check(all(n > 0 for n in counts.values()), f"kernel pass counts {counts}")
    lk2, gk2 = one_pass()
    with plain_versions():
        lp, gp = one_pass()
    check(read_counts() == {k: 2 * n for k, n in counts.items()},
          "the plain pass launched a kernel")
    denom = float(gp.norm())
    rel = float((gk - gp).norm()) / denom
    rel_self = float((gk - gk2).norm()) / denom
    loss_rel = max(abs(lk[k] - lp[k]) / abs(lp[k]) for k in lp)
    print(f"train step kernel path vs plain versions on the card: losses rel "
          f"{loss_rel:.3g}, gradient rel L2 {rel:.3g} (kernel path vs itself "
          f"{rel_self:.3g}), max abs {float((gk - gp).abs().max()):.3g} of max "
          f"{float(gp.abs().max()):.3g}", flush=True)
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train losses differ by {loss_rel}")
    check(rel <= TRAIN_GRAD_REL_L2, f"train gradients differ by {rel} in relative L2")


def main() -> int:
    import numpy as np
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "dcl_net_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(dcl_net_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.eval.evaluator import Evaluator
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.ops import cuda_build, cuda_compact, cuda_interp, cuda_voxelize
    from dcl_net_tpu_torch.ops.sparse_conv import voxel_centers

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(card, flush=True)
    strict_f32()
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    so = cuda_build.build(verbose=True)
    cuda_build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- inputs of the main path ------------------------------------------
    cfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs32.yaml"))
    mcfg = cfg.model
    grid_shape = tuple(int(d) for d in mcfg.voxel_num_limit)
    n_points = int(mcfg.n_inp)
    ds = SyntheticPoseDataset(
        n_objects=N_CLASSES, n_points=n_points,
        unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
        voxel_num_limit=grid_shape, seed=0)
    t0 = time.perf_counter()
    samples = [ds[i] for i in range(BATCH * N_BATCHES)]
    lost = dict(samples[-2], valid=0.0)          # one lost detection
    batches = [make_batch(samples[i * BATCH:(i + 1) * BATCH]).to_dict()
               for i in range(N_BATCHES - 1)]
    batches.append(make_batch(samples[(N_BATCHES - 1) * BATCH:-2] + [lost],
                              pad_to=BATCH).to_dict())  # and one pad row
    bank = ds.template_bank()
    model_points = np.stack(
        [ds.model_points(c, MODEL_POINTS) for c in range(N_CLASSES)])
    print(f"data: {len(batches)} batches of {BATCH} made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    model = DCLNet.from_config(mcfg, seed=0)
    check(next(model.parameters()).is_cuda, "model is not on the card")

    # ---- 3. kernels vs plain versions at main-path shapes -------------------
    tb = batch_to_torch(batches[0], dev)
    feats, vidx = tb["inp"]["feats"], tb["inp"]["voxel_idx"]
    entries = {}

    grid, count = cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, 4)
    pgrid, pcount = cuda_voxelize.voxelize_reference(feats, vidx, grid_shape, 4)
    torch.cuda.synchronize()
    check(torch.equal(count, pcount), "K1 counts differ from the plain version")
    e1 = max_err(grid, pgrid)
    check(e1 <= VOX_ATOL, f"K1 grid differs by {e1}")
    b_, n_, c_ = feats.shape
    g_ = grid_shape[0] * grid_shape[1] * grid_shape[2]
    lin = (((vidx[..., 0].long() * grid_shape[1] + vidx[..., 1]) * grid_shape[2]
            + vidx[..., 2]) + torch.arange(b_, device=dev)[:, None] * g_).reshape(-1)
    ext = torch.cat([feats, torch.ones_like(feats[..., :1])], -1).reshape(-1, c_ + 1)
    k1_ms = cuda_ms(lambda: cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, 4))
    k1_plain = cuda_ms(lambda: cuda_voxelize.voxelize_reference(feats, vidx, grid_shape, 4),
                       reps=5, warmup=1)
    k1_lib = cuda_ms(lambda: torch.zeros(b_ * g_, c_ + 1, device=dev).index_add_(0, lin, ext))
    nbytes = b_ * n_ * (c_ + 3) * 4 + b_ * g_ * (c_ + 1) * 4
    flops = b_ * n_ * (c_ + 1) + int((count > 1).sum()) * c_
    bms, bby = bound(nbytes, flops)
    entries["voxelize"] = dict(
        name="voxelize", route="cuda", source="dcl_net_tpu_torch/csrc/voxelize.cu",
        replaces="dcl_net_tpu/ops/pallas_voxelize.py:76", max_abs_err=e1,
        ms=k1_ms, kernel_ms=k1_ms, plain_ms=k1_plain, bound_ms=bms, bound_by=bby, library_ms=k1_lib)
    print(f"K1 voxelize [{b_},{n_},{c_}] -> {grid_shape}: err {e1:.3g} "
          f"kernel {k1_ms:.4f} ms plain {k1_plain:.4f} ms index_add_ {k1_lib:.4f} ms "
          f"bound {bms:.4f} ms ({bby})", flush=True)

    mask = (count > 0).to(torch.float32)
    with torch.inference_mode():
        pyramid = model.backbone_inp(grid, mask)
    pf = model.point_feats_inp
    points = feats[..., 4:7].contiguous()
    k2 = dict(err=0.0, ms=0.0, plain=0.0, bytes=0.0, flops=0.0)
    k3 = dict(err=0.0, ms=0.0, plain=0.0, bytes=0.0, flops=0.0)
    k4 = dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bytes=0.0, flops=0.0)
    k5 = dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bytes=0.0, flops=0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for level, (lf, lm) in enumerate(pyramid):
        lf, lm = lf.contiguous(), lm.contiguous()
        b_, d0, d1, d2, c_ = lf.shape
        g_ = d0 * d1 * d2
        cap = min(pf.capacities[level], g_)
        occ = (lm.reshape(b_, -1) > 0).sum(1)
        caps = [cap]
        if level == 0:  # a capacity below the occupancy: the overflow case
            caps.append(max(1, int(occ.min()) // 2))
        for cp in caps:
            got = cuda_compact.dense_to_sparse_cuda(lf, lm, cp)
            ref = cuda_compact.dense_to_sparse_reference(lf, lm, cp)
            for a, r, what in zip(got, ref, ("coords", "vfeats", "vmask", "occupancy")):
                check(torch.equal(a, r), f"K2 level {level} cap {cp}: {what} "
                      "not bit-equal to the plain version")
            k2["err"] = max(k2["err"], max_err(got[1], ref[1]))
            check(torch.equal(got[3] > cp, occ > cp), "K2 overflow flag wrong")
            if cp < cap:
                check(bool((got[3] > cp).any()), "K2 overflow case did not overflow")
        coords, vfeats, vmask, _ = got = cuda_compact.dense_to_sparse_cuda(lf, lm, cap)
        t_k = cuda_ms(lambda: cuda_compact.dense_to_sparse_cuda(lf, lm, cap))
        t_p = cuda_ms(lambda: cuda_compact.dense_to_sparse_reference(lf, lm, cap))
        sel = torch.clamp(occ, max=cap).sum().item()
        k2["ms"] += t_k
        k2["plain"] += t_p
        k2["bytes"] += b_ * g_ * 4 + sel * c_ * 4 + b_ * cap * (c_ + 4) * 4 + b_ * 4
        print(f"K2 compact level {level} [{b_},{d0},{d1},{d2},{c_}] cap {cap} "
              f"occupancy max {int(occ.max())}: kernel {t_k:.4f} ms plain {t_p:.4f} ms",
              flush=True)

        centers = voxel_centers(coords, pf.unit, pf.scale_list[level], pf.offset)
        out, w, idx = cuda_interp.nn_interpolate_cuda(points, centers, vfeats, vmask)
        pout, pw, pidx = cuda_interp.nn_interpolate_reference(points, centers, vfeats, vmask)
        err = max_err(out, pout)
        check(err <= INTERP_ATOL, f"K3 level {level}: out differs by {err}")
        check(max_err(w, pw) <= INTERP_ATOL, f"K3 level {level}: weights differ")
        full = (vmask.sum(1) >= 3)
        check(torch.equal(idx[full], pidx[full]), f"K3 level {level}: idx differ")
        k3["err"] = max(k3["err"], err)
        t_k = cuda_ms(lambda: cuda_interp.nn_interpolate_cuda(points, centers, vfeats, vmask))
        t_p = cuda_ms(lambda: cuda_interp.nn_interpolate_reference(points, centers, vfeats, vmask),
                      reps=5, warmup=1)
        v_ = vfeats.shape[1]
        n_ = points.shape[1]
        k3["ms"] += t_k
        k3["plain"] += t_p
        k3["bytes"] += (b_ * n_ * 3 + b_ * v_ * (3 + c_ + 1) + b_ * n_ * c_
                        + 2 * b_ * 3 * n_) * 4
        k3["flops"] += 8 * n_ * float(vmask.sum()) + 5 * b_ * n_ * c_
        print(f"K3 interp level {level} N {n_} V {v_} C {c_}: err {err:.3g} "
              f"kernel {t_k:.4f} ms plain {t_p:.4f} ms", flush=True)

        # K4 at this level's shapes: a cotangent of the interpolated features
        g = torch.randn((b_, n_, c_), device=dev, generator=gen)
        got4 = cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, v_)
        ref4 = cuda_interp.nn_interpolate_bwd_reference(g, w, idx, v_)
        mass = cuda_interp.nn_interpolate_bwd_reference(g.abs(), w.abs(), idx, v_)
        err = max_err(got4, ref4)
        rel = float(((got4 - ref4).abs() / mass.clamp(min=1e-30)).max())
        check(rel <= INTERP_BWD_RTOL,
              f"K4 level {level}: differs by {rel:.3g} of sum |w g| (max abs {err:.3g})")
        k4["err"] = max(k4["err"], err)
        rows = (idx.long() + v_ * torch.arange(b_, device=dev)[:, None, None]).reshape(-1)
        terms = (w[..., None] * g[:, None]).reshape(-1, c_)
        t_k = cuda_ms(lambda: cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, v_))
        t_p = cuda_ms(lambda: cuda_interp.nn_interpolate_bwd_reference(g, w, idx, v_))
        t_l = cuda_ms(lambda: torch.zeros(b_ * v_, c_, device=dev).index_add_(0, rows, terms))
        k4["ms"] += t_k
        k4["plain"] += t_p
        k4["lib"] += t_l
        k4["bytes"] += (b_ * n_ * c_ + 2 * b_ * 3 * n_ + b_ * v_ * c_) * 4
        k4["flops"] += 6 * b_ * n_ * c_
        print(f"K4 interp_bwd level {level} N {n_} V {v_} C {c_}: err {err:.3g} "
              f"(rel {rel:.3g}) kernel {t_k:.4f} ms plain {t_p:.4f} ms "
              f"index_add_ {t_l:.4f} ms", flush=True)

        # K5 at this level's shapes: a cotangent of the compacted features
        dv = torch.randn((b_, cap, c_), device=dev, generator=gen)
        got5 = cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask, (d0, d1, d2))
        ref5 = cuda_compact.dense_to_sparse_bwd_reference(dv, coords, vmask, (d0, d1, d2))
        check(torch.equal(got5, ref5), f"K5 level {level}: not bit-equal to the plain version")
        valid = vmask.reshape(-1) > 0
        lin = (((coords[..., 0].long() * d1 + coords[..., 1]) * d2 + coords[..., 2])
               + g_ * torch.arange(b_, device=dev)[:, None]).reshape(-1)[valid]
        vals = dv.reshape(-1, c_)[valid]
        t_k = cuda_ms(lambda: cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask,
                                                                    (d0, d1, d2)))
        t_p = cuda_ms(lambda: cuda_compact.dense_to_sparse_bwd_reference(dv, coords, vmask,
                                                                         (d0, d1, d2)))
        t_l = cuda_ms(lambda: torch.zeros(b_ * g_, c_, device=dev).index_copy_(0, lin, vals))
        n_valid = int(valid.sum())
        k5["ms"] += t_k
        k5["plain"] += t_p
        k5["lib"] += t_l
        k5["bytes"] += (n_valid * c_ + b_ * cap * 4 + b_ * g_ * c_) * 4
        print(f"K5 compact_bwd level {level} [{b_},{cap},{c_}] -> {d0}^3: bit-equal, "
              f"kernel {t_k:.4f} ms plain {t_p:.4f} ms index_copy_ {t_l:.4f} ms", flush=True)
    for key, acc, src, rep in (
            ("compact", k2, "compact.cu", "dcl_net_tpu/ops/pallas_compact.py:79"),
            ("interp", k3, "interp.cu", "dcl_net_tpu/ops/pallas_interp.py:42"),
            ("interp_bwd", k4, "interp.cu", "dcl_net_tpu/ops/pallas_interp.py:87"),
            ("compact_bwd", k5, "compact.cu", "dcl_net_tpu/ops/pallas_compact.py:226")):
        bms, bby = bound(acc["bytes"], acc["flops"])
        entries[key] = dict(
            name=key, route="cuda", source=f"dcl_net_tpu_torch/csrc/{src}",
            replaces=rep, max_abs_err=acc["err"], ms=acc["ms"],
            kernel_ms=acc["ms"], plain_ms=acc["plain"], bound_ms=bms, bound_by=bby,
            library_ms=acc.get("lib"))
        print(f"{key} over the 4 levels of one branch: kernel {acc['ms']:.4f} ms "
              f"plain {acc['plain']:.4f} ms library {acc.get('lib')} ms "
              f"bound {bms:.4f} ms ({bby})", flush=True)

    # ---- 4. main path at full width ------------------------------------------
    # warm-up pass (cuDNN algorithm choice, allocator), not counted
    Evaluator(model, model_points, template_bank=bank).evaluate(batches[:1])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ev = Evaluator(model, model_points, template_bank=bank)
    torch.cuda.synchronize()
    t_bank = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ev.evaluate(batches)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = read_counts()
    encodes = 1 + len(batches)  # the template bank once, then one per batch
    print(f"eval path launches {launches} over {encodes} encodes", flush=True)
    check(launches == {"voxelize": encodes, "compact": 4 * encodes,
                       "interp": 4 * encodes, "interp_bwd": 0, "compact_bwd": 0},
          f"launch counts {launches} are not 1/4/4/0/0 per encode")
    for key, n in launches.items():
        entries[key]["eval_launches"] = n
    rows = BATCH * len(batches)
    check(res["n_scored"] == rows - 1, f"n_scored {res['n_scored']} != {rows - 1}")
    check(bool(np.isfinite(res["auc_mean"])), "auc_mean is not finite")
    inst_s = rows / t_eval
    print(f"main path on {card}: auc_mean {res['auc_mean']} n_scored {res['n_scored']} "
          f"n_overflow {res['n_overflow']} template bank {t_bank:.3f} s, "
          f"evaluate {t_eval:.3f} s for {rows} rows = {inst_s:.1f} instances/s",
          flush=True)

    tb = batch_to_torch(batches[1], dev)
    out = ev._run(tb)
    rot, trans = out["rot_pred"], out["trans_pred"]
    check(bool(torch.isfinite(rot).all() and torch.isfinite(trans).all()
               and torch.isfinite(out["adds"]).all()), "non-finite outputs")
    check(tuple(rot.shape) == (BATCH, 3, 3) and tuple(trans.shape) == (BATCH, 3),
          "output shapes")
    eye = torch.eye(3, device=dev)
    ortho = max_err(rot.transpose(1, 2) @ rot, eye.expand_as(rot))
    check(ortho < 1e-5, f"rot_pred not orthonormal ({ortho})")
    check(bool((torch.linalg.det(rot) > 0).all()), "rot_pred det < 0")
    with plain_versions():
        ev_plain = Evaluator(model, model_points, template_bank=bank)
        pout = ev_plain._run(tb)
    e_rot = max_err(rot, pout["rot_pred"])
    e_trans = max_err(trans, pout["trans_pred"])
    print(f"kernel path vs plain versions on the card, one batch: rot_pred {e_rot:.3g} "
          f"trans_pred {e_trans:.3g} adds {max_err(out['adds'], pout['adds']):.3g}",
          flush=True)
    check(e_rot <= POSE_ATOL and e_trans <= POSE_ATOL,
          "kernel path disagrees with the plain versions")

    # ---- 5. training path at full width -----------------------------------------
    del ev, ev_plain, out, pout, pyramid, grid, pgrid
    torch.cuda.empty_cache()
    train_launches, solver, train_batch = train_phase(cfg, card)
    for key, n in train_launches.items():
        entries[key]["launches"] = n

    # ---- 6. one train step: kernel path vs plain path ---------------------------
    train_step_vs_plain(solver, train_batch)

    # ---- 7. result lines ------------------------------------------------------
    order = ("voxelize", "compact", "interp", "interp_bwd", "compact_bwd")
    print(json.dumps({"kernels": [entries[k] for k in order]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
