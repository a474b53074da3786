#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's stage-1 inference on one NVIDIA GPU.

Usage, from the root of the repository:  python3 chip_smoke.py

Phases, any failure exits non-zero:
 1. device: a CUDA card must be present; prints its name and power limit and
    turns TF32 off;
 2. build: compiles the hand-written kernels from dcl_net_tpu_torch/csrc/;
 3. kernels: holds each kernel (K1 voxelize, K2 compaction, K3 3-NN
    interpolation) to its plain PyTorch version on the card, at the shapes
    the main path gives it (batch 32, 64^3 grid, 1024 points), and times the
    kernel, the plain version and, for K1, index_add_ with CUDA events;
 4. main path: the full-width DCLNet of configs/config_YCBV_bs32.yaml (random
    weights from a seed) through Evaluator over the synthetic dataset's
    16-class template bank and several batches of 32; checks finite
    outputs, the kernels' launch counts per encode, and one batch against
    the same path with the plain versions on the card;
 5. prints the per-kernel JSON line, then the result line
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
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Tolerances of kernel vs plain version, with their reasons:
VOX_ATOL = 1e-5    # K1: f32 atomics sum each voxel in another order than the plain serial sum
INTERP_ATOL = 1e-5  # K3: the weighted sum and weights round like the plain version's to a few ulp
POSE_ATOL = 1e-4   # whole path: K1's summation order feeds 8 convs and the pose heads


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
    """Route the model's three kernel calls to their plain versions, on
    whatever device the tensors are, for the comparison run."""
    from dcl_net_tpu_torch.models import backbone, dcl_net
    from dcl_net_tpu_torch.ops import cuda_compact, cuda_interp, cuda_voxelize

    saved = (dcl_net.voxelize_cuda, backbone.dense_to_sparse_cuda,
             backbone.nn_interpolate_cuda)
    dcl_net.voxelize_cuda = cuda_voxelize.voxelize_reference
    backbone.dense_to_sparse_cuda = cuda_compact.dense_to_sparse_reference
    backbone.nn_interpolate_cuda = cuda_interp.nn_interpolate_reference
    try:
        yield
    finally:
        (dcl_net.voxelize_cuda, backbone.dense_to_sparse_cuda,
         backbone.nn_interpolate_cuda) = saved


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
    for key, acc, src, rep in (
            ("compact", k2, "compact.cu", "dcl_net_tpu/ops/pallas_compact.py:79"),
            ("interp", k3, "interp.cu", "dcl_net_tpu/ops/pallas_interp.py:42")):
        bms, bby = bound(acc["bytes"], acc["flops"])
        entries[key] = dict(
            name=key, route="cuda", source=f"dcl_net_tpu_torch/csrc/{src}",
            replaces=rep, max_abs_err=acc["err"], ms=acc["ms"],
            kernel_ms=acc["ms"], plain_ms=acc["plain"], bound_ms=bms, bound_by=bby, library_ms=None)
        print(f"{key} over the 4 levels of one encode: kernel {acc['ms']:.4f} ms "
              f"plain {acc['plain']:.4f} ms bound {bms:.4f} ms ({bby})", flush=True)

    # ---- 4. main path at full width ------------------------------------------
    # warm-up pass (cuDNN algorithm choice, allocator), not counted
    Evaluator(model, model_points, template_bank=bank).evaluate(batches[:1])
    torch.cuda.synchronize()
    for mod in (cuda_voxelize, cuda_compact, cuda_interp):
        mod.launches = 0
    t0 = time.perf_counter()
    ev = Evaluator(model, model_points, template_bank=bank)
    torch.cuda.synchronize()
    t_bank = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ev.evaluate(batches)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = {"voxelize": cuda_voxelize.launches, "compact": cuda_compact.launches,
                "interp": cuda_interp.launches}
    encodes = 1 + len(batches)  # the template bank once, then one per batch
    print(f"main path launches {launches} over {encodes} encodes", flush=True)
    check(launches == {"voxelize": encodes, "compact": 4 * encodes,
                       "interp": 4 * encodes},
          f"launch counts {launches} are not 1/4/4 per encode")
    for key, n in launches.items():
        entries[key]["launches"] = n
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

    # ---- 5. result lines ------------------------------------------------------
    order = ("voxelize", "compact", "interp")
    print(json.dumps({"kernels": [entries[k] for k in order]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
