"""Synthetic train-to-convergence acceptance of the port: it trains stage 1
from scratch, scores it on held-out rows, then trains the refiner on top.

The port's counterpart of scripts/train_synthetic_convergence.py, with its
flags, defaults, data split and bars. Stage-1 DCLNet trains from scratch on
synthetic scenes at full width: a 64^3 grid at 6 mm, 1024 + 1024 points,
batch 128, 3000 steps, 8 classes. It runs the JAX script's production
config: interp_mode "pallas" with bf16 compute, parameters in f32. The
optimizer is Adam (lr 1e-3, betas 0.5 / 0.999, eps 1e-6) behind AutoClip at
the 50th percentile. The training rows are indices 0 .. 8191; the held-out
rows are 4 batches of 128 from index 8192 on: the same objects, with the
pose, view and visibility drawn from indices past the training range. One
Evaluator, with the template bank, scores ADD-S AUC every --eval-every steps
(update_variables re-encodes its template cache). The identity pose
(rotation I, translation 0) on the same rows is the baseline. The refiner
then trains for --stage2-steps on the frozen stage 1, and Stage2Evaluator
scores it at 2 iterations.

The bars, as in the JAX script:
  - stage-1 held-out AUC >= --auc-bar (default 90);
  - stage 1 at least 10 points above the identity baseline;
  - stage 2 (2 iterations) >= stage 1 - 0.5.
A bar of 0 checks nothing. The script prints the JAX script's result JSON,
with the loader's wait, the rate, the evaluations and the trained model's
bf16 drift added. The drift is the rotation (degrees) and translation (mm)
between the bf16 model's poses and those of an f32 copy of its weights, on
the held-out rows. It then prints each bar as passed or failed, and exits 1
if one failed.

--seed seeds the weights (stage 1 and the refiner) and the loader's shuffle
only. The datasets stay at seed 0, as in the JAX script (a sample's draws
are keyed by its index), so the training rows, the held-out split and the
identity baseline are those of every seed. --cad-dir trains and scores on
the *_pc.ply clouds of a directory (e.g. the 21 YCB-V objects) in place of
the procedural shapes, as the JAX script's option does; --classes 0 then
takes every cloud found.

Usage, from the root of a checkout, on a machine with a CUDA device:
  python3 scripts/torch_synthetic_convergence.py           # the acceptance
  python3 scripts/torch_synthetic_convergence.py --bank    # banked-template arm
  python3 scripts/torch_synthetic_convergence.py --seed 1  # another draw of the weights
  python3 scripts/torch_synthetic_convergence.py --save <dir>
      # also writes <dir>/stage1/epoch_<steps>/ and <dir>/stage2/epoch_<steps>/
      # (weights only); scripts/bf16_fullwidth_drift.py --weights
      # <dir>/stage1/epoch_<steps> reads the first
  smoke: --steps 30 --stage2-steps 5 --eval-every 30 --auc-bar 0

The synthetic rows cost about 10 ms each to draw on one CPU core, so the
loader runs process workers by default (--workers, --worker-type).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TRAIN_LEN, HELD_LEN = 8192, 512
HELD_BATCHES, HELD_BATCH = 4, 128
UNIT_AT_64 = 0.006  # metres a voxel at the 64^3 grid; a smaller grid keeps the volume
ITERATIONS = 2  # refinement steps of stage 2, trained and scored
MODEL_POINTS = 256  # CAD points of the metric


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--stage2-steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--bank", action="store_true", help="banked-template training arm")
    ap.add_argument("--samples-per-frame", type=int, default=0,
                    help=">0 trains on frame-correlated synthetic draws "
                    "(SyntheticPoseDataset frame_mode), this many a frame packed in "
                    "one batch; the held-out rows stay the independent split")
    ap.add_argument("--auc-bar", type=float, default=90.0)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--cad-dir", default=None,
                    help="directory of CAD clouds (*_pc.ply, e.g. the 21 YCB-V objects) "
                    "to train and score on in place of the procedural shapes; "
                    "--classes 0 takes every cloud found")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the loader's shuffle; the datasets "
                    "stay at seed 0")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--protocol", default="adds_auc", choices=["adds_auc", "add_0.1d"],
                    help="ADD-S AUC (YCB-V) or the ADD(-S) < 0.1 d success rate "
                    "(LineMOD), which trains under a StepLR schedule")
    ap.add_argument("--save", default=None,
                    help="write the trained stage-1 and refiner weights under this "
                    "directory, in the port's checkpoint layout")
    ap.add_argument("--workers", type=int, default=6, help="loader workers")
    ap.add_argument("--worker-type", default="process", choices=["thread", "process"])
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    return ap.parse_args(argv)


def build_protocol(protocol: str, train_ds, n_classes: int):
    """(Evaluator keywords, metric key, scale, sym class ids, 0.1 x diameters)
    of the protocol, as the JAX script builds them."""
    import numpy as np

    if protocol != "add_0.1d":
        return {}, "auc_mean", 1.0, [], None
    # per-class diameters (max pairwise distance over a subsample), scaled
    # by 0.1 as the reference does (tools/test_LM.py:74)
    rs = np.random.RandomState(0)
    diams = []
    for c in range(n_classes):
        p = np.asarray(train_ds.cad_points[c], np.float32)
        sub = p[rs.choice(len(p), min(len(p), 512), replace=False)]
        d2 = ((sub[None] - sub[:, None]) ** 2).sum(-1)
        diams.append(0.1 * float(np.sqrt(d2.max())))
    sym_ids = [c for c, f in enumerate(train_ds.sym_flags) if f > 0]
    return (dict(diameters=diams, sym_class_ids=sym_ids), "success_mean", 100.0,
            sym_ids, diams)


def identity_baseline(eval_batches, model_points, protocol: str, sym_ids, diams,
                      n_classes: int) -> float:
    """The held-out score of the identity pose (rotation I, translation 0)
    under the protocol: ADD-S AUC, or the success rate with ADD for the
    non-symmetric classes. On the CPU, in f32."""
    import numpy as np
    import torch

    from dcl_net_tpu_torch.eval.metrics import (
        add_batch, add_s_batch, per_class_auc_acc, success_at_diameter,
    )

    points = torch.as_tensor(np.asarray(model_points, np.float32))
    dists, clss = [], []
    for b in eval_batches:
        cls = np.asarray(b["labels"]["obj_idx"]).astype(np.int64)
        pts = points[torch.as_tensor(cls)]
        eye = torch.eye(3).expand(len(cls), 3, 3)
        zero = torch.zeros(len(cls), 3)
        gt = (torch.as_tensor(np.asarray(b["labels"]["rot_gt"], np.float32)),
              torch.as_tensor(np.asarray(b["labels"]["trans_gt"], np.float32)))
        dist = add_s_batch(pts, eye, zero, *gt).numpy()
        if protocol == "add_0.1d":
            add = add_batch(pts, eye, zero, *gt).numpy()
            dist = np.where(np.isin(cls, np.asarray(sym_ids, np.int64)), dist, add)
        dists += [float(x) for x in dist]
        clss += [int(c) for c in cls]
    if protocol == "add_0.1d":
        return success_at_diameter(dists, clss, diams)["success_mean"] * 100.0
    return per_class_auc_acc(dists, clss, num_classes=n_classes)["auc_mean"]


def pose_drift(model_a, model_b, eval_batches, device) -> dict:
    """Rotation (degrees, chord form) and translation (mm) between two
    models' eval-mode poses on the batches: max and 95th percentile."""
    import numpy as np
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch

    deg, mm = [], []
    for b in eval_batches:
        tb = batch_to_torch(b, device)
        with torch.inference_mode():
            out = [m.eval()(tb) for m in (model_a, model_b)]
        ra, rb = (o["rot_pred"].double().cpu().numpy() for o in out)
        ta, tb_ = (o["trans_pred"].double().cpu().numpy() for o in out)
        chord = np.linalg.norm(ra - rb, axis=(1, 2)) / (2.0 * np.sqrt(2.0))
        deg.append(np.degrees(2.0 * np.arcsin(np.clip(chord, 0.0, 1.0))))
        mm.append(np.linalg.norm(ta - tb_, axis=1) * 1000.0)
    deg, mm = np.concatenate(deg), np.concatenate(mm)
    return {"rot_deg_max": float(deg.max()), "rot_deg_p95": float(np.percentile(deg, 95)),
            "trans_mm_max": float(mm.max()), "trans_mm_p95": float(np.percentile(mm, 95))}


def build(args: argparse.Namespace, grid_side: int = 64, n_points: int = 1024):
    """The run's data and stage-1 model at a grid of grid_side^3 cells (the
    volume of the 64^3 grid at 6 mm) and n_points points a branch: a
    namespace of dev, grid, unit, n_classes, spf, train_ds, heldout_ds, the
    loader (shuffled by --seed), the model (weights from --seed),
    model_points and the held-out eval_batches (the datasets' seed 0 for
    every --seed)."""
    import types

    import numpy as np
    import torch

    from dcl_net_tpu_torch import resolve_device
    from dcl_net_tpu_torch.data import SyntheticPoseDataset, make_batch
    from dcl_net_tpu_torch.data.loader import BatchLoader
    from dcl_net_tpu_torch.models import DCLNet

    dev = resolve_device(args.device)
    grid = (grid_side,) * 3
    unit = (UNIT_AT_64 * 64 / grid_side,) * 3
    n_classes = args.classes
    spf = max(args.samples_per_frame, 0)
    width = dict(n_points=n_points, unit_voxel_extent=unit, voxel_num_limit=grid, seed=0,
                 cad_dir=args.cad_dir)
    # frame mode indexes frames; the pool stays TRAIN_LEN at every spf, as
    # the JAX script keeps it
    train_ds = SyntheticPoseDataset(n_objects=n_classes, length=TRAIN_LEN,
                                    frame_mode=bool(spf), samples_per_frame=max(spf, 1),
                                    **width)
    # held out: the same objects, the per-sample streams of indices past the
    # training range (a sample's RNG is keyed by its index)
    heldout_ds = SyntheticPoseDataset(n_objects=n_classes, length=TRAIN_LEN + HELD_LEN,
                                      **width)
    n_classes = len(train_ds.cad_points)  # cad_dir may set the class count
    loader = BatchLoader(train_ds, batch_size=args.batch, num_workers=args.workers,
                         seed=args.seed, worker_type=args.worker_type,
                         samples_per_item=max(spf, 1))

    model = DCLNet(unit_voxel_extent=unit, voxel_num_limit=grid, interp_mode="pallas",
                   dtype=torch.bfloat16, device=dev, seed=args.seed)  # the production config
    model_points = np.stack([heldout_ds.model_points(c, MODEL_POINTS)
                             for c in range(n_classes)])
    eval_batches = [make_batch([heldout_ds[TRAIN_LEN + k * HELD_BATCH + i]
                                for i in range(HELD_BATCH)]).to_dict()
                    for k in range(HELD_BATCHES)]
    return types.SimpleNamespace(dev=dev, grid=grid, unit=unit, n_classes=n_classes, spf=spf,
                                 train_ds=train_ds, heldout_ds=heldout_ds, loader=loader,
                                 model=model, model_points=model_points,
                                 eval_batches=eval_batches)


def run(args: argparse.Namespace, grid_side: int = 64, n_points: int = 1024,
        log=print) -> dict:
    """The acceptance at a grid of grid_side^3 cells (the volume of the
    64^3 grid at 6 mm) and n_points points a branch. Returns the result."""
    import torch

    from dcl_net_tpu_torch import autotune_convs
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data import batch_to_torch
    from dcl_net_tpu_torch.eval import Evaluator, Stage2Evaluator
    from dcl_net_tpu_torch.models import DCLNet, Refiner, dcl_losses
    from dcl_net_tpu_torch.train import TrainState, build_optimizer, make_train_step
    from dcl_net_tpu_torch.train.checkpoints import save_checkpoint
    from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step

    w = build(args, grid_side, n_points)
    dev, grid, unit, n_classes, spf = w.dev, w.grid, w.unit, w.n_classes, w.spf
    train_ds, loader, model = w.train_ds, w.loader, w.model
    model_points, eval_batches = w.model_points, w.eval_batches
    if dev.type == "cuda":
        autotune_convs()  # as Solver does: cuDNN's default f32 3D wgrad is slow
    cfg_d = {"optimizer": {"type": "Adam", "lr": args.lr, "betas": [0.5, 0.999],
                           "eps": 1e-6},
             "clip_percentile": 50}
    if args.protocol == "add_0.1d":
        # the LM schedule's shape (reference configs/config_LM.yaml: StepLR,
        # gamma 0.5), compressed so that about 2 decays land inside the run
        cfg_d["lr_scheduler"] = {"type": "StepLR", "step_size": 20, "gamma": 0.5}
    opt, _ = build_optimizer(Config(cfg_d), steps_per_epoch=max(len(loader), 1))

    bank = train_ds.template_bank()
    bank_dev = batch_to_torch(dict(bank), dev) if args.bank else None
    step = make_train_step(model, opt, dcl_losses, template_bank=bank_dev)
    params = [p for p in model.parameters() if p.requires_grad]
    state = TrainState(opt.init(sum(p.numel() for p in params), dev))

    protocol_kw, metric_key, scale, sym_ids, diams = build_protocol(
        args.protocol, train_ds, n_classes)
    if args.protocol == "add_0.1d":
        log(f"add_0.1d protocol: {len(sym_ids)} sym classes {sym_ids}, "
            f"0.1*diam {['%.3f' % d for d in diams]}")
    # one Evaluator for every evaluation: update_variables re-encodes its
    # template cache from the weights as they are
    evaluator = Evaluator(model, model_points, protocol=args.protocol, template_bank=bank,
                          device=dev, **protocol_kw)

    def score(ev) -> float:
        return float(ev.evaluate(eval_batches)[metric_key]) * scale

    identity = identity_baseline(eval_batches, model_points, args.protocol, sym_ids, diams,
                                 n_classes)
    log(f"identity-pose baseline [{args.protocol}]: {identity:.2f}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def batches():
        """The loader's batches, epoch after epoch, without end."""
        while True:
            for b in loader:
                yield b

    # ---- stage 1 ----
    t0 = time.time()
    wait = 0.0
    losses, evals = [], []
    auc = None
    it = batches()
    for i in range(1, args.steps + 1):
        tw = time.perf_counter()
        batch = next(it)
        wait += time.perf_counter() - tw
        m = step(state, batch_to_torch(batch, dev))
        if i % 100 == 0 or i == args.steps:
            loss = float(m["loss_all"])
            losses.append([i, loss])
            log(f"[{i}/{args.steps}] loss={loss:.4f} "
                f"({(time.time() - t0) / i * 1000:.0f} ms/step, loader wait "
                f"{wait:.1f} s)")
        if i % args.eval_every == 0 or i == args.steps:
            evaluator.update_variables()
            auc = score(evaluator)
            evals.append([i, auc])
            log(f"[{i}] held-out {metric_key}: {auc:.2f}")
    sync()
    stage1_s = time.time() - t0
    stage1_wait = wait
    stage1_auc = auc

    # ---- the trained model's bf16 drift: an f32 copy of its weights ----
    model_f32 = DCLNet(unit_voxel_extent=unit, voxel_num_limit=grid, interp_mode="pallas",
                       device=dev, seed=args.seed)
    model_f32.load_state_dict(model.state_dict())
    drift = pose_drift(model, model_f32, eval_batches, dev)
    drift["stage1_auc_f32"] = score(Evaluator(model_f32, model_points,
                                              protocol=args.protocol, template_bank=bank,
                                              device=dev, **protocol_kw))
    del model_f32
    log(f"trained model, bf16 vs f32 on the held-out rows: {drift}")

    # ---- stage 2: the refiner on the frozen stage 1 ----
    t2 = time.time()
    cld = torch.as_tensor(model_points, device=dev)
    refiner = Refiner(n_inp=n_points, device=dev, seed=args.seed + 1)
    step2 = make_stage2_train_step(model, refiner, opt, ITERATIONS, cld)
    rstate = TrainState(opt.init(sum(p.numel() for p in refiner.parameters()), dev))
    wait = 0.0
    for i in range(1, args.stage2_steps + 1):
        tw = time.perf_counter()
        batch = next(it)
        wait += time.perf_counter() - tw
        m2 = step2(rstate, batch_to_torch(batch, dev))
        if i % 100 == 0 or i == args.stage2_steps:
            log(f"[s2 {i}/{args.stage2_steps}] loss={float(m2['loss_all']):.4f}")
    sync()
    stage2_s = time.time() - t2
    ev2 = Stage2Evaluator(model, refiner, model_points, iterations=ITERATIONS,
                          protocol=args.protocol, template_bank=bank, device=dev,
                          **protocol_kw)
    stage2_auc = score(ev2)
    loader.close()

    if args.save:
        for name, module, steps in (("stage1", model, args.steps),
                                    ("stage2", refiner, args.stage2_steps)):
            path = save_checkpoint(os.path.join(args.save, name), module,
                                   TrainState({}, steps), steps,
                                   meta={"script": "torch_synthetic_convergence",
                                         "grid": list(grid), "n_points": n_points})
            log(f"{name} weights: {path}")

    return {
        "protocol": args.protocol,
        "config": "banked-template" if args.bank else "per-instance",
        "samples_per_frame": spf or None,
        "steps": args.steps, "batch": args.batch, "seed": args.seed,
        "classes": n_classes, "cad_dir": args.cad_dir,
        "identity_auc": identity,
        "stage1_auc": stage1_auc,
        "stage2_auc": stage2_auc,
        "wall_min": round((time.time() - t0) / 60, 1),
        "stage1_s": stage1_s, "stage2_s": stage2_s,
        "samples_per_s": args.steps * args.batch / stage1_s,
        "loader_wait_s": stage1_wait, "stage2_loader_wait_s": wait,
        "losses": losses, "evals": evals, "bf16_drift": drift,
        "grid": list(grid), "n_points": n_points,
    }


def bars(result: dict, auc_bar: float) -> dict:
    """The acceptance bars, each True (passed) or False; none at bar 0 but
    the first, which any score passes."""
    s1, s2, ident = result["stage1_auc"], result["stage2_auc"], result["identity_auc"]
    out = {f"stage1 >= {auc_bar}": s1 >= auc_bar}
    if auc_bar > 0:
        out["stage1 >= identity + 10"] = s1 >= ident + 10
        out["stage2 >= stage1 - 0.5"] = s2 >= s1 - 0.5
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    import subprocess

    import torch

    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_synthetic_convergence: no CUDA device", file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60)
        print(f"card: {smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else 'n/a'}",
              flush=True)
    result = run(args, log=lambda s: print(s, flush=True))
    print(json.dumps(result), flush=True)
    verdict = bars(result, args.auc_bar)
    for name, ok in verdict.items():
        print(f"bar {name}: {'passed' if ok else 'FAILED'}", flush=True)
    ok = all(verdict.values())
    print("CONVERGENCE ACCEPTANCE: " + ("OK" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
