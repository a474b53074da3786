"""Data-parallel training and eval over NCCL, one rank a GPU, held to one
process at the same global batch.

The model is configs/config_YCBV_bs32.yaml's at full width, with seeded
weights (seed 0), on YCB-V-shaped synthetic data of data/synthetic.py (16
classes, seed 0), at the config's global batch of 32 (16 rows a rank at
world 2, 8 at world 4). cuDNN's autotuning is off, as in chip_smoke.py
phase 15. First one process on cuda:0 computes the references. Then N ranks
start, rank r on cuda:r over NCCL, at each world of --worlds. Each runs
what the reference ran, on its block of each global batch:
- 3 stage-1 train steps through make_parallel_train_step, each on its own
  global batch, on the two-stage ("pallas") and the fused ("pallas_fused")
  path, in f32 and in bf16;
- one stage-2 refiner step on a frozen fused f32 stage 1
  (train/stage2.py);
- Evaluator over the group: the two-stage f32 model with the template
  bank, on 2 global batches of 32.

The checks, with chip_smoke.py's bounds:
- the step-1 losses within TRAIN_LOSS_RTOL (1e-5) relative in f32, and
  BF16_LOSS_RTOL (2^-7) in bf16, whose results depend on the per-rank
  batch (the constant's comment);
- the all-reduced flat gradient of step 1 (8,393,972 entries) within
  TRAIN_GRAD_REL_L2 (5e-3) relative L2 in f32; in bf16 within GRAD_FACTOR
  times the distance of one process's bf16 gradient from its f32 one on
  the same batch (the constant's comment); the same gradient bits on every
  rank;
- the BN running statistics after step 1 within TRAIN_GRAD_REL_L2 in f32,
  BF16_TRAIN_GRAD_REL_L2 (2e-2) in bf16;
- the loss_all of steps 2 and 3 within PARALLEL_LATER_RTOL (5e-2);
- the ranks' parameters equal after every step;
- the refiner step's losses within TRAIN_LOSS_RTOL;
- the Evaluator's report equal to one process's, on every rank;
- each rank's parameters, optimizer state, BN statistics and step metrics
  on cuda:r;
- each rank's kernel launches: phase 15's per-rank counts, in the bf16
  variants for bf16.
Then one torchrun launch at each world (python -m torch.distributed.run,
which is torchrun: --standalone --nproc_per_node N -m
dcl_net_tpu_torch.tools.train_stage1 --config
configs/config_synthetic_smoke.yaml) must end with rc 0, every rank
logging the same parameter digest.

Run it on a machine with at least two GPUs, from the root of a checkout:

    python3 scripts/train_ddp_multi_gpu.py [--worlds 2 4]

It prints the card's name and power limit, per rank the errors, the step
seconds and the milliseconds of one NCCL all-reduce of the 33.6 MB flat
gradient, and exits 1 when a check fails. The milliseconds are recorded,
not judged. `--device cpu` runs the same ranks over gloo on the CPU (the
port's tests do, at a 16^3 grid).
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the bounds, the launch counters)

BATCH = 32  # the global batch: config_YCBV_bs32.yaml's bs
N_CLASSES = 16
STEPS = cs.PARALLEL_STEPS  # 3
EVAL_BATCHES = cs.PARALLEL_EVAL_BATCHES  # 2
PATHS = ("pallas", "pallas_fused")
DTYPES = ("f32", "bf16")
TIMEOUT = 900.0  # seconds the ranks of a world may take, start-up included
TORCHRUN_TIMEOUT = 600.0
LOSS_KEYS = ("loss_pose", "loss_Xo", "loss_Yc", "loss_conf", "loss_all")
STAGE2_KEYS = ("loss_all", "loss_last_iter")
PER_STEP = {("pallas", "f32"): cs.TWO_STAGE_TRAIN, ("pallas_fused", "f32"): cs.FUSED_TRAIN,
            ("pallas", "bf16"): cs.TWO_STAGE_TRAIN_BF16,
            ("pallas_fused", "bf16"): cs.FUSED_TRAIN_BF16}
STAGE2_COUNTS = {"voxelize": 2, "compact": 8, "fused": 8}
EVAL_COUNTS = {"voxelize": 1, "compact": 4, "interp": 4}  # an encode; the bank's once
# A bf16 step's losses depend on the per-rank batch: the bf16 GEMMs of the
# heads take another schedule at another row count and round their bf16
# outputs otherwise (eval-mode poses of one model 2.4e-3 apart at 2 and 4
# rows on the CPU; PR 15's served bf16 artifact one ulp and 0.36 degrees
# apart at 8 and 32 rows on an H100), so TRAIN_LOSS_RTOL does not apply to
# bf16: its step-1 losses are held within one bf16 rounding of a head's
# output, 2^-7 relative. f32 keeps TRAIN_LOSS_RTOL.
BF16_LOSS_RTOL = 2.0 ** -7
# The same holds for a bf16 step's gradient, and more: each flipped rounding
# is carried through the bf16 backward of the whole network, so two correct
# bf16 steps that round differently end about as far apart as bf16 is from
# f32 (tests/test_torch_bf16_train_model.py). A bf16 gradient of the ranks
# is held, as that test holds the port's bf16 step to JAX's, within
# GRAD_FACTOR times the distance of one process's bf16 gradient from its f32
# gradient on the same batch. The script also prints, as a control, how far
# one process's bf16 gradient moves when only cuDNN's choice of algorithms
# changes (autotuned instead of the heuristic's).
GRAD_FACTOR = 2.0
DIGEST = re.compile(r"rank (\d+) of (\d+): parameters sha256 ([0-9a-f]{64})")


def make_inputs(cfg, batch: int = BATCH) -> dict:
    """The global batches (numpy), template bank and CAD clouds of the run."""
    import numpy as np

    from dcl_net_tpu_torch.data.schema import make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset

    m = cfg.model
    ds = SyntheticPoseDataset(n_objects=N_CLASSES, n_points=int(m.n_inp),
                              unit_voxel_extent=tuple(m.unit_voxel_extent),
                              voxel_num_limit=tuple(int(d) for d in m.voxel_num_limit),
                              seed=0)
    n = STEPS + EVAL_BATCHES
    samples = [ds[i] for i in range(batch * n)]
    batches = [make_batch(samples[i * batch:(i + 1) * batch]).to_dict() for i in range(n)]
    return {"cfg": cfg.to_dict(), "train": batches[:STEPS], "eval": batches[STEPS:],
            "bank": ds.template_bank(),
            "model_points": np.stack([ds.model_points(c, cs.MODEL_POINTS)
                                      for c in range(N_CLASSES)])}


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_case(cfg, mode: str, dtype: str, global_batches, group, dev) -> dict:
    """STEPS train steps of a seeded model on this rank's blocks of the
    global batches (all of each without a group): per step the global
    metrics and seconds, step 1's flat gradient (after the all-reduce) and
    BN statistics, the launch counts, whether every rank held the same
    parameters after every step and the same gradient, and whether the
    state lies on `dev`."""
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
    from dcl_net_tpu_torch.parallel.mesh import active, make_parallel_train_step, shard_batch
    from dcl_net_tpu_torch.train.solver import TrainState, bn_statistics, build_optimizer

    model = DCLNet.from_config(cfg.model, seed=0, device=dev, interp_mode=mode,
                               dtype=torch.bfloat16 if dtype == "bf16" else None)
    opt, _ = build_optimizer(cfg, 1)
    grads = []
    update = opt.update

    def record(grad, norm, state):
        if not grads:
            grads.append(grad.detach().clone())
        return update(grad, norm, state)

    opt.update = record
    step = make_parallel_train_step(model, opt, dcl_losses, group)
    params = [p for p in model.parameters() if p.requires_grad]
    stats = bn_statistics(model)
    state = TrainState(opt.init(sum(p.numel() for p in params), dev))
    blocks = [batch_to_torch(shard_batch(b, group), dev) for b in global_batches]
    _sync(dev)
    cs.reset_counts()
    steps, same, stats1 = [], True, None
    on_device = True
    for k, b in enumerate(blocks):
        t0 = time.perf_counter()
        metrics = step(state, b)
        _sync(dev)
        seconds = time.perf_counter() - t0
        on_device &= all(v.device == dev for v in metrics.values())
        steps.append({"metrics": {n: float(v) for n, v in metrics.items()},
                      "seconds": seconds})
        if k == 0:
            stats1 = torch.cat([s.detach().reshape(-1) for s in stats]).cpu()
        if active(group):
            same &= cs.same_on_every_rank(params, group)
    counts = cs.read_counts()
    same_grad = cs.same_on_every_rank([grads[0]], group) if active(group) else True
    on_device &= (all(p.device == dev for p in params) and all(s.device == dev for s in stats)
                  and all(v.device == dev for v in state.opt_state.values()))
    return {"steps": steps, "grad": grads[0].cpu(), "stats": stats1, "counts": counts,
            "same_params": same, "same_grad": same_grad, "on_device": on_device}


def stage2_case(cfg, inputs, group, dev) -> dict:
    """One refiner step on a frozen fused f32 stage 1 (seeded weights) on
    this rank's block of the first global batch."""
    import numpy as np
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.models.refiner import Refiner
    from dcl_net_tpu_torch.parallel.mesh import replicate, shard_batch
    from dcl_net_tpu_torch.train.solver import TrainState, build_optimizer
    from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step

    stage1 = DCLNet.from_config(cfg.model, seed=0, device=dev, interp_mode="pallas_fused")
    refiner = replicate(Refiner(n_inp=int(cfg.model.n_inp), seed=1, device=dev), group)
    opt, _ = build_optimizer(cfg, 1)
    cld = torch.as_tensor(np.asarray(inputs["model_points"], np.float32), device=dev)
    step = make_stage2_train_step(stage1, refiner, opt, cs.ITERATIONS, cld, group=group)
    state = TrainState(opt.init(sum(p.numel() for p in refiner.parameters()), dev))
    batch = batch_to_torch(shard_batch(inputs["train"][0], group), dev)
    cs.reset_counts()
    metrics = step(state, batch)
    _sync(dev)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "counts": cs.read_counts(),
            "on_device": all(p.device == dev for p in refiner.parameters())
            and all(v.device == dev for v in metrics.values())}


def eval_case(cfg, inputs, group, dev) -> dict:
    """Evaluator (two-stage f32, seeded weights, the template bank) over
    this rank's blocks of the global eval batches."""
    from dcl_net_tpu_torch.eval.evaluator import Evaluator
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.parallel.mesh import shard_batch

    model = DCLNet.from_config(cfg.model, seed=0, device=dev)
    blocks = [shard_batch(b, group) for b in inputs["eval"]]
    _sync(dev)
    cs.reset_counts()
    t0 = time.perf_counter()
    res = Evaluator(model, inputs["model_points"], template_bank=inputs["bank"], device=dev,
                    group=group).evaluate(blocks)
    _sync(dev)
    return {"summary": {k: res[k] for k in ("auc_mean", "acc_mean", "n_scored", "n_overflow")},
            "seconds": time.perf_counter() - t0, "counts": cs.read_counts()}


def schedule_control(cfg, inputs, dev):
    """One process's bf16 step-1 gradient on the two-stage path with cuDNN's
    autotuned algorithms (None on the CPU, where there is no choice)."""
    import torch

    if dev.type != "cuda":
        return None
    torch.backends.cudnn.benchmark = True
    try:
        return train_case(cfg, "pallas", "bf16", inputs["train"][:1], None, dev)["grad"]
    finally:
        torch.backends.cudnn.benchmark = False


def run_all(inputs, group, dev) -> dict:
    """Everything one process (group None) or one rank runs; one process
    also runs schedule_control."""
    from dcl_net_tpu_torch.config import Config

    cfg = Config(inputs["cfg"])
    out = {"train": {}}
    for dtype in DTYPES:
        for mode in PATHS:
            out["train"][f"{mode}/{dtype}"] = train_case(cfg, mode, dtype, inputs["train"],
                                                         group, dev)
    if group is None:
        out["control"] = schedule_control(cfg, inputs, dev)
    out["stage2"] = stage2_case(cfg, inputs, group, dev)
    out["eval"] = eval_case(cfg, inputs, group, dev)
    return out


def allreduce_ms(group, dev) -> float:
    """Milliseconds of one all-reduce of a flat f32 gradient of the stage-1
    model (CUDA events on a card, the host's clock on the CPU)."""
    import torch
    import torch.distributed as dist

    x = torch.ones(cs.FLAT_GRAD_NUMEL, device=dev)
    if dev.type == "cuda":
        return cs.cuda_ms(lambda: dist.all_reduce(x), reps=20, warmup=3)
    dist.all_reduce(x)
    t0 = time.perf_counter()
    for _ in range(5):
        dist.all_reduce(x)
    return (time.perf_counter() - t0) / 5 * 1e3


def rank_main(rank: int, world: int, init: str, tmp: str, device_type: str) -> None:
    """One rank: cuda:rank over NCCL, or the CPU over gloo. Leaves its
    results in <tmp>/rank<r>_w<world>.pt."""
    import torch

    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.parallel.mesh import destroy, init_distributed

    strict_f32()
    torch.backends.cudnn.benchmark = False  # no autotuning of the ranks' shapes
    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if dev.type == "cpu":
        torch.set_num_threads(2)
    group = init_distributed(init, world, rank, device=dev)
    try:
        inputs = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
        out = run_all(inputs, group, dev)
        for case in out["train"].values():
            if rank:
                case["grad"] = None  # every rank's is rank 0's (same_grad)
        out["allreduce_ms"] = allreduce_ms(group, dev)
        out["backend"] = group.backend
        torch.save(out, Path(tmp) / f"rank{rank}_w{world}.pt")
    finally:
        destroy(group)


def run_world(world: int, tmp: str, device_type: str) -> list:
    """Start the ranks of a world and wait for them: a rank that raises
    ends the others, as does TIMEOUT. Returns each rank's results."""
    import torch

    init = "file://" + str(Path(tmp) / f"rendezvous_{world}")
    ctx = torch.multiprocessing.start_processes(
        rank_main, args=(world, init, tmp, device_type), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.perf_counter() + TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"the ranks of world {world} did not end")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(Path(tmp) / f"rank{r}_w{world}.pt", weights_only=False)
            for r in range(world)]


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def _rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def compare(ref: dict, ranks: list, world: int, launches: bool = True) -> tuple:
    """(ok, report lines) of a world's ranks against the one-process
    references. launches: hold the kernel launch counts (on the CPU no
    kernel launches)."""
    lines, ok = [], True

    def hold(cond: bool, what: str) -> None:
        nonlocal ok
        if not cond:
            ok = False
            lines.append(f"FAILED: world {world}: {what}")

    for key, want in ref["train"].items():
        mode, dtype = key.split("/")
        grad_rel = _rel_l2(ranks[0]["train"][key]["grad"], want["grad"])
        stats_bound = cs.BF16_TRAIN_GRAD_REL_L2 if dtype == "bf16" else cs.TRAIN_GRAD_REL_L2
        bound, yardstick = cs.TRAIN_GRAD_REL_L2, ""
        if dtype == "bf16":
            vs_f32 = _rel_l2(want["grad"], ref["train"][f"{mode}/f32"]["grad"])
            bound = GRAD_FACTOR * vs_f32
            yardstick = f"; one process's bf16 vs f32 {vs_f32:.3g}"
            if ref.get("control") is not None and mode == "pallas":
                yardstick += (f", its bf16 with autotuned cuDNN algorithms "
                              f"{_rel_l2(ref['control'], want['grad']):.3g}")
        for r, res in enumerate(ranks):
            got = res["train"][key]
            loss_rel = max(_rel(got["steps"][0]["metrics"][k], want["steps"][0]["metrics"][k])
                           for k in LOSS_KEYS)
            later = max(_rel(g["metrics"]["loss_all"], w["metrics"]["loss_all"])
                        for g, w in zip(got["steps"][1:], want["steps"][1:]))
            stats_rel = _rel_l2(got["stats"], want["stats"])
            loss_bound = BF16_LOSS_RTOL if dtype == "bf16" else cs.TRAIN_LOSS_RTOL
            hold(loss_rel <= loss_bound,
                 f"rank {r} {key}: step-1 losses rel {loss_rel:.3g} (bound {loss_bound})")
            hold(grad_rel <= bound, f"{key}: step-1 gradient rel L2 {grad_rel:.3g}")
            hold(stats_rel <= stats_bound,
                 f"rank {r} {key}: BN statistics rel L2 {stats_rel:.3g}")
            hold(later <= cs.PARALLEL_LATER_RTOL,
                 f"rank {r} {key}: later losses rel {later:.3g}")
            hold(got["same_params"] and got["same_grad"],
                 f"rank {r} {key}: the ranks' parameters or gradients differ")
            hold(got["on_device"], f"rank {r} {key}: state not on the rank's device")
            want_counts = {k: PER_STEP[(mode, dtype)].get(k, 0) * STEPS * launches
                           for k in cs.KERNEL_ORDER}
            hold(got["counts"] == want_counts,
                 f"rank {r} {key}: launches {got['counts']}, expected {want_counts}")
            lines.append(
                f"world {world} rank {r} {key}: step-1 losses rel {loss_rel:.3g}, flat "
                f"gradient rel L2 {grad_rel:.3g} (bound {bound:.3g}{yardstick}), BN "
                f"statistics rel L2 "
                f"{stats_rel:.3g}, steps 2-{STEPS} loss_all rel {later:.3g}; step seconds "
                f"{['%.4f' % s['seconds'] for s in got['steps']]} (one process "
                f"{['%.4f' % s['seconds'] for s in want['steps']]})")
    for r, res in enumerate(ranks):
        s2 = res["stage2"]
        s2_rel = max(_rel(s2["metrics"][k], ref["stage2"]["metrics"][k]) for k in STAGE2_KEYS)
        hold(s2_rel <= cs.TRAIN_LOSS_RTOL, f"rank {r} stage-2 losses rel {s2_rel:.3g}")
        hold(s2["on_device"], f"rank {r} stage 2: refiner not on the rank's device")
        want_counts = {k: STAGE2_COUNTS.get(k, 0) * launches for k in cs.KERNEL_ORDER}
        hold(s2["counts"] == want_counts, f"rank {r} stage-2 launches {s2['counts']}")
        ev = res["eval"]
        hold(ev["summary"] == ref["eval"]["summary"],
             f"rank {r} eval {ev['summary']} != one process's {ref['eval']['summary']}")
        want_counts = {k: EVAL_COUNTS.get(k, 0) * (1 + EVAL_BATCHES) * launches
                       for k in cs.KERNEL_ORDER}
        hold(ev["counts"] == want_counts, f"rank {r} eval launches {ev['counts']}")
        lines.append(
            f"world {world} rank {r} ({res['backend']}): stage-2 step losses rel {s2_rel:.3g}; "
            f"Evaluator {ev['summary']} ({ev['seconds']:.3f} s; one process "
            f"{ref['eval']['seconds']:.3f} s); one all-reduce of the flat gradient "
            f"({cs.FLAT_GRAD_NUMEL} f32, {cs.FLAT_GRAD_NUMEL * 4 / 1e6:.1f} MB) "
            f"{res['allreduce_ms']:.4f} ms")
    return ok, lines


def torchrun_check(world: int, tmp: str, overrides=(), device=None) -> tuple:
    """(ok, report line) of one torchrun launch of the stage-1 CLI on the
    synthetic smoke config: rc 0 and one parameter digest, logged by every
    rank."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}", "-m", "dcl_net_tpu_torch.tools.train_stage1",
           "--config", str(ROOT / "configs" / "config_synthetic_smoke.yaml"),
           "--log_root", str(Path(tmp) / f"torchrun_w{world}")]
    if device:
        cmd += ["--device", device]
    if overrides:
        cmd += ["--override", *overrides]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=TORCHRUN_TIMEOUT)
    seconds = time.perf_counter() - t0
    digests = {int(r): d for r, w, d in DIGEST.findall(out.stdout + out.stderr)
               if int(w) == world}
    ok = out.returncode == 0 and sorted(digests) == list(range(world)) \
        and len(set(digests.values())) == 1
    line = (f"torchrun --nproc_per_node {world} -m dcl_net_tpu_torch.tools.train_stage1 "
            f"(config_synthetic_smoke.yaml): rc {out.returncode}, {len(digests)} ranks logged "
            f"{len(set(digests.values()))} parameter digest(s) "
            f"{sorted(set(d[:12] for d in digests.values()))}; {seconds:.1f} s")
    if not ok:
        line = "FAILED: " + line + "\n" + (out.stdout + out.stderr)[-4000:]
    return ok, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", type=int, nargs="+", default=None,
                    help="the world sizes (default: every GPU of the machine)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.ops import cuda_build

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("train_ddp_multi_gpu: no CUDA device", file=sys.stderr)
            return 2
        n_gpus = torch.cuda.device_count()
        worlds = args.worlds or [n_gpus]
        if min(worlds) < 2 or max(worlds) > n_gpus:
            print(f"train_ddp_multi_gpu: worlds {worlds} need 2 to {n_gpus} GPUs",
                  file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60)
        cards = smi.stdout.strip().splitlines()
        print(f"{n_gpus} GPUs: " + "; ".join(cards), flush=True)
        t0 = time.perf_counter()
        cuda_build.build()
        cuda_build.library()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    else:
        worlds = args.worlds or [2]
    strict_f32()
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    cfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs32.yaml"))
    ok = True
    with tempfile.TemporaryDirectory(prefix="dclx_ddp_") as tmp:
        inputs = make_inputs(cfg)
        torch.save(inputs, Path(tmp) / "inputs.pt")
        t0 = time.perf_counter()
        ref = run_all(inputs, None, dev)
        print(f"one process on {dev} at global batch {BATCH}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for world in worlds:
            t0 = time.perf_counter()
            ranks = run_world(world, tmp, args.device)
            print(f"world {world} ({BATCH // world} rows a rank) ended in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            good, lines = compare(ref, ranks, world, launches=args.device == "cuda")
            ok &= good
            for line in lines:
                print(line, flush=True)
        for world in worlds:
            good, line = torchrun_check(world, tmp, device=args.device)
            ok &= good
            print(line, flush=True)
    print("data-parallel training over " + ("NCCL" if args.device == "cuda" else "gloo")
          + ": " + ("passed" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
