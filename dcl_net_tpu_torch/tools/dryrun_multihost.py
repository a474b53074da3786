"""Multi-process data-parallel dryrun of the port.

Counterpart of dcl_net_tpu/tools/dryrun_multihost.py: runs the
multi-process path (the rendezvous, BatchLoader process striding, the
synced BatchNorms, the gradient all-reduce, the evaluator's gather) on a
small synthetic model, as one process or as H processes that meet through
a coordinator, and writes what it measured as JSON. The global batch is
the same in both, so the H-process run must give the single process's
per-step losses (to float tolerance), its eval summary and its stage-2
losses (tests/test_torch_multihost.py). Three arms: stage-1 training
losses, the eval summary (Evaluator over two global batches, each process
scoring its block) and the stage-2 refiner's losses.

Single process:
  python -m dcl_net_tpu_torch.tools.dryrun_multihost --device cpu --out ref.json
Two processes (each one rank; NCCL with --device cuda, gloo on the CPU):
  python -m dcl_net_tpu_torch.tools.dryrun_multihost --device cpu \
      --coordinator file:///tmp/rdv --num_hosts 2 --host_id 0 --out h0.json &
  python -m dcl_net_tpu_torch.tools.dryrun_multihost --device cpu \
      --coordinator file:///tmp/rdv --num_hosts 2 --host_id 1
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="multi-process data-parallel dryrun")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous (host:port, tcp:// or file://); omit for one process")
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=0)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=8, help="the GLOBAL batch size")
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    p.add_argument("--out", default=None, help="rank 0 writes the JSON result here")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dcl_net_tpu_torch import resolve_device
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.loader import BatchLoader
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.eval.evaluator import Evaluator
    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
    from dcl_net_tpu_torch.models.refiner import Refiner
    from dcl_net_tpu_torch.parallel.mesh import (
        destroy, init_distributed, make_parallel_train_step, replicate, shard_batch,
    )
    from dcl_net_tpu_torch.train.solver import TrainState, build_optimizer
    from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step

    device = resolve_device(args.device)
    group = None
    if args.coordinator:
        group = init_distributed(args.coordinator, args.num_hosts, args.host_id,
                                 device=device)
        device = group.device
    rank, world = (group.rank, group.world) if group else (0, 1)
    try:
        grid, unit, n = (16, 16, 16), (0.024, 0.024, 0.024), 64
        ds = SyntheticPoseDataset(n_objects=2, n_points=n, unit_voxel_extent=unit,
                                  voxel_num_limit=grid, seed=0,
                                  length=args.batch * args.steps)
        loader = BatchLoader(ds, batch_size=args.batch, shuffle=True, num_workers=2,
                             seed=0, process_id=rank, process_count=world)
        kw = dict(unit_voxel_extent=unit, voxel_num_limit=grid,
                  capacities=(512, 512, 64, 8), device=device, seed=0)
        model = DCLNet(**kw)
        opt, _ = build_optimizer(Config({"optimizer": {"type": "Adam", "lr": 1e-3}}), 1)
        step = make_parallel_train_step(model, opt, dcl_losses, group)
        state = TrainState(opt.init(sum(q.numel() for q in model.parameters())))
        losses = [float(step(state, batch_to_torch(b, device))["loss_all"])
                  for b in loader]

        # eval arm: every process builds the same two global batches and
        # scores its block; the gathered summary must be the single process's
        rows = [ds[i] for i in range(2 * args.batch)]
        eval_batches = [shard_batch(make_batch(rows[k * args.batch:(k + 1) * args.batch])
                                    .to_dict(), group) for k in range(2)]
        model_points = np.stack([ds.model_points(c, 32) for c in range(2)])
        eval_model = DCLNet(**kw)
        res = Evaluator(eval_model, model_points, device=device,
                        group=group).evaluate(iter(eval_batches))
        eval_metrics = {k: res[k] for k in ("auc_mean", "acc_mean", "n_scored",
                                            "n_overflow")}

        # stage-2 arm: refiner steps on the frozen eval model
        refiner = replicate(Refiner(n_inp=n, device=device, seed=1), group)
        opt2, _ = build_optimizer(Config({"optimizer": {"type": "Adam", "lr": 1e-3}}), 1)
        s2_step = make_stage2_train_step(eval_model, refiner, opt2, 2,
                                         torch.as_tensor(model_points, device=device),
                                         group=group)
        s2_state = TrainState(opt2.init(sum(q.numel() for q in refiner.parameters())))
        s2_losses = [float(s2_step(s2_state, batch_to_torch(b, device))["loss_all"])
                     for b in eval_batches]

        result = {"losses": losses, "eval": eval_metrics, "stage2_losses": s2_losses,
                  "process_count": world, "global_batch": args.batch,
                  "device": str(device)}
        print(json.dumps(result), flush=True)
        if args.out and rank == 0:
            with open(args.out, "w") as f:
                json.dump(result, f)
        return result
    finally:
        destroy(group)


if __name__ == "__main__":
    main()
