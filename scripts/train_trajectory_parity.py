#!/usr/bin/env python3
"""How far a run of train steps of the port drifts from the JAX package's,
on the CPU (no card needed), beside how far rounding alone moves the port.

Usage, from the root of the repository:
  python3 scripts/train_trajectory_parity.py [--steps 40] [--batch 8] [--every 10]

Both packages start from the same weights (the JAX model's PRNGKey(0)
init, carried into the port by weights.py), take the same batches (rows
0, 1, 2, ... of SyntheticPoseDataset(n_objects=8, seed=0), --batch a
step) and the same optimizer as the convergence scripts (AutoClip at the
50th percentile, Adam with lr 1e-3, betas 0.5 / 0.999, eps 1e-6), in f32
at a 16^3 grid with N = M = 128 (the sizes of tests/test_torch_train_*.py;
JAX on its exact path, the port on the two-stage path's plain versions).
A third run is the port again from the same weights moved by one f32 ulp
each (torch.nextafter towards +inf): it measures how far rounding alone
carries a run. Every --every steps it prints the relative L2 distance of
the port's parameters from JAX's and from the perturbed port's, and the
loss_all of the three runs (and after step 1).

If the port's training departed from the JAX package's (a term of the
loss, the optimizer, the BN statistics), its distance from JAX would grow
past the perturbed run's from the first steps on; if both grow alike, the
two packages differ by rounding only.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OPTIMIZER = {"optimizer": {"type": "Adam", "lr": 1e-3, "betas": [0.5, 0.999], "eps": 1e-6},
             "clip_percentile": 50}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--every", type=int, default=10)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from dcl_net_tpu.config import Config as JaxConfig
    from dcl_net_tpu.models import DCLNet as JaxDCLNet
    from dcl_net_tpu.models import dcl_losses as jax_dcl_losses
    from dcl_net_tpu.train.solver import build_optimizer as jax_build_optimizer
    from dcl_net_tpu.train.solver import init_train_state
    from dcl_net_tpu.train.solver import make_train_step as jax_make_train_step
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models import DCLNet, dcl_losses
    from dcl_net_tpu_torch.train import TrainState, build_optimizer, make_train_step
    from dcl_net_tpu_torch.weights import load_jax_variables, to_jax_variables

    torch.set_num_threads(4)
    grid, unit, n = (16, 16, 16), (0.024, 0.024, 0.024), 128
    kw = dict(unit_voxel_extent=unit, voxel_num_limit=grid, capacities=(256, 64, 16, 8))
    ds = SyntheticPoseDataset(n_objects=8, n_points=n, unit_voxel_extent=unit,
                              voxel_num_limit=grid, length=args.steps * args.batch, seed=0)
    batches = [make_batch([ds[i * args.batch + j] for j in range(args.batch)]).to_dict()
               for i in range(args.steps)]

    jmodel = JaxDCLNet(n_inp=n, n_tmp=n, **kw)
    tx, _ = jax_build_optimizer(JaxConfig(OPTIMIZER), steps_per_epoch=args.steps)
    jbatches = [jax.tree.map(jnp.asarray, b) for b in batches]
    jstate = init_train_state(jmodel, tx, jbatches[0])
    jstep = jax.jit(jax_make_train_step(jmodel, tx, jax_dcl_losses))
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})

    def port_run(perturb: bool):
        model = load_jax_variables(DCLNet(interp_mode="pallas", device="cpu", **kw),
                                   variables)
        if perturb:
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
        opt, _ = build_optimizer(Config(OPTIMIZER), steps_per_epoch=args.steps)
        params = [p for p in model.parameters() if p.requires_grad]
        return model, make_train_step(model, opt, dcl_losses), TrainState(
            opt.init(sum(p.numel() for p in params)))

    runs = {"port": port_run(False), "perturbed": port_run(True)}

    def flat(tree):
        return np.concatenate([np.asarray(x, np.float64).ravel()
                               for x in jax.tree.leaves(tree)])

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    print(f"{args.steps} f32 steps at batch {args.batch}, 16^3, N = {n}", flush=True)
    print("step  loss_all JAX / port / perturbed port   params rel L2: port vs JAX, "
          "port vs perturbed port", flush=True)
    for k, (b, jb) in enumerate(zip(batches, jbatches), start=1):
        jstate, jm = jstep(jstate, jb)
        losses = {}
        for name, (model, step, state) in runs.items():
            losses[name] = float(step(state, batch_to_torch(b, "cpu"))["loss_all"])
        if k % args.every and k not in (1, args.steps):
            continue
        jp = flat(jstate.params)
        port, pert = (flat(to_jax_variables(runs[name][0])["params"])
                      for name in ("port", "perturbed"))
        print(f"{k:4d}  {float(jm['loss_all']):.6f} / {losses['port']:.6f} / "
              f"{losses['perturbed']:.6f}   {rel(port, jp):.3g}, {rel(port, pert):.3g}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
