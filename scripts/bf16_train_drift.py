#!/usr/bin/env python3
"""How far a bf16 train step of the port is from the JAX package's, whole
and block by block, on the CPU (no card needed).

Usage, from the root of the repository:
  python3 scripts/bf16_train_drift.py [--batch 2 4 8] [--mode pallas]

Both packages take the same bridged PRNGKey(0) weights and the same batch
of SyntheticPoseDataset(n_objects=4, seed=0) at 16^3, N = 128 (the sizes of
tests/test_torch_bf16_train_*.py), with the symmetry flag on every other
sample. For each batch size it prints the relative L2 distance of the
flattened parameter gradient of one train step (dcl_losses) between
- the port in bf16 and JAX in bf16 (DCLNet(dtype=bfloat16,
  voxelize_impl="matmul")), compiled with XLA's excess precision off so
  that XLA rounds where the JAX program does;
- JAX bf16 and JAX f32 (the size of bf16 rounding itself);
- JAX bf16 with XLA's default excess precision and with it off;
and the losses. At the first batch size it then follows the observed
branch's train-mode forward block by block (each backbone block's output
and the four disengage heads): the relative L2 distance of the port's bf16
activations from JAX's bf16 ones, which shows where the two part.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[2, 4, 8])
    parser.add_argument("--mode", default="pallas", choices=("pallas", "pallas_fused"))
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    from flax.traverse_util import flatten_dict

    from dcl_net_tpu.models import DCLNet as JaxDCLNet
    from dcl_net_tpu.models import dcl_losses as jax_dcl_losses
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
    from dcl_net_tpu_torch.weights import load_jax_variables, to_jax_gradients

    grid, unit, n = (16, 16, 16), (0.024, 0.024, 0.024), 128
    kw = dict(unit_voxel_extent=unit, voxel_num_limit=grid, capacities=(256, 64, 16, 8))

    def compiled(fn, *a, excess=False):
        return jax.jit(fn).lower(*a).compile(
            compiler_options={"xla_allow_excess_precision": excess})(*a)

    def flat(tree):
        return np.concatenate([np.asarray(x, np.float64).ravel()
                               for x in jax.tree.leaves(tree)])

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def f32(x):
        return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)

    for i, b in enumerate(args.batch):
        ds = SyntheticPoseDataset(n_objects=4, n_points=n, unit_voxel_extent=unit,
                                  voxel_num_limit=grid, seed=0)
        batch = make_batch([ds[j] for j in range(b)]).to_dict()
        batch["sym_flag"] = (np.arange(b) % 2 == 0).astype(np.float32)
        jb = jax.tree.map(jnp.asarray, batch)
        init = JaxDCLNet(n_inp=n, n_tmp=n, **kw)
        variables = jax.tree.map(np.asarray, jax.jit(
            lambda k, bb: init.init(k, bb, train=False))(jax.random.PRNGKey(0), jb))

        def jax_step(dtype, excess=False):
            jm = JaxDCLNet(n_inp=n, n_tmp=n, dtype=dtype, interp_mode=args.mode,
                           voxelize_impl="matmul", **kw)

            def loss_fn(params, stats, bb):
                pred, _ = jm.apply({"params": params, "batch_stats": stats}, bb, train=True,
                                   mutable=["batch_stats"])
                losses = jax_dcl_losses(pred, bb)
                return losses["loss_all"], losses

            (_, losses), grads = compiled(jax.value_and_grad(loss_fn, has_aux=True),
                                          variables["params"], variables["batch_stats"], jb,
                                          excess=excess)
            return {k: float(v) for k, v in losses.items()}, flat(grads)

        model = load_jax_variables(DCLNet(interp_mode=args.mode, device="cpu",
                                          dtype=torch.bfloat16, **kw), variables)
        model.train()
        tb = batch_to_torch(batch, "cpu")
        losses = dcl_losses(model(tb), tb)
        losses["loss_all"].backward()
        port = ({k: float(v.detach()) for k, v in losses.items()},
                flat(to_jax_gradients(model)["params"]))
        j16, j16x, j32 = jax_step(jnp.bfloat16), jax_step(jnp.bfloat16, True), jax_step(None)
        print(f"batch {b} ({args.mode}): gradient rel L2 port bf16 vs JAX bf16 "
              f"{rel(port[1], j16[1]):.3g}; JAX bf16 vs JAX f32 {rel(j16[1], j32[1]):.3g}; "
              f"JAX bf16 excess precision on vs off {rel(j16x[1], j16[1]):.3g}; loss_all port "
              f"{port[0]['loss_all']:.6f}, JAX bf16 {j16[0]['loss_all']:.6f}, JAX f32 "
              f"{j32[0]['loss_all']:.6f}", flush=True)
        if i:
            continue
        # the observed branch's train-mode forward, block by block
        jm = JaxDCLNet(n_inp=n, n_tmp=n, dtype=jnp.bfloat16, interp_mode=args.mode,
                       voxelize_impl="matmul", **kw)
        obs, mut = compiled(lambda v, bb: jm.apply(
            v, bb, True, method=jm.encode_observed, mutable=["batch_stats", "intermediates"],
            capture_intermediates=True), variables, jb)
        inter = flatten_dict(mut["intermediates"])
        model = load_jax_variables(DCLNet(interp_mode=args.mode, device="cpu",
                                          dtype=torch.bfloat16, **kw), variables)
        model.train()
        got = {}
        for name, mod in model.backbone_inp.named_children():
            mod.register_forward_hook(
                lambda mod, inp, out, name=name: got.__setitem__(name, out[0]))
        with torch.no_grad():
            tobs = model.encode_observed(tb)
        parts = [f"{name} {rel(got[name].double().numpy(), f32(inter[('backbone_inp', name, '__call__')][0][0])):.3g}"
                 for name in (f"conv{k}" for k in range(8))]
        parts += [f"{h} {rel(tobs[h].double().numpy(), f32(obs[h])):.3g}"
                  for h in ("p1", "m1", "p2", "m2")]
        print(f"batch {b}: train-mode forward, port bf16 vs JAX bf16 (excess precision off), "
              f"rel L2 by block: {', '.join(parts)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
