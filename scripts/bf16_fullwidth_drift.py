#!/usr/bin/env python3
"""The bf16-vs-f32 pose drift of the JAX package and of the port at full
width, on the CPU, on the same weights and inputs (no card needed).

Usage, from the root of the repository:
  python3 scripts/bf16_fullwidth_drift.py [--batch 16] [--chunk 4] [--mode pallas]
      [--weights <dir>]

The model is configs/config_YCBV_bs32.yaml's at full width (64^3 grid at
6 mm, 1024 + 1024 points, capacities (2048, 1024, 512, 64)) with the port's
seeded weights (DCLNet.from_config(seed=0), the weights of chip_smoke.py's
eval phases), or with --weights those of a stage-1 checkpoint of the port
(an epoch_<n> directory, e.g. one that scripts/torch_synthetic_convergence.py
--save writes) or of a reference .pth, carried into the JAX model by
weights.py. The inputs are
rows 0 .. batch-1 of SyntheticPoseDataset(n_objects=16, seed=0) at that
width, chip_smoke.py's model cell. Four eval-mode forwards score every
row: the port in f32 and in bf16 (model.compute_dtype: bfloat16, the
two-stage path or --mode pallas_fused); JAX in f32 (interp_mode exact,
voxelize_impl scatter: the golden-matched reference) and in bf16
(DCLNet(dtype=bfloat16, voxelize_impl="matmul", interp_mode=--mode), its
Pallas kernels in interpret mode, compiled with XLA's excess precision off
so that XLA rounds where the JAX program does).

In eval mode a row's outputs do not depend on the other rows, so the batch
runs in chunks of --chunk rows to bound the host's memory. Prints per row
the rotation angle (degrees) and translation distance (mm) of bf16 from
f32 in each package, and of the port's bf16 pose from JAX's; then the
max, the 95th percentile and the rows over the JAX bound (1 degree,
0.5 mm; tests/test_model.py).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROT_BOUND_DEG, TRANS_BOUND_MM = 1.0, 0.5


def drift(ra, ta, rb, tb):
    """(angle degrees, distance mm) per row between two poses, in f64; the
    chord form keeps angles below 0.03 degrees that arccos of the trace
    loses."""
    import numpy as np

    ra, rb, ta, tb = (np.asarray(x, np.float64) for x in (ra, rb, ta, tb))
    chord = np.linalg.norm(ra - rb, axis=(1, 2)) / (2.0 * np.sqrt(2.0))
    return (np.degrees(2.0 * np.arcsin(np.clip(chord, 0.0, 1.0))),
            np.linalg.norm(ta - tb, axis=1) * 1000.0)


def summary(name, deg, mm):
    import numpy as np

    return (f"{name}: rotation max {deg.max():.4f} deg, p95 {np.percentile(deg, 95):.4f}, "
            f"rows over {ROT_BOUND_DEG} deg {int((deg > ROT_BOUND_DEG).sum())}; translation "
            f"max {mm.max():.4f} mm, p95 {np.percentile(mm, 95):.4f}, rows over "
            f"{TRANS_BOUND_MM} mm {int((mm > TRANS_BOUND_MM).sum())}")


def load_weights(models, path: str) -> None:
    """Fill each of the port's models from the checkpoint or .pth at path
    (tools/common.py::load_model_weights); bf16 models keep f32 parameters,
    so one checkpoint fills both."""
    from dcl_net_tpu_torch.tools.common import load_model_weights

    for model in models.values():
        load_model_weights(model, path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--chunk", type=int, default=4)
    parser.add_argument("--mode", default="pallas", choices=("pallas", "pallas_fused"))
    parser.add_argument("--weights", default=None,
                        help="a stage-1 checkpoint directory of the port or a reference "
                        ".pth (default: the seeded weights)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from dcl_net_tpu.models import DCLNet as JaxDCLNet
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.weights import to_jax_variables

    strict_f32()
    torch.set_num_threads(4)
    mcfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs32.yaml")).model
    port = {name: DCLNet.from_config(mcfg, seed=0, device="cpu", interp_mode=args.mode,
                                     dtype=dtype)
            for name, dtype in (("f32", None), ("bf16", torch.bfloat16))}
    if args.weights:
        load_weights(port, args.weights)
    variables = jax.tree.map(np.asarray, to_jax_variables(port["f32"]))
    width = dict(n_inp=int(mcfg.n_inp), n_tmp=int(mcfg.n_tmp),
                 unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
                 voxel_num_limit=tuple(int(d) for d in mcfg.voxel_num_limit))
    jax_models = {
        "f32": JaxDCLNet(interp_mode="exact", voxelize_impl="scatter", **width),
        "bf16": JaxDCLNet(dtype=jnp.bfloat16, interp_mode=args.mode,
                          voxelize_impl="matmul", **width),
    }
    jax_fns = {}
    ds = SyntheticPoseDataset(n_objects=16, n_points=int(mcfg.n_inp),
                              unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
                              voxel_num_limit=width["voxel_num_limit"], seed=0)

    poses = {k: ([], []) for k in ("port_f32", "port_bf16", "jax_f32", "jax_bf16")}
    for lo in range(0, args.batch, args.chunk):
        t0 = time.perf_counter()
        batch = make_batch([ds[i] for i in range(lo, min(lo + args.chunk, args.batch))]).to_dict()
        tb = batch_to_torch(batch, "cpu")
        jb = jax.tree.map(jnp.asarray, batch)
        for name, model in port.items():
            with torch.inference_mode():
                out = model(tb)
            poses[f"port_{name}"][0].append(out["rot_pred"].double().numpy())
            poses[f"port_{name}"][1].append(out["trans_pred"].double().numpy())
        for name, jm in jax_models.items():
            if name not in jax_fns:
                jax_fns[name] = jax.jit(
                    lambda v, b, jm=jm: jm.apply(v, b, train=False)).lower(
                    variables, jb).compile(
                    compiler_options={"xla_allow_excess_precision": False})
            out = jax_fns[name](variables, jb)
            poses[f"jax_{name}"][0].append(np.asarray(out["rot_pred"].astype(jnp.float32)))
            poses[f"jax_{name}"][1].append(np.asarray(out["trans_pred"].astype(jnp.float32)))
        print(f"rows {lo}..{lo + len(batch['valid']) - 1}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    poses = {k: (np.concatenate(r), np.concatenate(t)) for k, (r, t) in poses.items()}

    pairs = {
        "port bf16 vs port f32": ("port_bf16", "port_f32"),
        "JAX bf16 vs JAX f32": ("jax_bf16", "jax_f32"),
        "port bf16 vs JAX bf16": ("port_bf16", "jax_bf16"),
        "port f32 vs JAX f32": ("port_f32", "jax_f32"),
    }
    res = {name: drift(*poses[a], *poses[b]) for name, (a, b) in pairs.items()}
    print(f"per row, degrees / mm ({args.batch} rows, mode {args.mode}):")
    print("row  " + "  ".join(f"{name:>26s}" for name in pairs))
    for i in range(args.batch):
        print(f"{i:3d}  " + "  ".join(f"{res[n][0][i]:12.4f} {res[n][1][i]:12.4f} "
                                      for n in pairs))
    for name in pairs:
        print(summary(name, *res[name]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
