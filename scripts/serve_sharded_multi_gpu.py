"""The data-parallel serving artifact over NCCL, one rank a GPU.

Exports the stage-1 serving artifact of configs/config_YCBV_bs32.yaml's
model (seed 0; YCB-V-shaped synthetic data of data/synthetic.py, 16
classes) for a global batch of 32 on cuda:0, in f32 and in bf16, once as a
one-process artifact and once for a world of N ranks. It then starts N
ranks, rank r on cuda:r with NCCL. Each rank loads the N-rank artifacts
with its group: serving.load_serve moves each program to cuda:r, and the
outputs are all-gathered over NCCL as they are (f32, bf16 and bool). The
checks, on every rank:
- the program's weights and the outputs lie on cuda:r;
- the rank launched the kernels: K1, and K2 and K3 four times each, in the
  variant of the artifact's type;
- the outputs equal the one-process artifact's on cuda:0: f32 within 1e-5,
  bf16 within 1 degree and 0.5 mm, and `overflow` exactly.

Run it on a machine with at least two GPUs, from the root of a checkout:

    python3 scripts/serve_sharded_multi_gpu.py [--worlds 2 4]

It prints the card's name and power limit, each rank's errors, launches and
milliseconds for one global batch, and exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import importlib
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH = 32
N_CLASSES = 16
F32_ATOL = 1e-5  # as tests/test_serving.py:171 holds the JAX sharded artifact
BF16_DEG, BF16_MM = 1.0, 0.5  # the bf16 pose bound of the port's tests
COUNTERS = (("voxelize", "cuda_voxelize"), ("compact", "cuda_compact"),
            ("interp", "cuda_interp"))
TIMEOUT = 600.0


def counts():
    out = {}
    for name, module in COUNTERS:
        m = importlib.import_module(f"dcl_net_tpu_torch.ops.{module}")
        out[name] = m.launches
        out[name + "_bf16"] = m.launches_bf16
    return out


def reset_counts():
    for _, module in COUNTERS:
        m = importlib.import_module(f"dcl_net_tpu_torch.ops.{module}")
        m.launches = m.launches_bf16 = 0


def rot_deg(a, b) -> float:
    import torch

    r = a.double().transpose(-1, -2) @ b.double()
    cos = ((r.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1)
    return math.degrees(float(torch.acos(cos).max()))


def errors(got, want, dtype: str) -> dict:
    """The largest difference of each output, and whether the check holds."""
    import torch

    err = {k: float((got[k].double().cpu() - want[k].double().cpu()).abs().max())
           for k in want if k != "overflow"}
    err["overflow_equal"] = bool(torch.equal(got["overflow"].cpu(), want["overflow"].cpu()))
    if dtype == "f32":
        ok = all(v <= F32_ATOL for k, v in err.items() if k != "overflow_equal")
    else:
        err["rot_deg"] = rot_deg(got["rot_pred"].cpu(), want["rot_pred"].cpu())
        err["trans_mm"] = 1e3 * float((got["trans_pred"].double().cpu()
                                       - want["trans_pred"].double().cpu()).abs().max())
        ok = err["rot_deg"] <= BF16_DEG and err["trans_mm"] <= BF16_MM
    return {"errors": err, "ok": ok and err["overflow_equal"]}


def rank_main(rank: int, world: int, init: str, tmp: str) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch import serving, strict_f32
    from dcl_net_tpu_torch.parallel.mesh import destroy, init_distributed

    strict_f32()
    dev = torch.device("cuda", rank)
    group = init_distributed(init, world, rank, device=dev)
    try:
        data = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
        req = [x.to(dev) for x in data["request"]]
        res = {}
        for dtype in ("f32", "bf16"):
            served = serving.load_serve(Path(tmp) / f"{dtype}_w{world}.pt2", group=group)
            state = list(served.module.parameters()) + list(served.module.buffers())
            with torch.inference_mode():
                served(*req)  # warm-up
                torch.cuda.synchronize(dev)
                reset_counts()
                t0 = time.perf_counter()
                out = served(*req)
                torch.cuda.synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
            res[dtype] = {
                "on_device": all(t.device == dev for t in state)
                and all(v.device == dev for v in out.values()),
                "launches": counts(), "ms": ms,
                **errors(out, data["want"][dtype], dtype)}
        torch.save(res, Path(tmp) / f"rank{rank}.pt")
    finally:
        destroy(group)


def run_world(world: int, tmp: str) -> list:
    import torch

    init = "file://" + str(Path(tmp) / f"rendezvous_{world}")
    ctx = torch.multiprocessing.start_processes(
        rank_main, args=(world, init, tmp), nprocs=world, join=False,
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
    return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", type=int, nargs="+", default=None,
                    help="the world sizes to serve (default: every GPU of the machine)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("serve_sharded_multi_gpu: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch import serving, strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.ops import cuda_build

    n_gpus = torch.cuda.device_count()
    worlds = args.worlds or [n_gpus]
    if min(worlds) < 2 or max(worlds) > n_gpus:
        print(f"serve_sharded_multi_gpu: worlds {worlds} need 2 to {n_gpus} GPUs",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60)
    cards = smi.stdout.strip().splitlines()
    card = cards[0] if cards else "nvidia-smi: n/a"
    print(f"{n_gpus} GPUs: " + "; ".join(cards), flush=True)
    strict_f32()
    t0 = time.perf_counter()
    cuda_build.build()
    cuda_build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs32.yaml"))
    mcfg = cfg.model
    grid_shape = tuple(int(d) for d in mcfg.voxel_num_limit)
    n_points = int(mcfg.n_inp)
    ds = SyntheticPoseDataset(n_objects=N_CLASSES, n_points=n_points,
                              unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
                              voxel_num_limit=grid_shape, seed=0)
    batch = batch_to_torch(make_batch([ds[i] for i in range(BATCH)]).to_dict(),
                           torch.device("cuda", 0))
    req = [batch["inp"]["feats"], batch["inp"]["voxel_idx"],
           batch["labels"]["obj_idx"].to(torch.int32)]
    bank = ds.template_bank()

    ok = True
    with tempfile.TemporaryDirectory(prefix="dclx_sharded_") as tmp:
        want = {}
        for dtype, tdtype in (("f32", None), ("bf16", torch.bfloat16)):
            model = DCLNet.from_config(mcfg, seed=0, dtype=tdtype)
            with torch.inference_mode():
                want[dtype] = {k: v.cpu() for k, v in serving.load_serve(
                    serving.export_serve(model, bank, BATCH, n_points))(*req).items()}
            for world in worlds:
                t0 = time.perf_counter()
                data = serving.export_serve(model, bank, BATCH, n_points, world=world)
                (Path(tmp) / f"{dtype}_w{world}.pt2").write_bytes(data)
                print(f"{dtype} artifact for {world} ranks exported on cuda:0 in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            del model
        torch.save({"request": [x.cpu() for x in req], "want": want},
                   Path(tmp) / "inputs.pt")
        for world in worlds:
            t0 = time.perf_counter()
            ranks = run_world(world, tmp)
            print(f"world {world} (NCCL, one rank a GPU) ended in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            per = BATCH // world
            for r, res in enumerate(ranks):
                for dtype, got in res.items():
                    sfx = "" if dtype == "f32" else "_bf16"
                    expect = {"voxelize" + sfx: 1, "compact" + sfx: 4, "interp" + sfx: 4}
                    launched = {k: v for k, v in got["launches"].items() if v}
                    good = got["ok"] and got["on_device"] and launched == expect
                    ok &= good
                    print(f"world {world} rank {r} on cuda:{r} ({card}), {dtype}: "
                          f"{'ok' if good else 'FAILED'}; weights and outputs on cuda:{r} "
                          f"{got['on_device']}; errors against the one-process artifact "
                          f"{got['errors']}; launches {launched}; {got['ms']:.2f} ms for "
                          f"the global batch of {BATCH} ({per} rows here, then the "
                          f"all-gather)", flush=True)
    print("sharded serving over NCCL: " + ("passed" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
