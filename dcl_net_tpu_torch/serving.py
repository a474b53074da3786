"""Serving artifacts via torch.export (.pt2 files).

Counterpart of dcl_net_tpu/serving.py. The trained eval forward is packaged
as one self-contained artifact:

- the weights AND the per-class template cache are carried in it: the
  template branch depends only on the CAD cloud, so it is encoded once at
  export time (as Evaluator's template cache is) and kept as buffers of the
  exported module;
- the serving input is ``(feats [B,N,7] f32, voxel_idx [B,N,3] int32,
  obj_idx [B] int32)``, the per-instance tensors the test datasets emit;
- the output is ``{"rot_pred" [B,3,3], "trans_pred" [B,3], "conf" [B,N+M],
  "overflow" [B] bool}``, with ``rot_stage1`` and ``trans_stage1`` besides
  in a stage-2 artifact; a bf16 model's trans_pred and conf are bf16;
- :func:`load_serve` loads one and returns a module to call.

Data parallelism (the JAX package's mesh-sharded artifact, ``mesh=``): with
``world=N`` the export functions write an artifact of the per-rank batch
B / N that records N (weights and template cache replicated in it).
``load_serve(path, group=...)`` over a torch.distributed group of N ranks
(parallel/mesh.py) moves the program to the rank's device, wherever it
was exported, and returns a module that takes the GLOBAL batch on every
rank, runs this rank's contiguous block of it (mesh.shard_batch's split)
and returns the whole batch's outputs, all-gathered over the group in
rank order (mesh.allgather_rows), as the JAX artifact returns its global
array. A group of another size, or none for N > 1, raises.

Where it differs from the JAX artifacts:

- the serving site needs torch and the port's op library: the kernels are
  reached through the custom ops of ops/library.py, whose CUDA library is
  built from dcl_net_tpu_torch/csrc/ at first use. load_serve imports them;
  no config, checkpoint or model code is read;
- the batch-polymorphic artifact keeps the kernels: the ops' fake
  implementations take a symbolic batch. Its batch is bounded by
  SparseBackbone.unchunked_batch (116 at a 64^3 grid), past which the pools
  would branch on it; BundleServer chunks larger requests;
- JAX's ``platforms`` is here the device the artifact was exported on, where
  torch.export.load puts its weights back; load_serve without a group
  serves there, with a group on the group's device.

An exported graph does not carry torch's TF32 setting, so load_serve and
BundleServer turn TF32 off themselves (dcl_net_tpu_torch.strict_f32): cuDNN
would otherwise run the f32 convolutions in TF32, about 1e-3 from f32.
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from dcl_net_tpu_torch import strict_f32
from dcl_net_tpu_torch.data.schema import batch_to_torch
from dcl_net_tpu_torch.models.backbone import _dense_backbone
from dcl_net_tpu_torch.models.refiner import refine_pose
from dcl_net_tpu_torch.ops import library  # noqa: F401  (registers the dclx ops)
from dcl_net_tpu_torch.parallel.mesh import allgather_rows, shard_batch
from dcl_net_tpu_torch.telemetry import span

BUNDLE_MANIFEST = "manifest.json"
# the record of an artifact's world size, stored beside its program
ARTIFACT_META = "dclx_serving.json"


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def encode_template_cache(model, bank: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Encode the per-class CAD template bank once, in eval mode and the
    model's compute type, as Evaluator does.

    bank: {"feats": [C, M, 7], "voxel_idx": [C, M, 3]} as the datasets'
    ``template_bank()`` gives it. Returns the template branch's outputs
    [C, ...] on the model's device."""
    strict_f32()
    inputs = batch_to_torch({"tmp": dict(bank)}, _device(model))
    model.eval()
    with torch.no_grad():
        return model.encode_template(inputs)


class ServeStage1(nn.Module):
    """(feats, voxel_idx, obj_idx) -> poses, with the model and the template
    cache (buffers ``tmp_<key>``, so that an export carries them)."""

    def __init__(self, model, tmp_cache: Dict[str, torch.Tensor]):
        super().__init__()
        self.model = model.eval()
        self.cache_keys = tuple(sorted(tmp_cache))
        for key in self.cache_keys:
            self.register_buffer(f"tmp_{key}", tmp_cache[key])

    def stage1(self, feats, voxel_idx, obj_idx) -> Dict[str, torch.Tensor]:
        # the dense backbone, called directly as exported: an artifact needs
        # static shapes (models/backbone.py::SparseBackbone)
        with _dense_backbone():
            obs = self.model.encode_observed(
                {"inp": {"feats": feats, "voxel_idx": voxel_idx}})
        cls = obj_idx.long()
        tmp = {key: getattr(self, f"tmp_{key}")[cls] for key in self.cache_keys}
        return self.model.fuse(obs, tmp)

    def forward(self, feats, voxel_idx, obj_idx) -> Dict[str, torch.Tensor]:
        out = self.stage1(feats, voxel_idx, obj_idx)
        return {
            "rot_pred": out["rot_pred"],
            "trans_pred": out["trans_pred"],
            "conf": out["conf"],
            # [B] bool: the sample's occupied voxels exceeded a capacity and
            # were partly dropped, so the pose may be degraded
            # (models/backbone.py); the serving site should surface or requeue
            # these rather than trust them silently
            "overflow": out["overflow"],
        }


class ServeStage2(ServeStage1):
    """Stage 1, then `iterations` refinement steps (Stage2Evaluator's
    pipeline as one graph). The refined pose is the output's; the stage-1
    pose is kept beside it."""

    def __init__(self, model, refiner, tmp_cache: Dict[str, torch.Tensor],
                 iterations: int):
        super().__init__(model, tmp_cache)
        self.refiner = refiner.eval()
        self.iterations = int(iterations)

    def forward(self, feats, voxel_idx, obj_idx) -> Dict[str, torch.Tensor]:
        out = self.stage1(feats, voxel_idx, obj_idx)
        rot, trans = refine_pose(self.refiner, out["points_inp"], out["F_Xo_p"], out["conf"],
                                 out["rot_pred"], out["trans_pred"], self.iterations)
        return {
            "rot_pred": rot,
            "trans_pred": trans,
            "conf": out["conf"],
            "overflow": out["overflow"],  # see ServeStage1
            "rot_stage1": out["rot_pred"],
            "trans_stage1": out["trans_pred"],
        }


def make_serve_fn(model, tmp_cache: Dict[str, torch.Tensor]) -> ServeStage1:
    """The stage-1 serving module: (feats, voxel_idx, obj_idx) -> poses."""
    return ServeStage1(model, tmp_cache)


def make_serve_fn_stage2(model, refiner, tmp_cache: Dict[str, torch.Tensor],
                         iterations: int) -> ServeStage2:
    """The stage-1 + iterative refiner serving module (the two-stage
    pipeline of tools/test_ycbv_stage2.py as one graph)."""
    return ServeStage2(model, refiner, tmp_cache, iterations)


def poly_max_batch(model) -> int:
    """The largest batch of a batch-polymorphic artifact of `model`: its
    backbone's unchunked batch (models/backbone.py::unchunked_batch)."""
    return model.backbone_inp.unchunked_batch(model.grid_shape)


def check_world(batch_size: Optional[int], world: int) -> int:
    """world as an int, once it is a valid world for batch_size: at least 1,
    dividing a fixed batch, and 1 for a polymorphic one (ValueError)."""
    world = int(world)
    if world < 1:
        raise ValueError(f"world {world}: at least 1")
    if world > 1 and batch_size is None:
        raise ValueError("polymorphic batch cannot be combined with a sharded "
                         f"artifact (world {world})")
    if world > 1 and int(batch_size) % world:
        raise ValueError(f"batch {batch_size} not divisible by the world of {world} ranks")
    return world


def _export(serve: ServeStage1, batch_size: Optional[int], n_points: int,
            world: int = 1) -> bytes:
    """torch.export the serving module, for n_points observed points a row,
    on its model's device; the .pt2 bytes.

    ``batch_size=None`` exports a BATCH-POLYMORPHIC artifact (a symbolic
    batch, torch.export.Dim "B" in [1, poly_max_batch]): one artifact serves
    any batch up to that bound, through the same kernels. ``world=N > 1``
    exports the per-rank program of a global batch of batch_size rows
    sharded over N ranks: batch_size / N rows; batch_size must divide by N,
    and a polymorphic batch cannot be sharded."""
    world = check_world(batch_size, world)
    model = serve.model
    dev = _device(model)
    b = 2 if batch_size is None else int(batch_size) // world
    args = (torch.zeros((b, n_points, 7), dtype=torch.float32, device=dev),
            torch.zeros((b, n_points, 3), dtype=torch.int32, device=dev),
            torch.zeros((b,), dtype=torch.int32, device=dev))
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("B", min=1, max=poly_max_batch(model))
        dynamic = ({0: batch}, {0: batch}, {0: batch})
    program = torch.export.export(serve, args, dynamic_shapes=dynamic)
    # torch.export.save would store the zero example batch too (21 MB at 512)
    program.example_inputs = None
    buf = io.BytesIO()
    meta = {"world": world, "batch": None if batch_size is None else int(batch_size)}
    torch.export.save(program, buf, extra_files={ARTIFACT_META: json.dumps(meta)})
    return buf.getvalue()


def export_serve(model, bank: Dict[str, object], batch_size: Optional[int],
                 n_points: int, world: int = 1) -> bytes:
    """Export the stage-1 serving module, for n_points observed points a row
    (the config's model.n_inp), to .pt2 bytes.

    ``batch_size=None`` -> batch-polymorphic artifact; ``world=N`` -> the
    data-parallel artifact of N ranks (see :func:`_export`)."""
    serve = make_serve_fn(model, encode_template_cache(model, bank))
    return _export(serve, batch_size, n_points, world)


def export_serve_stage2(model, refiner, bank: Dict[str, object],
                        batch_size: Optional[int], iterations: int = 2,
                        world: int = 1) -> bytes:
    """Export the refined (stage-1 + stage-2) serving module, for the
    refiner's n_inp observed points a row.

    ``batch_size=None`` -> batch-polymorphic artifact; ``world=N`` -> the
    data-parallel artifact of N ranks (see :func:`_export`)."""
    cache = encode_template_cache(model, bank)
    serve = make_serve_fn_stage2(model, refiner, cache, iterations)
    return _export(serve, batch_size, refiner.n_inp, world)


# ---------------------------------------------------------------------------
# Artifact bundles: fixed-batch artifacts + a poly catch-all
# ---------------------------------------------------------------------------
def export_bundle(model, bank: Dict[str, object], n_points: int,
                  batch_sizes: Sequence[int] = (1, 16, 64, 512),
                  include_poly: bool = True) -> Dict[str, bytes]:
    """Export a SET of stage-1 serving artifacts for n_points observed
    points a row: one fixed-batch artifact per size in `batch_sizes` plus
    an optional batch-polymorphic catch-all, all of one template cache.

    Unlike the JAX package's, the poly artifact runs the same kernels as the
    fixed ones, so no second, portable model is needed.

    Returns {name: .pt2 bytes}; see save_bundle / BundleServer."""
    serve = make_serve_fn(model, encode_template_cache(model, bank))
    out: Dict[str, bytes] = {}
    for b in batch_sizes:
        out[f"b{int(b):05d}"] = _export(serve, int(b), n_points)
    if include_poly:
        out["poly"] = _export(serve, None, n_points)
    return out


def save_bundle(dirpath: str, artifacts: Dict[str, bytes], model) -> str:
    """Write a bundle directory: one .pt2 per artifact + manifest.json
    mapping names to files and batch sizes (the poly artifact's bound as
    ``max_batch``), with the device and compute type of `model`, the model
    they were exported from. Returns the manifest path."""
    os.makedirs(dirpath, exist_ok=True)
    manifest = {"device": str(_device(model)),
                "dtype": "bfloat16" if model.dtype == torch.bfloat16 else "float32",
                "artifacts": {}}
    for name, data in artifacts.items():
        fname = f"{name}.pt2"
        with open(os.path.join(dirpath, fname), "wb") as f:
            f.write(data)
        entry = {"file": fname, "batch": None if name == "poly" else int(name[1:]),
                 "bytes": len(data)}
        if name == "poly":
            entry["max_batch"] = poly_max_batch(model)
        manifest["artifacts"][name] = entry
    mpath = os.path.join(dirpath, BUNDLE_MANIFEST)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
    return mpath


class BundleServer:
    """Serve ANY request size from an exported bundle.

    Dispatch policy per request of n instances:
    - pick the smallest fixed-batch artifact with B >= n and zero-pad the
      tail (per-instance outputs are batch-independent in eval mode: BN uses
      running statistics, attention and confidence are within-sample, so
      padding rows cannot perturb real rows);
    - when n exceeds the largest fixed B, chunk by that B and go on with the
      remainder;
    - with no fixed artifact at all, serve with the poly artifact, in chunks
      of its max_batch.

    Inputs (numpy arrays or tensors) are moved to the bundle's device; the
    outputs are the artifacts' tensors, on that device. Artifacts load
    lazily on first use. TF32 is turned off (strict_f32).

    Under a profiler a call is the host span serve.request, which holds
    serve.h2d (the inputs to the device), one serve.run.b<B> (B zero-padded
    to five digits) or serve.run.poly a chunk (the padding and the call of
    the artifact it names: a fixed artifact runs B rows, the poly artifact
    the chunk's) and serve.gather (the chunks' rows cut and joined)."""

    def __init__(self, dirpath: str):
        strict_f32()
        self.dirpath = dirpath
        with open(os.path.join(dirpath, BUNDLE_MANIFEST)) as f:
            manifest = json.load(f)
        self.device = torch.device(manifest["device"])
        self.dtype = manifest["dtype"]
        self._entries = manifest["artifacts"]
        self.fixed_sizes = sorted(
            e["batch"] for e in self._entries.values() if e["batch"])
        poly = self._entries.get("poly")
        self.has_poly = poly is not None
        self.poly_max = poly["max_batch"] if poly else None
        self._fns: Dict[str, nn.Module] = {}

    def _fn(self, name: str) -> nn.Module:
        if name not in self._fns:
            path = os.path.join(self.dirpath, self._entries[name]["file"])
            self._fns[name] = load_serve(path)
        return self._fns[name]

    def __call__(self, feats, voxel_idx, obj_idx) -> Dict[str, torch.Tensor]:
        with span("serve.request"):
            with span("serve.h2d"):
                inputs = batch_to_torch({"feats": feats, "voxel_idx": voxel_idx,
                                         "obj_idx": obj_idx}, self.device)
            feats, voxel_idx, obj_idx = inputs["feats"], inputs["voxel_idx"], inputs["obj_idx"]
            n = int(obj_idx.shape[0])
            if n == 0:
                raise ValueError("BundleServer: empty request (0 instances); batch at least "
                                 "one instance per call")
            if not self.fixed_sizes and not self.has_poly:
                raise RuntimeError("empty bundle")
            chunks = []
            i = 0
            with torch.inference_mode():
                while i < n:
                    rem = n - i
                    if not self.fixed_sizes:
                        name, b = "poly", min(rem, self.poly_max)
                    else:
                        fit = [s for s in self.fixed_sizes if s >= rem]
                        b = fit[0] if fit else self.fixed_sizes[-1]
                        name = f"b{b:05d}"
                    take = min(rem, b)

                    def pad(x):
                        if take == b:
                            return x[i:i + take]
                        padded = x.new_zeros((b,) + tuple(x.shape[1:]))
                        padded[:take] = x[i:i + take]
                        return padded

                    with span(f"serve.run.{name}"):
                        res = self._fn(name)(pad(feats), pad(voxel_idx), pad(obj_idx))
                    chunks.append((res, take))
                    i += take
            with span("serve.gather"):
                if len(chunks) == 1:
                    res, take = chunks[0]
                    return {k: v[:take] for k, v in res.items()}
                return {k: torch.cat([res[k][:take] for res, take in chunks])
                        for k in chunks[0][0]}


class ShardedServe(nn.Module):
    """A data-parallel artifact on one rank of its group: the global batch
    in, this rank's block of it (parallel/mesh.py::shard_batch) through the
    per-rank program, and the whole batch's outputs out, all-gathered over
    the group in rank order, on this rank's device (parallel/mesh.py::
    allgather_rows). Every rank must call it with the same global batch, as
    the ranks of a JAX mesh hold one global array. A group of one rank runs
    the whole batch."""

    def __init__(self, module: nn.Module, group):
        super().__init__()
        self.module = module
        self.group = group

    def forward(self, feats, voxel_idx, obj_idx) -> Dict[str, torch.Tensor]:
        block = shard_batch({"feats": feats, "voxel_idx": voxel_idx, "obj_idx": obj_idx},
                            self.group)
        out = self.module(block["feats"], block["voxel_idx"], block["obj_idx"])
        return {k: allgather_rows(v, self.group) for k, v in out.items()}


def _load(path_or_bytes):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(bytes(path_or_bytes))
    extra = {ARTIFACT_META: ""}
    program = torch.export.load(path_or_bytes, extra_files=extra)
    meta = json.loads(extra[ARTIFACT_META]) if extra[ARTIFACT_META] else {"world": 1}
    return program, meta


def _to_device(program, device: torch.device):
    """The exported program with its weights, constants and every device its
    graph names (the export pins the device of each tensor it makes or
    checks) moved to `device`. Raises if a tensor or a device of another
    place is left."""
    program = move_to_device_pass(program, device)
    tensors = list(program.state_dict.values()) + [
        v for v in program.constants.values() if isinstance(v, torch.Tensor)]
    named = [n.kwargs["device"] for m in program.graph_module.modules()
             if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
             if n.kwargs.get("device") is not None]
    left = ({t.device for t in tensors} | {torch.device(d) for d in named}) - {device}
    if left:
        raise ValueError(f"the artifact keeps tensors on {sorted(map(str, left))} "
                         f"after its move to {device}")
    return program


def load_serve(path_or_bytes: Union[str, os.PathLike, bytes, bytearray],
               group=None) -> nn.Module:
    """Load a serving artifact (a path or the .pt2 bytes); returns the module
    (feats, voxel_idx, obj_idx) -> dict, frozen (no gradient is kept).
    Registers the dclx ops (importing this module does) and turns TF32 off
    (strict_f32). Without a group its weights stay on the device it was
    exported on.

    group: this rank's parallel/mesh.py::Group, for an artifact of N ranks
    (export_serve(..., world=N)): the program is moved to the group's
    device, wherever it was exported, and the module is a ShardedServe,
    which takes the global batch. ValueError when the group's size is not
    the artifact's N (no group: a world of 1)."""
    strict_f32()
    program, meta = _load(path_or_bytes)
    world = int(meta["world"])
    have = 1 if group is None else int(group.world)
    if have != world:
        raise ValueError(f"the artifact was exported for a world of {world} ranks; "
                         f"it is loaded on {have}")
    if group is not None:
        device = torch.device(group.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        program = _to_device(program, device)
    module = program.module()
    module.requires_grad_(False)
    return module if group is None else ShardedServe(module, group)
