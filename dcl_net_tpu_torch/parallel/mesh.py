"""Data parallelism over torch.distributed: one process per device.

Counterpart of dcl_net_tpu/parallel/mesh.py. The JAX package shards the
global batch over a 1-D `data` mesh and GSPMD computes the single-device
math: a mean over the sharded batch axis is a global mean. Here each rank
is a process with its own device (NCCL on the card, gloo on the CPU) that
holds the contiguous block [r*B/W, (r+1)*B/W) of the global batch of B
rows (data/loader.py's process striding), and the collectives are explicit:

- the BatchNorms' statistics over a sharded batch (ops/sparse_conv.py::
  masked_moments, models/blocks.py) are all-reduced, in the forward and in
  the backward, so they are the global batch's;
- each rank's loss is its share of the global loss: the loss weights divide
  by the global count of valid rows (models/dcl_net.py::dcl_losses,
  models/refiner.py::refiner_losses), so the global loss is the all-reduced
  SUM of the ranks' losses, and the global gradient the all-reduced SUM of
  the ranks' gradients (train/solver.py::apply_gradients, one all-reduce
  of the flat gradient);
- the evaluators gather each rank's ragged scores (eval/evaluator.py).

Which batch is sharded is said by a context: the train steps run their
forward, loss and backward under sharded(group), and batch_group() is what
the BatchNorms and the losses read. A replicated input (the template bank,
which every rank encodes whole) runs under replicated() and takes no
collective: every rank computes what one process computes.

With no group, or a world of 1, every helper is the identity and no
collective is issued: the single-process path is the code without this
module.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from dcl_net_tpu_torch import resolve_device


@dataclass(frozen=True)
class Group:
    """The data-parallel group (torch.distributed's default group) as one
    rank sees it: its rank, the world size, its device and the backend."""

    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def active(group: Optional[Group]) -> bool:
    """Whether `group` takes collectives: a group of more than one rank."""
    return group is not None and group.world > 1


def init_method(coordinator: str) -> str:
    """A torch.distributed init method: tcp://, file:// and env:// as
    given, host:port as tcp://host:port."""
    if coordinator.startswith(("tcp://", "file://", "env://")):
        return coordinator
    return f"tcp://{coordinator}"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device=None, backend: Optional[str] = None,
                     timeout: float = 300.0) -> Group:
    """Join a world of num_processes ranks as rank process_id through the
    rendezvous `coordinator` (tcp://host:port, host:port, file://path or
    env://) and return this rank's Group. The backend is NCCL for a CUDA
    device (made the current device first) and gloo for the CPU, unless
    `backend` names one."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method(coordinator),
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timedelta(seconds=timeout), **kw)
    return Group(dist.get_rank(), dist.get_world_size(), device, backend)


def destroy(group: Optional[Group]) -> None:
    """Leave the default process group, if this process joined one."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the batch being run: sharded over a group, or replicated
# ---------------------------------------------------------------------------
_batch_group: Optional[Group] = None


def batch_group() -> Optional[Group]:
    """The group over which the batch now being run is sharded (set by
    sharded()), or None: no collective is taken."""
    return _batch_group


@contextlib.contextmanager
def sharded(group: Optional[Group]) -> Iterator[None]:
    """Run the enclosed forward (and its backward) as a block of a batch
    sharded over `group`: the BatchNorms and losses inside read it through
    batch_group(). A group of one rank, or None, is no group."""
    global _batch_group
    previous = _batch_group
    _batch_group = group if active(group) else None
    try:
        yield
    finally:
        _batch_group = previous


def replicated() -> contextlib.AbstractContextManager:
    """Run the enclosed forward on an input every rank holds whole (the
    template bank): no collective."""
    return sharded(None)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def all_reduce_sum(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """x summed over the group's ranks, as a new tensor without a gradient;
    x itself without a group."""
    if not active(group):
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out)
    return out


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its backward is the sum over ranks of the
    cotangent (the transpose of a sum that every rank receives)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


def all_reduce_sum_grad(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """x summed over the group's ranks inside an autograd expression: its
    backward all-reduces the cotangent (the sum's transpose), so each rank's
    gradient is its share of the global loss's. x itself without a group."""
    if not active(group):
        return x
    return _AllReduceSum.apply(x)


def _collective_device(group: Group) -> torch.device:
    # gloo gathers host tensors only, NCCL device tensors only
    return group.device if group.backend == "nccl" else torch.device("cpu")


def allgather_host(x: np.ndarray, group: Optional[Group]) -> List[np.ndarray]:
    """Each rank's host array, ragged along axis 0, as a list in rank
    order; [x] without a group. The arrays travel padded to the longest."""
    x = np.ascontiguousarray(x)
    if not active(group):
        return [x]
    dev = _collective_device(group)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.zeros_like(n) for _ in range(group.world)]
    dist.all_gather(counts, n)
    counts = [int(c.item()) for c in counts]
    padded = np.zeros((max(counts),) + x.shape[1:], x.dtype)
    padded[:x.shape[0]] = x
    t = torch.from_numpy(padded).to(dev)
    parts = [torch.empty_like(t) for _ in range(group.world)]
    dist.all_gather(parts, t)
    return [p.cpu().numpy()[:c] for p, c in zip(parts, counts)]


def allgather_rows(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Each rank's block of rows (x's shape on every rank), concatenated in
    rank order, on x's device and in x's type, without a gradient; x
    itself without a group. NCCL gathers the device tensors as they are;
    gloo gathers host copies, bool as uint8 and bf16 as f32, which hold
    them exactly."""
    if not active(group):
        return x
    dev = _collective_device(group)
    wire = x.detach()
    if group.backend != "nccl":
        wire = wire.to(dev, torch.uint8 if x.dtype == torch.bool else
                       torch.float32 if x.dtype == torch.bfloat16 else x.dtype)
    wire = wire.contiguous()
    parts = [torch.empty_like(wire) for _ in range(group.world)]
    dist.all_gather(parts, wire)
    return torch.cat(parts).to(x.device, x.dtype)


def barrier(group: Optional[Group]) -> None:
    if active(group):
        kw = {"device_ids": [group.device.index]} if group.backend == "nccl" else {}
        dist.barrier(**kw)


def shard_batch(batch: Any, group: Optional[Group]) -> Any:
    """This rank's contiguous block [r*B/W, (r+1)*B/W) of every leaf of a
    global batch (numpy arrays or tensors, nested dicts); the batch itself
    without a group. B must divide by the world."""
    if not active(group):
        return batch

    def block(x):
        if isinstance(x, Mapping):
            return {k: block(v) for k, v in x.items()}
        if x is None:
            return None
        b = x.shape[0]
        if b % group.world:
            raise ValueError(f"global batch {b} is not divisible by the world of "
                             f"{group.world} ranks")
        lb = b // group.world
        return x[group.rank * lb:(group.rank + 1) * lb]

    return block(batch)


def replicate(module: torch.nn.Module, group: Optional[Group]) -> torch.nn.Module:
    """Broadcast the module's parameters and buffers from rank 0 and check
    that every rank held rank 0's values already (the ranks build the same
    seeded model, or load the same checkpoint): a rank that differed raises
    ValueError on every rank. The module itself without a group."""
    if not active(group):
        return module
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    dev = _collective_device(group)
    differ = torch.zeros((), dtype=torch.int64, device=dev)
    for tensors in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors]).to(dev)
        mine = flat.clone()
        dist.broadcast(flat, src=0)
        differ += int(not torch.equal(flat, mine))
        with torch.no_grad():
            for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
                t.copy_(part.view_as(t))
    dist.all_reduce(differ)
    if int(differ.item()):
        raise ValueError("the ranks' parameters or buffers differ from rank 0's: "
                         "every rank must build the same seeded model or load the "
                         "same checkpoint")
    return module


def make_parallel_train_step(model: torch.nn.Module, opt, loss_fn,
                             group: Optional[Group], **kw):
    """The stage-1 train step over `group` (train/solver.py::
    make_train_step with group=): the model replicated from rank 0 first,
    then each call takes this rank's block of the global batch, and every
    rank ends the step with the same parameters, optimizer state and
    global metrics. kw: make_train_step's template_bank and on_stage."""
    from dcl_net_tpu_torch.train.solver import make_train_step

    replicate(model, group)
    return make_train_step(model, opt, loss_fn, group=group, **kw)


# ---------------------------------------------------------------------------
# the launch environment (torchrun's variables, or the CLIs' local ranks)
# ---------------------------------------------------------------------------
ENV_INIT = "DCLX_INIT_METHOD"  # the rendezvous of ranks a CLI starts itself


def env_rank() -> Optional[Dict[str, Any]]:
    """The rank of this process from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, with MASTER_ADDR / MASTER_PORT: init env://) or
    from a CLI's own local ranks (DCLX_INIT_METHOD names the rendezvous),
    or None outside such a launch."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    return {"rank": int(env["RANK"]), "world": int(env["WORLD_SIZE"]),
            "local_rank": int(env.get("LOCAL_RANK", env["RANK"])),
            "init": env.get(ENV_INIT, "env://")}
