"""Training solver: optimizer, LR schedules, AutoClip, train step, epoch loop.

Counterpart of dcl_net_tpu/train/solver.py. The optimizer follows the JAX
package's optax chain: AutoClip (percentile clipping over a ring of past
gradient norms), then Adam (b1, b2, eps from cfg.optimizer), then
lr = schedule(count), count being the number of updates already applied.
Its state lives on the device as flat f32 vectors over all parameters, so
a step is a handful of kernels over those vectors and no host sync.

A step whose loss or gradient norm is not finite is skipped on the device
(torch.where on an `ok` flag): parameters, Adam moments and count, the
AutoClip ring and the BN running statistics (which the forward has already
written, so they are snapshotted first) all keep their values.

Data parallelism (parallel/mesh.py): with a group of W ranks, each rank
runs its block of the global batch; its losses are its share of the global
losses (models/dcl_net.py::dcl_losses), so the flat gradient is all-reduced
as a SUM before the norm (one collective of every parameter), the logged
losses and overflow_frac are the global ones, and the finiteness test
reads the global loss and norm, so every rank skips a step together and
the replicas stay equal.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from dcl_net_tpu_torch import autotune_convs, resolve_device, strict_f32
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data.schema import batch_to_torch
from dcl_net_tpu_torch.parallel.mesh import (
    Group, active, all_reduce_sum, replicate, sharded,
)


# ---------------------------------------------------------------------------
# AutoClip
# ---------------------------------------------------------------------------
class AutoClip:
    """Percentile gradient clipping (the reference's AutoClip).

    Keeps the last `history_len` global gradient norms in a ring; the
    current gradient is scaled to the `percentile` of the norms seen so far,
    the current one included, with np.percentile's linear interpolation."""

    def __init__(self, percentile: float = 50.0, history_len: int = 1024):
        self.percentile = float(percentile)
        self.history_len = int(history_len)

    def init(self, device=None) -> Dict[str, torch.Tensor]:
        return {"history": torch.zeros(self.history_len, device=device),
                "count": torch.zeros((), dtype=torch.int64, device=device)}

    def __call__(self, norm: torch.Tensor, state: Mapping[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(scale for the gradient, new state) for the global norm; the ring
        and the scale are f32, as in the JAX package."""
        norm = norm.to(torch.float32)
        h = self.history_len
        slots = torch.arange(h, device=norm.device)
        history = torch.where(slots == state["count"] % h, norm, state["history"])
        count = state["count"] + 1
        n_valid = torch.clamp(count, max=h)
        ordered = torch.sort(torch.where(slots < n_valid, history,
                                         torch.full_like(history, float("inf")))).values
        q = self.percentile / 100.0 * (n_valid.to(torch.float32) - 1.0)
        lo = torch.floor(q).to(torch.int64)
        hi = torch.minimum(lo + 1, n_valid - 1)
        frac = q - lo.to(torch.float32)
        clip = (ordered.gather(0, lo.view(1))[0] * (1 - frac)
                + ordered.gather(0, hi.view(1))[0] * frac)
        scale = torch.where(norm > clip, clip / torch.clamp(norm, min=1e-12),
                            torch.ones_like(norm))
        return scale, {"history": history, "count": count}


# ---------------------------------------------------------------------------
# LR schedules: functions of the update count (an int or an int tensor) that
# return an f32 tensor on the count's device
# ---------------------------------------------------------------------------
def cyclic_lr(base_lr: float, max_lr: float, step_size_up: int,
              step_size_down: Optional[int] = None) -> Callable:
    """torch.optim.lr_scheduler.CyclicLR, triangular mode."""
    step_size_down = step_size_down or step_size_up
    period = step_size_up + step_size_down

    def schedule(step):
        cycle_pos = torch.remainder(torch.as_tensor(step), period)
        up = cycle_pos / step_size_up
        down = 1.0 - (cycle_pos - step_size_up) / step_size_down
        frac = torch.where(cycle_pos <= step_size_up, up, down)
        return base_lr + (max_lr - base_lr) * torch.clamp(frac, 0.0, 1.0)

    return schedule


def step_lr(base_lr: float, step_size_steps: int, gamma: float) -> Callable:
    """torch StepLR's per-epoch decay, expressed in steps."""

    def schedule(step):
        k = torch.floor(torch.as_tensor(step) / step_size_steps)
        return base_lr * torch.pow(gamma, k)

    return schedule


def constant_lr(base_lr: float) -> Callable:
    def schedule(step):
        step = torch.as_tensor(step)
        return torch.full((), base_lr, dtype=torch.float32, device=step.device)

    return schedule


def build_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable:
    """cfg.lr_scheduler_cyc -> CyclicLR per step (YCB-V configs);
    cfg.lr_scheduler.type StepLR -> per-epoch decay (LM); else constant."""
    if "lr_scheduler_cyc" in cfg:
        c = cfg.lr_scheduler_cyc
        return cyclic_lr(float(c.base_lr), float(c.max_lr), int(c.step_size_up),
                         int(c.get("step_size_down", c.step_size_up)))
    sched = cfg.get("lr_scheduler", Config())
    stype = sched.get("type", "constant")
    base_lr = float(cfg.optimizer.lr)
    if stype == "StepLR":
        return step_lr(base_lr, int(sched.step_size) * steps_per_epoch,
                       float(sched.gamma))
    if stype in ("constant", None):
        return constant_lr(base_lr)
    raise NotImplementedError(f"lr_scheduler type {stype}")


def autoclip(percentile: float = 50.0, history_len: int = 1024) -> AutoClip:
    """Percentile gradient clipping (dcl_net_tpu/train/solver.py::autoclip,
    an optax transformation there): the AutoClip the optimizer applies."""
    return AutoClip(percentile, history_len)


# ---------------------------------------------------------------------------
# Optimizer: AutoClip -> Adam -> learning rate
# ---------------------------------------------------------------------------
class Optimizer:
    """optax.chain(autoclip, scale_by_adam, scale_by_learning_rate) over one
    flat f32 gradient vector. The three optax counts always agree, so the
    state keeps one `count`, which AutoClip's ring also uses."""

    def __init__(self, schedule: Callable, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, clip: Optional[AutoClip] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.clip = clip or AutoClip()

    def init(self, numel: int, device=None) -> Dict[str, torch.Tensor]:
        clip = self.clip.init(device)
        return {"clip_history": clip["history"], "count": clip["count"],
                "mu": torch.zeros(numel, device=device),
                "nu": torch.zeros(numel, device=device)}

    def update(self, grad: torch.Tensor, norm: torch.Tensor,
               state: Mapping[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(parameter update, new state) for the flat gradient and its norm."""
        scale, clip = self.clip(norm, {"history": state["clip_history"],
                                       "count": state["count"]})
        g = grad * scale
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = (1 - b2) * (g * g) + b2 * state["nu"]
        count = clip["count"]
        steps = count.to(torch.float32)
        mu_hat = mu / (1 - torch.pow(b1, steps))
        nu_hat = nu / (1 - torch.pow(b2, steps))
        lr = self.schedule(state["count"]).to(grad.device)
        update = -lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return update, {"clip_history": clip["history"], "count": count,
                        "mu": mu, "nu": nu}


def build_optimizer(cfg: Config, steps_per_epoch: int = 1
                    ) -> Tuple[Optimizer, Callable]:
    """Adam from cfg.optimizer (reference configs: lr 1e-3, betas
    [0.5, 0.999], eps 1e-6), AutoClip at cfg.clip_percentile, the LR
    schedule of build_lr_schedule."""
    opt_cfg = cfg.optimizer
    if opt_cfg.get("type", "Adam") != "Adam":
        raise NotImplementedError(opt_cfg.type)
    betas = opt_cfg.get("betas", [0.9, 0.999])
    schedule = build_lr_schedule(cfg, steps_per_epoch)
    opt = Optimizer(schedule, b1=float(betas[0]), b2=float(betas[1]),
                    eps=float(opt_cfg.get("eps", 1e-8)),
                    clip=AutoClip(float(cfg.get("clip_percentile", 50.0))))
    return opt, schedule


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
@dataclass
class TrainState:
    """What a step changes besides the model: the optimizer's device state
    and the number of steps taken (skipped ones included)."""
    opt_state: Dict[str, torch.Tensor]
    step: int = 0


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _assign(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    parts = flat.split([t.numel() for t in tensors])
    with torch.no_grad():
        torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])


def bn_statistics(model: torch.nn.Module) -> List[torch.Tensor]:
    """The BN running statistics a train-mode forward writes."""
    return [b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def apply_gradients(params: List[torch.Tensor], grads, opt: Optimizer,
                    state: TrainState, loss: torch.Tensor,
                    stats: List[torch.Tensor] = (),
                    stats_before: Optional[torch.Tensor] = None,
                    group: Optional[Group] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The optimizer half of a train step, on the device without a host
    sync: the flat gradient (None counts as zero), its global norm,
    AutoClip, Adam, and the parameter update, all skipped where the loss or
    the norm is not finite. Then the parameters, state.opt_state and, when
    given, the BN statistics (put back to stats_before on a skip) hold
    their new values and state.step counts the step.
    group: the ranks' gradients are this rank's shares, all-reduced here
    as a SUM before the norm; `loss` must then be the global loss.
    Returns (grad_norm, skipped_nonfinite) as 0-d tensors."""
    grad = torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                      for g, p in zip(grads, params)])
    if active(group):
        torch.distributed.all_reduce(grad)
    grad_norm = torch.sqrt(torch.sum(grad * grad))
    update, new_opt = opt.update(grad, grad_norm, state.opt_state)
    old = _flat(params)
    ok = torch.isfinite(loss.detach()) & torch.isfinite(grad_norm)
    new = torch.where(ok, old + update, old)
    new_opt = {k: torch.where(ok, v, state.opt_state[k]) for k, v in new_opt.items()}
    if stats:
        _assign(stats, torch.where(ok, _flat(stats), stats_before))
    _assign(params, new)
    state.opt_state = new_opt
    state.step += 1
    return grad_norm, 1.0 - ok.to(torch.float32)


def global_metrics(losses: Mapping[str, torch.Tensor], group: Optional[Group],
                   overflow: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A step's metrics as 0-d tensors: the losses (over a group, the SUM
    of the ranks' shares: the global losses) and, given the per-row
    overflow flags, overflow_frac (the global share of rows over a
    capacity; every rank's block has the same size). One all-reduce."""
    metrics = {k: v.detach() for k, v in losses.items()}
    if overflow is not None:
        metrics["overflow_frac"] = overflow.to(torch.float32).mean()
    if not active(group):
        return metrics
    keys = list(metrics)
    sums = all_reduce_sum(torch.stack([metrics[k].reshape(()).to(torch.float64)
                                       for k in keys]), group)
    out = {k: v.to(metrics[k].dtype) for k, v in zip(keys, sums)}
    if overflow is not None:
        out["overflow_frac"] = out["overflow_frac"] / group.world
    return out


def make_train_step(model: torch.nn.Module, opt: Optimizer, loss_fn: Callable,
                    template_bank: Optional[Mapping[str, torch.Tensor]] = None,
                    on_stage: Optional[Callable[[str], None]] = None,
                    group: Optional[Group] = None) -> Callable:
    """The train step: train-mode forward, loss, gradient, AutoClip, Adam,
    parameter update, all on the model's device without a host sync.

    train_step(state, batch) updates the model's parameters and BN
    statistics and state.opt_state in place and returns the step's metrics
    as 0-d device tensors: the losses, overflow_frac (the share of samples
    whose occupied voxels exceeded a capacity), grad_norm (before the clip)
    and skipped_nonfinite (1 where a non-finite loss or gradient norm left
    everything as it was).

    template_bank: per-class template inputs on the device; the template
    branch is then encoded once per class (model.forward_with_template_bank).

    on_stage: called with "forward", "loss", "backward" and "optimizer" as
    each stage has been queued (scripts/profile_torch_train.py records a
    CUDA event there); None costs nothing.

    group: data parallelism (parallel/mesh.py): the batch is this rank's
    block of the global batch; the forward and backward run under
    sharded(group), the gradient is all-reduced (apply_gradients) and the
    metrics are the global ones. The model's state must be the same on
    every rank (parallel/mesh.py::replicate).

    Turns TF32 off (strict_f32). A bf16 model (model.compute_dtype:
    bfloat16) computes its forward and backward in bf16 as the JAX package
    does; its parameters, their gradients, the optimizer state and the BN
    running statistics stay f32.
    """
    strict_f32()
    params = [p for p in model.parameters() if p.requires_grad]
    stats = bn_statistics(model)
    mark = on_stage or (lambda stage: None)

    def train_step(state: TrainState, batch: Mapping[str, Any]
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        stats_before = _flat(stats)
        with sharded(group):
            if template_bank is not None:
                pred = model.forward_with_template_bank(batch, template_bank)
            else:
                pred = model(batch)
            mark("forward")
            losses = dict(loss_fn(pred, batch))
            mark("loss")
            grads = torch.autograd.grad(losses["loss_all"], params, allow_unused=True)
        mark("backward")
        metrics = global_metrics(losses, group, pred.get("overflow"))
        metrics["grad_norm"], metrics["skipped_nonfinite"] = apply_gradients(
            params, grads, opt, state, metrics["loss_all"], stats, stats_before, group)
        mark("optimizer")
        return metrics

    return train_step


# ---------------------------------------------------------------------------
# Epoch driver
# ---------------------------------------------------------------------------
class Solver:
    """Epoch/step loop with per-step timing and periodic logging: T_data
    (waiting for the loader) and T_step (the sustained wall time of a step)
    per step, averages every cfg.per_write steps, a checkpoint every
    cfg.per_save epochs and every cfg.per_save_steps steps, and the eval
    hook every cfg.per_val epochs.

    With a data-parallel group (parallel/mesh.py) every rank runs this loop
    over its block of each global batch (the loader's process striding):
    the model is replicated from rank 0 at initialize() and restore(), the
    step all-reduces the gradient, the metrics are global, and rank 0 alone
    logs and writes scalars and checkpoints.

    Metrics are fetched one step late (cfg.pipeline_metrics, default on):
    step k+1 is queued on the device before step k's scalars are read, so
    the read does not leave the card idle; off, each step's scalars are
    read at once. cfg.profile_dir (or $DCLX_PROFILE_DIR) traces steps 2-4
    of the first epoch with torch.profiler, CPU and CUDA activities, into a
    Chrome trace in that directory (`profile_trace_path`), as the JAX
    Solver traces them with jax.profiler."""

    def __init__(self, model, loss_fn, cfg: Config, loader, logger=None,
                 checkpoint_dir: Optional[str] = None, writer=None,
                 template_bank=None, device=None,
                 eval_fn: Optional[Callable] = None,
                 step_builder: Optional[Callable] = None,
                 group: Optional[Group] = None):
        """template_bank: numpy {"feats", "voxel_idx"} per class.

        eval_fn(state, epoch) -> dict of scalars, called every cfg.per_val
        epochs, logged and written as "eval" scalars.

        step_builder: a factory opt -> train_step(state, batch) -> metrics
        that replaces the stage-1 step (make_train_step); it is given the
        Solver's optimizer, so the state it updates is the Solver's. The
        stage-2 trainer passes train/stage2.py's step, with the refiner as
        `model` and loss_fn None; over a group it builds its step with
        that group.

        group: the data-parallel group, or None. The loader's batch_size is
        the global batch and must divide by the world (as the JAX Solver's
        mesh requires); the loader yields this rank's block.

        Turns TF32 off (strict_f32) and cuDNN's algorithm autotuning on
        (autotune_convs)."""
        strict_f32()
        autotune_convs()
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.loader = loader
        self.group = group if active(group) else None
        if self.group is not None:
            bs = getattr(loader, "batch_size", None)
            if bs is not None and bs % self.group.world:
                raise ValueError(f"batch size {bs} not divisible by the world of "
                                 f"{self.group.world} ranks")
        self.main = self.group is None or self.group.is_main
        # rank 0 alone logs and writes
        self.logger = logger if self.main else None
        self.writer = writer if self.main else None
        self.checkpoint_dir = checkpoint_dir
        self.eval_fn = eval_fn
        self.opt, self.schedule = build_optimizer(cfg, len(loader))
        if step_builder is not None:
            self.train_step = step_builder(self.opt)
        else:
            bank = None if template_bank is None else batch_to_torch(
                dict(template_bank), self.device)
            self.train_step = make_train_step(model, self.opt, loss_fn,
                                              template_bank=bank, group=self.group)
        self.state: Optional[TrainState] = None
        self.epoch = 0

    def initialize(self, seed: Optional[int] = None) -> TrainState:
        """Fresh optimizer state; with a seed, the weights are drawn anew
        from it first (None keeps the model's weights)."""
        if seed is not None:
            self.model.reset_parameters(seed)
        replicate(self.model, self.group)
        numel = sum(p.numel() for p in self.model.parameters() if p.requires_grad)
        self.state = TrainState(self.opt.init(numel, self.device))
        return self.state

    def solve(self, max_epoch: Optional[int] = None) -> None:
        max_epoch = max_epoch or int(self.cfg.get("max_epoch", 1))
        per_save = int(self.cfg.get("per_save", 1))
        per_val = int(self.cfg.get("per_val", 1))
        while self.epoch < max_epoch:
            self.train_epoch()
            self.epoch += 1
            # per_save / per_val <= 0 disables the checkpoints / the eval hook
            if self.checkpoint_dir and per_save > 0 and self.epoch % per_save == 0:
                self._save()
            if self.eval_fn and per_val > 0 and self.epoch % per_val == 0:
                scalars = self.eval_fn(self.state, self.epoch)
                if scalars:
                    if self.logger:
                        self.logger.info(f"[{self.epoch}] Eval - " + "\t".join(
                            f"{k}: {v:.5f}" for k, v in scalars.items()))
                    if self.writer:
                        self.writer.add_scalars("eval", scalars, self.epoch)

    def _save(self, meta: Optional[Dict[str, Any]] = None) -> None:
        """A checkpoint of the model and state (rank 0 writes it)."""
        from dcl_net_tpu_torch.train.checkpoints import save_checkpoint

        save_checkpoint(self.checkpoint_dir, self.model, self.state, self.epoch,
                        meta=meta, group=self.group)

    def save_due(self, i: int) -> bool:
        """Whether step i of the epoch ends with a mid-epoch checkpoint."""
        per_save_steps = int(self.cfg.get("per_save_steps", 0))
        return bool(self.checkpoint_dir and per_save_steps and i
                    and i % per_save_steps == 0)

    def maybe_save_steps(self, i: int) -> None:
        """Mid-epoch checkpoint every cfg.per_save_steps steps. Its meta
        records the batches of this epoch consumed, so a resumed run replays
        exactly the rest (the shuffle is seeded by seed + epoch)."""
        if self.save_due(i):
            self._save(meta={"consumed_batches": i + 1})

    def restore(self, path: str) -> None:
        """Resume from a checkpoint directory: weights, BN statistics,
        optimizer state, step, epoch and the position inside the epoch.
        Every rank of a group reads the same payload, and the model is
        checked to be the same on every rank."""
        if self.state is None:
            raise RuntimeError("call initialize() before restore()")
        from dcl_net_tpu_torch.train.checkpoints import load_checkpoint

        payload = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(payload["model"])
        replicate(self.model, self.group)
        if set(payload["opt_state"]) != set(self.state.opt_state):
            raise KeyError(f"{path}: optimizer state keys "
                           f"{sorted(payload['opt_state'])}")
        self.state = TrainState({k: v.to(self.device)
                                 for k, v in payload["opt_state"].items()},
                                int(payload["step"]))
        self.epoch = int(payload["epoch"])
        consumed = int(payload["meta"]["consumed_batches"])
        if consumed and hasattr(self.loader, "skip_next"):
            self.loader.skip_next = consumed

    def profile_trace_path(self) -> Optional[str]:
        """The trace file of cfg.profile_dir (else $DCLX_PROFILE_DIR), one a
        rank, or None where neither is set."""
        profile_dir = self.cfg.get("profile_dir") or os.environ.get("DCLX_PROFILE_DIR")
        if not profile_dir:
            return None
        rank = 0 if self.group is None else self.group.rank
        return os.path.join(str(profile_dir), f"trace_epoch0_steps2-4_rank{rank}.json")

    def _start_profile(self):
        """A started torch.profiler.profile of CPU and, on a CUDA device, CUDA
        activity; a profiler that fails to start is reported (the logger and
        a warning) and the epoch runs on without it. Returns it or None."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        try:
            prof.start()
        except Exception as e:  # noqa: BLE001 - reported below
            msg = f"profile_dir: torch.profiler did not start ({type(e).__name__}: {e})"
            if self.logger:
                self.logger.warning(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
            return None
        return prof

    def _stop_profile(self, prof, path: str) -> None:
        """Stop the profiler once the traced steps ran and write its trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the traced steps' kernels end in it
        prof.stop()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        if self.logger:
            self.logger.info(f"profile of steps 2-4: {path}")

    def train_epoch(self) -> Dict[str, float]:
        per_write = int(self.cfg.get("per_write", 10))
        buffer: Dict[str, list] = {}
        pending = None  # (device metrics, T_data, step, loader index)
        pipeline = bool(self.cfg.get("pipeline_metrics", True))
        trace = self.profile_trace_path() if self.epoch == 0 else None
        prof = None

        def consume(pend, t_start, t_excl=0.0):
            pmetrics, pdata, pstep, pi = pend
            keys = list(pmetrics)
            values = torch.stack([pmetrics[k].reshape(()) for k in keys]).cpu()
            info = dict(zip(keys, values.tolist()))  # waits for that step
            if info.get("overflow_frac", 0.0) > 0 and self.logger and \
                    not getattr(self, "_warned_overflow", False):
                self._warned_overflow = True
                self.logger.warning(
                    "capacity overflow: %.1f%% of this step's samples exceed a "
                    "voxel-extraction budget (model.capacities); their "
                    "highest-index voxels were dropped (warned once; "
                    "overflow_frac tracks it per step)" % (100.0 * info["overflow_frac"]))
            info.update({"T_data": pdata, "T_step": time.time() - t_start - t_excl,
                         "lr": float(self.schedule(pstep - 1))})
            for k, v in info.items():
                buffer.setdefault(k, []).append(v)
            if self.logger and pi % per_write == 0:
                avg = {k: float(np.mean(v[-per_write:])) for k, v in buffer.items()}
                self.logger.info(
                    f"[{self.epoch}][{pi}/{len(self.loader)}] Train - " + "\t".join(
                        f"{k}: {v:.5f}" for k, v in avg.items()))
                if self.writer:
                    self.writer.add_scalars("train", avg, pstep)

        if self.state is None:
            self.initialize()
        end = time.time()
        if hasattr(self.loader, "epoch"):
            self.loader.epoch = self.epoch  # the shuffle follows the solver
        offset = getattr(self.loader, "skip_next", 0)  # mid-epoch resume
        for i0, host_batch in enumerate(self.loader):
            i = i0 + offset
            if trace and i == 2:
                prof = self._start_profile()
            if prof is not None and i == 5:
                self._stop_profile(prof, trace)
                prof = None
            t_data = time.time() - end
            batch = batch_to_torch(host_batch, self.device, non_blocking=True)
            metrics = self.train_step(self.state, batch)
            if pipeline and not self.save_due(i):
                if pending is not None:
                    consume(pending, end, t_excl=t_data)
                pending = (metrics, t_data, self.state.step, i)
            else:
                # a due checkpoint records the consumed batches: every metric
                # up to this step is written first
                if pending is not None:
                    consume(pending, end, t_excl=t_data)
                    consume((metrics, t_data, self.state.step, i), time.time())
                    pending = None
                else:
                    consume((metrics, t_data, self.state.step, i), end, t_excl=t_data)
            self.maybe_save_steps(i)
            end = time.time()
        if pending is not None:
            consume(pending, end)
        if prof is not None:  # an epoch of fewer than 6 steps
            self._stop_profile(prof, trace)
        return {k: float(np.mean(v)) for k, v in buffer.items()}
