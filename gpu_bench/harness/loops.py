"""The three loops that drive the program, each through its public entry:
Evaluator.evaluate (eval), Solver.train_epoch (train) and BundleServer
(serve).

Each loop's `setup` builds the program's object from the run's weights and
inputs and runs every shape the window will use; `window` drives that same
object for the window's seconds and returns what the end-to-end metrics
and the comparison need; `program_outputs` hands what the comparison reads
over once the program's state is freed.
"""

from __future__ import annotations

import os
import tempfile
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gpu_bench.harness import traffic as tr
from gpu_bench.harness.data import Objects, stack_batch
from gpu_bench.harness.weights import make_weights, shapes_of

# streams of the row generator (data.Objects.rows): one per use
POOL_STREAM = 100
SERVE_STREAM = 300


def span(name: str):
    """A host span in the traced run (no cost beyond a check when the
    profiler is off)."""
    return torch.profiler.record_function(f"bench.{name}")


@dataclass
class WindowResult:
    """What one measured window did: `units` (batches, steps or frames)
    holding `attempted` instances, over `seconds` of host clock; `work`
    holds each unit's inputs, which counts/work.py counts."""

    seconds: float
    units: int
    attempted: int
    failed: int = 0
    latencies_s: List[float] = field(default_factory=list)
    frame_sizes: List[int] = field(default_factory=list)
    work: List[Dict[str, Any]] = field(default_factory=list)   # the units' inputs


def build_model(cell, seed: int, device):
    """The program's model from the configuration, with the run's weights;
    also returns the weights, which the reference reads."""
    from dcl_net_tpu_torch.models.dcl_net import DCLNet

    model = DCLNet.from_config(cell.config["model"], device=device)
    weights = make_weights(shapes_of(model), seed, device)
    model.load_state_dict(weights)
    return model, weights


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# eval: Evaluator.evaluate over batches of a pool, closed loop
# ---------------------------------------------------------------------------
class EvalLoop:
    kind = "eval"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device

    def setup(self) -> None:
        from dcl_net_tpu_torch.eval.evaluator import Evaluator

        t = self.cell.traffic
        self.batch = int(t["batch"])
        objects = Objects(self.cell.config, self.seed)
        self.pool = [stack_batch(objects.rows(self.seed, POOL_STREAM + p, self.batch))
                     for p in range(int(t["pool_batches"]))]
        self.bank = objects.template_bank()
        self.model_points = objects.model_points()
        self.model, self.weights = build_model(self.cell, self.seed, self.device)
        kept = {}

        class Recording(Evaluator):
            """Evaluator that keeps the poses and ADD-S rows it scored of the
            dispatches in `keep` (device tensors, no host wait)."""
            keep: set = set()
            n = 0

            def _run(self, batch):
                res = super()._run(batch)
                if self.n in self.keep:
                    kept[self.n] = {k: res[k] for k in ("rot_pred", "trans_pred",
                                                        "overflow", "adds")}
                self.n += 1
                return res

        self.kept = kept
        self.evaluator = Recording(self.model, self.model_points, protocol=t["protocol"],
                                   template_bank=self.bank, device=self.device)
        # every shape of the window: a batch of the pool, dispatched one deep
        self.evaluator.evaluate(self.pool[:2])
        _sync(self.device)

    def window(self, seconds: float) -> WindowResult:
        order = tr.batch_order(self.seed, len(self.pool), 100000)
        first = {}
        for k, p in enumerate(order):
            first.setdefault(p, k)
        ev = self.evaluator
        ev.n, ev.keep = 0, set(first.values())
        self.kept.clear()
        used: List[int] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def loader():
            for p in order:
                if used and time.perf_counter() >= deadline:
                    return
                used.append(p)
                with span("loader"):
                    batch = self.pool[p]
                yield batch

        with span("evaluate"):
            ev.evaluate(loader())
        _sync(self.device)
        t1 = time.perf_counter()
        self.first = {p: k for p, k in first.items() if k < len(used)}
        return WindowResult(t1 - t0, len(used), len(used) * self.batch,
                            work=[self.pool[p] for p in used])

    def program_outputs(self) -> Dict[str, Any]:
        """The scored rows of each pool batch's first dispatch, on the host;
        frees the program."""
        out = {p: {k: v.float().cpu() for k, v in self.kept[k].items()}
               for p, k in self.first.items()}
        del self.evaluator, self.model
        self.kept.clear()
        return {"rows": out}


# ---------------------------------------------------------------------------
# train: Solver.train_epoch over batches of a pool, closed loop
# ---------------------------------------------------------------------------
class _Batches:
    """A loader over host batches: `len` and iteration, as Solver reads it;
    with a deadline, it stops yielding once the deadline has passed."""

    def __init__(self, batches, deadline: Optional[float] = None):
        self.batches = batches
        self.deadline = deadline
        self.batch_size = len(batches[0]["valid"])
        self.yielded = 0

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            if self.deadline is not None and self.yielded and \
                    time.perf_counter() >= self.deadline:
                return
            self.yielded += 1
            yield b


class TrainLoop:
    kind = "train"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device

    def setup(self) -> None:
        from dcl_net_tpu_torch.config import Config
        from dcl_net_tpu_torch.models.dcl_net import dcl_losses
        from dcl_net_tpu_torch.train.solver import Solver

        t = self.cell.traffic
        self.batch = int(t["batch"])
        objects = Objects(self.cell.config, self.seed)
        self.pool = [stack_batch(objects.rows(self.seed, POOL_STREAM + p, self.batch))
                     for p in range(int(t["pool_batches"]))]
        self.order = tr.batch_order(self.seed, len(self.pool), 100000)
        n_setup = int(t["setup_steps"])
        self.setup_batches = [self.pool[p] for p in self.order[:n_setup]]
        if len(set(self.order[:n_setup])) < n_setup:
            raise ValueError("the set-up's steps need distinct batches: pool too small")
        self.model, self.weights = build_model(self.cell, self.seed, self.device)
        self.names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        cfg = Config({k: v for k, v in self.cell.config.items() if k != "assumed"})
        self.solver = Solver(self.model, dcl_losses, cfg, _Batches(self.setup_batches),
                             device=self.device)
        self.solver.initialize()  # keeps the run's weights
        params = [p for p in self.model.parameters() if p.requires_grad]
        snap: Dict[str, Any] = {"init": [p.detach().clone() for p in params], "losses": []}
        step = self.solver.train_step

        def recording_step(st, batch):
            metrics = step(st, batch)
            snap["losses"].append(metrics["loss_all"].detach().clone())
            if st.step == 1:
                snap["mu1"] = st.opt_state["mu"].detach().clone()
            if st.step == int(t["checked_steps"]):
                snap["after"] = [p.detach().clone() for p in params]
            return metrics

        self.solver.train_step = recording_step
        self.solver.train_epoch()
        self.solver.train_step = step
        self.snap = snap
        _sync(self.device)

    def window(self, seconds: float) -> WindowResult:
        t0 = time.perf_counter()
        n_setup = len(self.setup_batches)
        loader = _Batches([self.pool[p] for p in self.order[n_setup:]], t0 + seconds)
        self.solver.loader = loader
        with span("train_epoch"):
            avg = self.solver.train_epoch()
        _sync(self.device)
        t1 = time.perf_counter()
        steps = loader.yielded
        skipped = int(round(avg.get("skipped_nonfinite", 0.0) * steps))
        return WindowResult(t1 - t0, steps, steps * self.batch, failed=skipped * self.batch,
                            work=[self.pool[p] for p in self.order[n_setup:n_setup + steps]])

    def program_outputs(self) -> Dict[str, Any]:
        """The set-up's first steps as the program took them: losses, the
        first gradient (from Adam's first moment after one step: AutoClip
        leaves a first step unclipped, so mu = (1 - b1) g) and the
        parameters before and after the checked steps; frees the program."""
        b1 = float(self.cell.config["optimizer"]["betas"][0])
        sizes = [p.numel() for p in self.snap["init"]]
        grad = [g.view_as(p) for g, p in zip((self.snap["mu1"] / (1.0 - b1)).split(sizes),
                                             self.snap["init"])]
        out = {"losses": [float(x) for x in self.snap["losses"]], "grad": grad,
               "init": self.snap["init"], "after": self.snap["after"], "names": self.names}
        del self.solver, self.model
        return out


# ---------------------------------------------------------------------------
# serve: BundleServer, one call a frame, open loop
# ---------------------------------------------------------------------------
class ServeLoop:
    kind = "serve"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device

    def setup(self) -> None:
        from dcl_net_tpu_torch.serving import BundleServer, export_bundle, save_bundle

        t = self.cell.traffic
        objects = Objects(self.cell.config, self.seed)
        self.bank = objects.template_bank()
        rows = objects.rows(self.seed, SERVE_STREAM, int(t["pool_rows"]))
        self.rows = stack_batch(rows)
        self.model, self.weights = build_model(self.cell, self.seed, self.device)
        n_points = int(self.cell.config["model"]["n_inp"])
        artifacts = export_bundle(self.model, self.bank, n_points,
                                  batch_sizes=tuple(t["artifact_batches"]),
                                  include_poly=False)
        self.tmp = tempfile.TemporaryDirectory(prefix="gpu_bench_bundle_")
        save_bundle(os.path.join(self.tmp.name, "bundle"), artifacts, self.model)
        del artifacts, self.model
        self.server = BundleServer(os.path.join(self.tmp.name, "bundle"))
        self.server_fixed_sizes = list(self.server.fixed_sizes)
        lo, hi = (int(v) for v in t["instances"])
        for n in range(lo, hi + 1):
            self._call(np.arange(n))
        _sync(self.device)

    def _call(self, idx: np.ndarray):
        r = self.rows
        out = self.server(r["inp"]["feats"][idx], r["inp"]["voxel_idx"][idx],
                          r["labels"]["obj_idx"][idx])
        with span("copy_to_host"):
            return {k: out[k].float().cpu() for k in ("rot_pred", "trans_pred", "overflow")}

    def window(self, seconds: float, rate_per_s: float = None) -> WindowResult:
        frames = tr.frame_schedule(self.cell.traffic, self.seed, seconds, rate_per_s)
        self.frames, self.outputs = frames, []
        lat = []
        t0 = time.perf_counter()
        for due_s, idx in zip(frames.due_s, frames.rows):
            due = t0 + due_s
            with span("wait_for_frame"):
                while time.perf_counter() < due:
                    left = due - time.perf_counter()
                    if left > 2e-3:
                        time.sleep(left - 1e-3)
            with span("serve_frame"):
                self.outputs.append(self._call(idx))
            lat.append(time.perf_counter() - due)
        t1 = time.perf_counter()
        sizes = [len(i) for i in frames.rows]
        return WindowResult(t1 - t0, len(frames.rows), int(sum(sizes)), latencies_s=lat,
                            frame_sizes=sizes)

    def program_outputs(self) -> Dict[str, Any]:
        out = {"frames": self.frames, "outputs": self.outputs}
        del self.server
        self.tmp.cleanup()
        return out


LOOP_TYPES = {"eval": EvalLoop, "train": TrainLoop, "serve": ServeLoop}


def make_loop(cell, seed: int, device):
    kind = cell.traffic["loop"]
    if kind not in LOOP_TYPES:
        raise ValueError(f"traffic {cell.traffic_name}: loop {kind!r} not one of {tr.LOOPS}")
    return LOOP_TYPES[kind](cell, seed, device)


def profiled(enabled: bool, device):
    """A torch.profiler of CPU and, on a card, CUDA activity, or a no-op."""
    if not enabled:
        return nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
