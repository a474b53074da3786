"""Plain reference of a stage-1 training step: the forward in train mode,
the losses, autograd's gradient, AutoClip, Adam and the learning rate.

A frozen copy of the arithmetic of dcl_net_tpu_torch/train/solver.py
(AutoClip, Optimizer.update, cyclic_lr / step_lr) over per-leaf tensors,
on reference/model.py. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from gpu_bench.reference import model as ref


def learning_rate(cfg: Dict, count: int) -> float:
    """The configuration's schedule at `count` updates already applied."""
    if "lr_scheduler_cyc" in cfg:
        c = cfg["lr_scheduler_cyc"]
        up = int(c["step_size_up"])
        down = int(c.get("step_size_down", up))
        pos = count % (up + down)
        frac = pos / up if pos <= up else 1.0 - (pos - up) / down
        frac = min(max(frac, 0.0), 1.0)
        return float(c["base_lr"]) + (float(c["max_lr"]) - float(c["base_lr"])) * frac
    sched = cfg.get("lr_scheduler", {})
    if sched.get("type") == "StepLR":
        raise ValueError("StepLR needs the steps of an epoch; no cell trains on it")
    return float(cfg["optimizer"]["lr"])


class AdamAutoClip:
    """AutoClip (the percentile of the gradient norms so far, the current
    one included, np.percentile's interpolation) then Adam with bias
    correction, over a list of leaves."""

    def __init__(self, cfg: Dict, leaves: Sequence[torch.Tensor]):
        opt = cfg["optimizer"]
        self.cfg = cfg
        self.b1, self.b2 = (float(b) for b in opt.get("betas", (0.9, 0.999)))
        self.eps = float(opt.get("eps", 1e-8))
        self.percentile = float(cfg.get("clip_percentile", 50.0))
        self.norms: List[float] = []
        self.t = 0
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]

    def step(self, leaves: List[torch.Tensor], grads: List[torch.Tensor]) -> float:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()
        lr = learning_rate(self.cfg, self.t)
        self.t += 1
        self.norms = (self.norms + [norm])[-1024:]
        hist = sorted(self.norms)
        q = self.percentile / 100.0 * (len(hist) - 1)
        lo = int(q)
        hi = min(lo + 1, len(hist) - 1)
        clip = hist[lo] * (1 - (q - lo)) + hist[hi] * (q - lo)
        scale = clip / max(norm, 1e-12) if norm > clip else 1.0
        t = self.t
        with torch.no_grad():
            for p, g, mu, nu in zip(leaves, grads, self.mu, self.nu):
                g = g * scale
                mu.mul_(self.b1).add_((1 - self.b1) * g)
                nu.mul_(self.b2).add_((1 - self.b2) * g * g)
                upd = (mu / (1 - self.b1 ** t)) / (torch.sqrt(nu / (1 - self.b2 ** t)) + self.eps)
                p.add_(-lr * upd)
        return norm


def forward(w: Dict[str, torch.Tensor], batch: Dict, model_cfg: Dict, train: bool):
    obs = ref.encode(batch["inp"]["feats"], batch["inp"]["voxel_idx"], w, "inp", model_cfg, train)
    tmp = ref.encode(batch["tmp"]["feats"], batch["tmp"]["voxel_idx"], w, "tmp", model_cfg, train)
    return ref.fuse(obs, tmp, w, train)


def run_steps(weights: Dict[str, torch.Tensor], names: Sequence[str], batches: Sequence[Dict],
              cfg: Dict) -> Dict[str, object]:
    """Train steps from `weights` on `batches`, one a batch. Returns each
    step's loss_all and rows' rotation conditioning, the first step's
    gradient per leaf (`names`, the trained parameters) and the parameters
    after the last step."""
    leaves = [weights[n].detach().clone().requires_grad_(True) for n in names]
    fixed = {k: v for k, v in weights.items() if k not in set(names)}
    opt = AdamAutoClip(cfg, leaves)
    out = {"loss_all": [], "grad": None, "norms": [], "cond": []}
    for batch in batches:
        w = dict(fixed, **dict(zip(names, leaves)))
        pred = forward(w, batch, cfg["model"], True)
        out["cond"].append(pred["rot_cond"])
        loss = ref.losses(pred, batch)["loss_all"]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        if out["grad"] is None:
            out["grad"] = [g.detach().clone() for g in grads]
        out["loss_all"].append(float(loss.detach()))
        out["norms"].append(opt.step(leaves, grads))
        del loss, grads, w, pred
    out["params"] = [p.detach() for p in leaves]
    return out
