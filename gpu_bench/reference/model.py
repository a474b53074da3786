"""Plain reference of DCL-Net stage 1: the mathematics the benchmark judges
the program against, written out in plain PyTorch.

A frozen copy of the model's arithmetic (dcl_net_tpu_torch/models/,
ops/sparse_conv.py, ops/voxelize.py, geometry/, eval/metrics.py), kept here
so that a later change to the program cannot move the yardstick. It
imports nothing of the program. Departures from the program, each of which
changes only rounding:

- BN is applied after each convolution, not folded into its kernel;
- voxel sums are an index_add_ in whatever order the device takes;
- the 3 nearest centers are torch.topk's, not an iterated argmin;
- the rotation projection is torch.linalg.svd in float64 in every mode.

Weights are a dict keyed by the program's state_dict names; inputs are the
program's batch dict of tensors. Everything runs in the inputs' precision:
float32, with TF32 off unless `precision("tf32")` turned it on (the
control).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DIMS = (7, 16, 32, 32, 64, 64, 128, 128, 256)
REGULAR = (0, 2, 4, 6)      # regular (dilating) conv layers; the rest submanifold
POOL_AFTER = (1, 3, 5, 7)   # a true-average pool closes each module
SCALES = (2, 4, 6, 8)       # the reference's voxel-center scale quirk
EPS = 1e-5
BIG = 1e10


def precision(mode: str) -> None:
    """"f32": TF32 off for matmuls and cuDNN; "tf32": on (the control)."""
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


# ---------------------------------------------------------------------------
# Voxel grids
# ---------------------------------------------------------------------------
def voxelize_mean(feats: torch.Tensor, vidx: torch.Tensor, grid: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of the points' features in each voxel: grid [B, D0, D1, D2, C]
    and counts [B, D0, D1, D2]."""
    b, n, c = feats.shape
    d0, d1, d2 = grid
    g = d0 * d1 * d2
    v = vidx.long()
    lin = (v[..., 0] * d1 + v[..., 1]) * d2 + v[..., 2] + g * torch.arange(
        b, device=feats.device)[:, None]
    total = torch.zeros(b * g, c, dtype=feats.dtype, device=feats.device)
    total.index_add_(0, lin.reshape(-1), feats.reshape(-1, c))
    count = torch.zeros(b * g, dtype=feats.dtype, device=feats.device)
    count.index_add_(0, lin.reshape(-1), torch.ones(b * n, dtype=feats.dtype,
                                                    device=feats.device))
    mean = total / torch.clamp(count, min=1.0)[:, None]
    return mean.reshape(b, d0, d1, d2, c), count.reshape(b, d0, d1, d2)


def dilate(mask: torch.Tensor) -> torch.Tensor:
    """Active output set of a regular 3^3 sparse conv."""
    return F.max_pool3d(mask[:, None], 3, 1, 1)[:, 0]


def window_sum(x: torch.Tensor) -> torch.Tensor:
    """3^3 box sum, stride 2, zero padding 1, of [B, D0, D1, D2, C]."""
    xp = F.pad(x.permute(0, 4, 1, 2, 3), (1,) * 6)
    return F.avg_pool3d(xp, 3, 2, divisor_override=1).permute(0, 2, 3, 4, 1)


def avg_pool(x: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """True-average sparse pool: window sum of occupied features over the
    window's occupied count."""
    s = window_sum(x * m[..., None])
    cnt = window_sum(m[..., None])[..., 0]
    new_m = (cnt > 0).to(x.dtype)
    return s / torch.clamp(cnt, min=1.0)[..., None] * new_m[..., None], new_m


def conv_block(x, m, w: Dict[str, torch.Tensor], name: str, regular: bool, train: bool):
    """Sparse conv (3^3, no bias), BN over the active voxels, ReLU, re-mask."""
    new_m = dilate(m) if regular else m
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w[f"{name}.conv.weight"], padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if train:
        mm = new_m[..., None]
        count = torch.clamp(mm.sum(), min=1.0)
        axes = (0, 1, 2, 3)
        mean = (y * mm).sum(axes) / count
        var = (mm * (y - mean) ** 2).sum(axes) / count
    else:
        mean, var = w[f"{name}.bn.running_mean"], w[f"{name}.bn.running_var"]
    y = (y - mean) / torch.sqrt(var + EPS) * w[f"{name}.bn.weight"] + w[f"{name}.bn.bias"]
    return torch.relu(y) * new_m[..., None], new_m


def backbone(grid, mask, w, prefix: str, train: bool) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    levels = []
    x, m = grid, mask
    for i in range(len(DIMS) - 1):
        x, m = conv_block(x, m, w, f"{prefix}.conv{i}", i in REGULAR, train)
        if i in POOL_AFTER:
            x, m = avg_pool(x, m)
            levels.append((x, m))
    return levels


# ---------------------------------------------------------------------------
# Compaction and 3-NN interpolation
# ---------------------------------------------------------------------------
def compact(feats: torch.Tensor, mask: torch.Tensor, cap: int):
    """The first `cap` occupied voxels of each sample in linear-index order:
    coords [B, cap, 3], vfeats [B, cap, C], vmask [B, cap], occupancy [B]."""
    b, d0, d1, d2, c = feats.shape
    g = d0 * d1 * d2
    occ = mask.reshape(b, g) > 0
    lin = torch.argsort((~occ).to(torch.uint8), dim=1, stable=True)[:, :cap]
    vmask = torch.gather(occ, 1, lin).to(feats.dtype)
    vfeats = torch.gather(feats.reshape(b, g, c), 1, lin[..., None].expand(-1, -1, c))
    vfeats = vfeats * vmask[..., None]
    coords = torch.stack([lin // (d1 * d2), (lin // d2) % d1, lin % d2], -1)
    return coords * vmask[..., None].long(), vfeats, vmask, occ.sum(1)


def three_nn(points, centers, vfeats, vmask) -> torch.Tensor:
    """Inverse-squared-distance weights of the 3 nearest valid centers."""
    diff = points[:, :, None, :] - centers[:, None, :, :]
    d2 = (diff * diff).sum(-1)
    d2 = torch.where(vmask[:, None, :] > 0, d2, torch.full_like(d2, BIG))
    if d2.shape[-1] < 3:  # fewer than 3 centers: the rest at BIG, index 0
        d2 = F.pad(d2, (0, 3 - d2.shape[-1]), value=BIG)
    dist, idx = torch.topk(d2, 3, dim=-1, largest=False)
    idx = torch.where(idx < vfeats.shape[1], idx, torch.zeros_like(idx))
    recip = 1.0 / (dist + 1e-8)
    wts = recip / recip.sum(-1, keepdim=True)
    batch = torch.arange(points.shape[0], device=points.device)[:, None, None]
    return (vfeats[batch, idx] * wts[..., None]).sum(2)


def point_features(points, levels, model_cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four levels interpolated onto the points [B, N, 480], and the
    capacity overflow flag [B]."""
    unit = np.asarray(model_cfg["unit_voxel_extent"], np.float32)
    limit = np.asarray(model_cfg["voxel_num_limit"], np.float32)
    offset = -0.5 * unit * limit
    out, overflow = [], torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    for level, (feats, mask) in enumerate(levels):
        grid_n = int(np.prod(feats.shape[1:4]))
        cap = min(int(model_cfg["capacities"][level]), grid_n)
        coords, vfeats, vmask, occ = compact(feats, mask, cap)
        u = unit * SCALES[level]
        scale = torch.as_tensor(u, device=points.device)
        shift = torch.as_tensor(offset + 0.5 * u, device=points.device)
        centers = coords.to(points.dtype) * scale + shift
        out.append(three_nn(points, centers, vfeats, vmask))
        overflow = overflow | (occ > cap)
    return torch.cat(out, -1), overflow


# ---------------------------------------------------------------------------
# Per-point MLPs and heads
# ---------------------------------------------------------------------------
def _bn1d(x, w, name: str, train: bool):
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
    else:
        mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
    return (x - mean) * (torch.rsqrt(var + EPS) * w[f"{name}.weight"]) + w[f"{name}.bias"]


ACTS = {"relu": torch.relu, "none": lambda x: x}


def mlp(x, w, name: str, acts: Sequence[str], bns: Sequence[bool],
        bn_before_act: bool, train: bool):
    j = 0
    for i, (act, bn) in enumerate(zip(acts, bns)):
        x = x @ w[f"{name}.Dense_{i}.weight"].t()
        if f"{name}.Dense_{i}.bias" in w:
            x = x + w[f"{name}.Dense_{i}.bias"]
        if bn_before_act:
            if bn:
                x = _bn1d(x, w, f"{name}.BatchNorm_{j}", train)
                j += 1
            x = ACTS[act](x)
        else:
            x = ACTS[act](x)
            if bn:
                x = _bn1d(x, w, f"{name}.BatchNorm_{j}", train)
                j += 1
    return x


HEAD3 = (("relu", "relu", "none"), (False,) * 3)
NECK = (("relu",) * 3, (True,) * 3)


def encode(feats, vidx, w, side: str, model_cfg, train: bool) -> Dict[str, torch.Tensor]:
    """One branch: voxelize, backbone, point features, the four disengage
    heads. side "inp" (observed, heads Xc) or "tmp" (template, heads Yo)."""
    grid, count = voxelize_mean(feats, vidx, tuple(model_cfg["voxel_num_limit"]))
    levels = backbone(grid, (count > 0).to(feats.dtype), w, f"backbone_{side}", train)
    points = feats[..., 4:7]
    f, overflow = point_features(points, levels, model_cfg)
    heads = "Xc" if side == "inp" else "Yo"
    out = {"points": points, "overflow": overflow}
    for name in ("p1", "m1", "p2", "m2"):
        out[name] = mlp(f, w, f"disengage_{heads}_{name}", ("relu", "relu"),
                        (True, True), True, train)
    return out


def ortho9d_to_matrix(o9: torch.Tensor):
    """Normalise the three columns, project onto SO(3) (SVD with the
    determinant fix, float64), then two Newton-Schulz steps. Returns the
    rotations and each row's conditioning: the least |s_i + s_j| over the
    pairs of the signed singular values (s1, s2, det * s3), the
    denominators by which the projection divides a change of its input."""
    cols = [o9[:, 3 * k:3 * k + 3] for k in range(3)]
    cols = [c / torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=1e-8)
            for c in cols]
    m = torch.stack(cols, -1).to(torch.float64)
    u, sv, vh = torch.linalg.svd(m)
    det = torch.linalg.det(u @ vh)
    sigma = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    r = ((u * sigma[:, None, :]) @ vh).to(o9.dtype)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    for _ in range(2):
        r = 0.5 * (r @ (3.0 * eye - r.transpose(-1, -2) @ r))
    s = (sv * sigma).detach()
    cond = torch.stack([(s[:, 0] + s[:, 1]).abs(), (s[:, 0] + s[:, 2]).abs(),
                        (s[:, 1] + s[:, 2]).abs()], -1).amin(-1)
    return r, cond.float()


def fuse(obs, tmp, w, train: bool) -> Dict[str, torch.Tensor]:
    """Bidirectional attention, confidence, the fused features and the pose."""
    def align(ri_1, ri_2, re_2):
        att = torch.softmax(ri_2 @ ri_1.transpose(1, 2), dim=1)
        return att.transpose(1, 2) @ re_2, att

    f_xo_p, att = align(obs["m1"], tmp["m1"], tmp["p1"])
    f_yc_p, att_bi = align(tmp["m2"], obs["m2"], obs["p2"])
    xo_pred = mlp(f_xo_p, w, "regressor_Xo", *HEAD3, False, train)
    yc_pred = mlp(f_yc_p, w, "regressor_Yc", *HEAD3, False, train)
    f_m1 = torch.cat([obs["m1"], att.transpose(1, 2) @ tmp["m1"]], -1)
    f_m2 = torch.cat([att_bi.transpose(1, 2) @ obs["m2"], tmp["m2"]], -1)
    conf = torch.sigmoid(torch.cat([mlp(f_m1, w, "regressor_conf", *HEAD3, False, train),
                                    mlp(f_m2, w, "regressor_conf_bi", *HEAD3, False, train)],
                                   1))
    f_p1 = mlp(torch.cat([obs["p1"], f_xo_p], -1), w, "neck_fuser", *NECK, False, train)
    f_p2 = mlp(torch.cat([f_yc_p, tmp["p2"]], -1), w, "neck_fuser_bi", *NECK, False, train)
    f_p = torch.cat([f_p1, f_p2], 1)
    pooled = torch.sum(f_p * torch.softmax(conf, dim=1), 1)[:, None, :]
    o9 = mlp(pooled, w, "regressor_rot", *HEAD3, False, train)[:, 0]
    trans = mlp(pooled, w, "regressor_trans", *HEAD3, False, train)[:, 0]
    rot, cond = ortho9d_to_matrix(o9)
    return {"rot_pred": rot, "rot_cond": cond, "trans_pred": trans, "conf": conf[..., 0],
            "overflow": obs["overflow"] | tmp["overflow"], "Xo_pred": xo_pred,
            "Yc_pred": yc_pred, "points_inp": obs["points"], "points_tmp": tmp["points"]}


# ---------------------------------------------------------------------------
# Metric and losses
# ---------------------------------------------------------------------------
def transform(points, rot, trans):
    return points @ rot.transpose(-1, -2) + trans[..., None, :]


def sq_dist(a, b):
    return torch.clamp((a * a).sum(-1)[..., :, None] - 2.0 * (a @ b.transpose(-1, -2))
                       + (b * b).sum(-1)[..., None, :], min=0.0)


def add_s(model_points, rot, trans, rot_gt, trans_gt) -> torch.Tensor:
    """Mean nearest-point distance of the predicted- to the true-posed CAD
    cloud, [B]."""
    d = torch.sqrt(sq_dist(transform(model_points, rot, trans),
                           transform(model_points, rot_gt, trans_gt)) + 1e-12)
    return d.min(-1).values.mean(-1)


def losses(pred, batch) -> Dict[str, torch.Tensor]:
    """The stage-1 losses: pose, Xo, Yc (L2, or chamfer for symmetric
    objects) and the confidence's self-calibration, mean over valid rows."""
    def l2(a, b):
        return torch.linalg.norm(a - b, dim=-1)

    def chamfer(a, b):
        d = torch.sqrt(sq_dist(a, b) + 1e-12)
        return 0.5 * (d.amin(-1) + d.amin(-2))

    rot, trans = pred["rot_pred"], pred["trans_pred"]
    sym = batch["sym_flag"][:, None]
    valid = batch["valid"]
    wgt = valid / torch.clamp(valid.sum(), min=1.0)
    rot_gt, trans_gt = batch["labels"]["rot_gt"], batch["labels"]["trans_gt"]
    p_tmp, p_inp = pred["points_tmp"], pred["points_inp"]
    posed_pred = transform(p_tmp, rot, trans)
    posed_gt = transform(p_tmp, rot_gt, trans_gt)
    pose_pp = (1 - sym) * l2(posed_pred, posed_gt) + sym * chamfer(posed_pred, posed_gt)
    cano_pred = ((p_inp - trans[:, None]) @ rot).detach()
    cano_gt = ((p_inp - trans_gt[:, None]) @ rot_gt).detach()
    xo, yc = pred["Xo_pred"], pred["Yc_pred"]
    xo_pp = (1 - sym) * l2(xo, cano_gt) + 0.5 * sym * (chamfer(xo, p_tmp) + l2(xo, cano_pred))
    yc_pp = (1 - sym) * l2(yc, posed_gt) + 0.5 * sym * (
        chamfer(yc, posed_gt) + l2(yc, posed_pred.detach()))
    pp = torch.cat([xo_pp, yc_pp], 1).detach()
    conf = pred["conf"]
    conf_term = pp * conf - 0.01 * torch.log(torch.clamp(conf, min=1e-12))
    out = {"loss_pose": torch.sum(wgt * pose_pp.mean(1)),
           "loss_Xo": torch.sum(wgt * xo_pp.mean(1)),
           "loss_Yc": torch.sum(wgt * yc_pp.mean(1)),
           "loss_conf": torch.sum(wgt * conf_term.mean(1))}
    out["loss_all"] = out["loss_pose"] + 5.0 * out["loss_Xo"] + out["loss_Yc"] + out["loss_conf"]
    return out
