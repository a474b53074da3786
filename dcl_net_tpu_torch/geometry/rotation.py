"""Rotation representations and conversions (plain PyTorch).

Counterpart of dcl_net_tpu/geometry/rotation.py: vector normalisation, the
ortho-6D (Gram-Schmidt) and ortho-9D (SVD with the determinant fix,
polished by two Newton-Schulz steps) maps to SO(3), quaternion, axis-angle
and Euler conversions, random rotations and quaternion algebra. All are
batched over leading axes and differentiable. Run in f32 with TF32 off (see
dcl_net_tpu_torch.strict_f32); a bf16 model's 9D output is normalised in
bf16 and projected in f32, as the JAX function does (torch has no BFloat16
linalg.svd on the CPU, so nothing there could run it in bf16).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def normalize_vector(v: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """L2-normalise the last axis with a magnitude floor. In bf16 the norm
    follows jnp.linalg.norm's rounding points under XLA: the squares rounded
    to bf16, their sum taken in f32 and rounded, the bf16 square root."""
    if v.dtype == torch.bfloat16:
        mag = torch.sqrt((v * v).sum(dim=-1, keepdim=True, dtype=torch.float32)
                         .to(torch.bfloat16))
    else:
        mag = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(mag, min=eps)


_JACOBI_SWEEPS = 6  # cyclic sweeps of nearest_rotation: f64 round-off after 4 on a 3x3
_JACOBI_PAIRS = ((0, 1), (0, 2), (1, 2))


def _plane_rotations(c: torch.Tensor, s: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """[B, 3, 3] rotations in the (p, q) plane: J[p, p] = J[q, q] = c,
    J[p, q] = s, J[q, p] = -s, the identity elsewhere."""
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rows = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    rows[p][p], rows[q][q], rows[p][q], rows[q][p] = c, c, s, -s
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def nearest_rotation(m: torch.Tensor) -> torch.Tensor:
    """U diag(1, 1, det(U V^T)) V^T for [B, 3, 3] matrices M = U S V^T, in
    f64 and without a host sync: torch.linalg.svd reads its convergence
    flags back on the host, which stalls the dispatch of the next batch
    (eval/evaluator.py pipelines it). V comes from cyclic Jacobi rotations
    of M^T M (_JACOBI_SWEEPS sweeps, each pair zeroed by the angle
    0.5 atan2(2 a_pq, a_qq - a_pp)), its columns sorted by eigenvalue;
    u1 = M v1 normalised, u2 = M v2 less its u1 part, normalised (any unit
    vector normal to u1 where M has rank 1). Then the result is
    u1 v1^T + u2 v2^T + (u1 x u2)(v1 x v2)^T: the det fix of the SVD form,
    whatever the signs of U's and V's third columns. Returns M's type."""
    a = m.to(torch.float64)
    gram = a.transpose(-1, -2) @ a
    v = torch.eye(3, dtype=a.dtype, device=a.device).expand(a.shape[0], 3, 3)
    for _ in range(_JACOBI_SWEEPS):
        for p, q in _JACOBI_PAIRS:
            theta = 0.5 * torch.atan2(2.0 * gram[:, p, q], gram[:, q, q] - gram[:, p, p])
            j = _plane_rotations(torch.cos(theta), torch.sin(theta), p, q)
            gram = j.transpose(-1, -2) @ gram @ j
            v = v @ j
    order = torch.argsort(torch.diagonal(gram, dim1=-2, dim2=-1), dim=-1, descending=True)
    v = torch.gather(v, 2, order[:, None, :].expand(-1, 3, -1))
    v1, v2 = v[..., 0], v[..., 1]
    u1 = normalize_vector((a @ v1[..., None])[..., 0], eps=1e-300)
    w = (a @ v2[..., None])[..., 0]
    w = w - (w * u1).sum(-1, keepdim=True) * u1
    # rank 1: the axis least aligned with u1, crossed with it
    axis = torch.nn.functional.one_hot(u1.abs().argmin(-1), 3).to(a.dtype)
    fallback = torch.linalg.cross(u1, axis, dim=-1)
    small = torch.linalg.norm(w, dim=-1, keepdim=True) <= 1e-12
    u2 = normalize_vector(torch.where(small, fallback, w), eps=1e-300)
    u = torch.stack([u1, u2, torch.linalg.cross(u1, u2, dim=-1)], -1)
    v = torch.stack([v1, v2, torch.linalg.cross(v1, v2, dim=-1)], -1)
    return (u @ v.transpose(-1, -2)).to(m.dtype)


def ortho9d_to_matrix(x_raw: torch.Tensor, y_raw: torch.Tensor,
                      z_raw: torch.Tensor) -> torch.Tensor:
    """9D -> SO(3): normalise the three [B, 3] vectors, stack them as the
    columns of M and project to U diag(1, 1, det(U V^T)) V^T. Returns
    [B, 3, 3] rotations with det +1.

    On a CUDA device, where no gradient is taken (evaluation, serving), the
    projection is nearest_rotation, which queues no host sync; otherwise it
    is torch.linalg.svd, whose backward training takes. The two agree to
    f32 round-off."""
    m = torch.stack([normalize_vector(x_raw), normalize_vector(y_raw),
                     normalize_vector(z_raw)], dim=-1)
    m = m.to(torch.promote_types(m.dtype, torch.float32))
    if m.is_cuda and not (torch.is_grad_enabled() and m.requires_grad):
        r = nearest_rotation(m)
    else:
        u, _, vh = torch.linalg.svd(m)
        det = torch.linalg.det(u @ vh)
        sigma = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
        r = (u * sigma[:, None, :]) @ vh
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    for _ in range(2):
        r = 0.5 * (r @ (3.0 * eye - r.transpose(-1, -2) @ r))
    return r


def cross_product(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched 3D cross product over the last axis."""
    return torch.linalg.cross(u, v, dim=-1)


def ortho6d_to_matrix(x_raw: torch.Tensor, y_raw: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt 6D representation, y first: y = norm(y_raw),
    z = norm(x_raw x y), x = y x z. [..., 3] -> [..., 3, 3] whose columns
    are (x, y, z)."""
    y = normalize_vector(y_raw)
    z = normalize_vector(cross_product(x_raw, y))
    x = cross_product(y, z)
    return torch.stack([x, y, z], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z), normalised first, -> rotation [..., 3, 3]."""
    q = normalize_vector(q)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def _normalize_sign(q: torch.Tensor) -> torch.Tensor:
    """q with w >= 0 (w == 0 keeps its sign)."""
    w = q[..., :1]
    return q * torch.sign(torch.where(w == 0, torch.ones_like(w), w))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> unit quaternion (w, x, y, z) with w >= 0,
    branch-free: of the four candidate constructions, the one whose trace
    term is largest."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    traces = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                          1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = torch.argmax(traces, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4, 4]
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return _normalize_sign(normalize_vector(q))


def axis_angle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis [..., 3] (normalised first), angle [...]."""
    axis = normalize_vector(axis)
    s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None, None]
    kx, ky, kz = axis.unbind(-1)
    zeros = torch.zeros_like(kx)
    k = torch.stack([zeros, -kz, ky, kz, zeros, -kx, -ky, kx, zeros],
                    dim=-1).reshape(axis.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(k.shape)
    return eye + s * k + (1 - c) * (k @ k)


def euler_to_matrix(ai: torch.Tensor, aj: torch.Tensor, ak: torch.Tensor) -> torch.Tensor:
    """Static-frame x -> y -> z Euler angles ("sxyz", transforms3d's
    euler2mat) to a rotation [..., 3, 3]."""
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    row0 = torch.stack([cj * ck, sj * sc - cs, sj * cc + ss], dim=-1)
    row1 = torch.stack([cj * sk, sj * ss + cc, sj * cs - sc], dim=-1)
    row2 = torch.stack([-sj, cj * si, cj * ci], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def random_rotation(generator: torch.Generator, shape: tuple = (),
                    device=None) -> torch.Tensor:
    """Uniform random rotations [*shape, 3, 3] from normalised Gaussian
    quaternions drawn from `generator` (on its device unless `device` is
    given)."""
    device = generator.device if device is None else device
    q = torch.randn(tuple(shape) + (4,), generator=generator, device=device)
    return quaternion_to_matrix(q)


def quaternion_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions: R(q1 q2) = R(q1) R(q2)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quaternion_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def translate_rotate(points: torch.Tensor, trans: torch.Tensor,
                     rot: torch.Tensor) -> torch.Tensor:
    """Translate, then rotate: (p + t) @ R^T. points [..., N, 3]."""
    return (points + trans[..., None, :]) @ rot.transpose(-1, -2)
