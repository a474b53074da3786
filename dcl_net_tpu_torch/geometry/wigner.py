"""Wigner-D matrices for SO(3) representations (numpy and PyTorch).

Counterpart of dcl_net_tpu/geometry/wigner.py: its numpy part is copied
here as is (small_d, wigner_d_complex, wigner_D, matrix_to_zyz,
D_from_matrix, zyz_to_matrix); its differentiable jnp part becomes torch
functions (small_d_torch, wigner_D_torch, matrix_to_zyz_torch,
D_from_matrix_torch), differentiable by autograd.

Capability parity with the reference's Wigner-D machinery
(reference utils/transform3D.py:156-397: _z_rot_mat, wigner_D,
D_from_angles, D_from_matrix), which loads precomputed J-matrix constants
from utils/new_constants.pt. Here the real Wigner-d is computed from the
explicit Wigner formula instead of shipped constants — dependency-free and
exact for the small degrees used in equivariant feature pipelines.

Conventions: real spherical-harmonic basis indexed m = -l..l, ZYZ Euler
angles (alpha, beta, gamma) matching the reference's
``D = Xa . J . Xb . J . Xc`` z-rotation sandwich structure.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial, sqrt

import numpy as np
import torch


@lru_cache(maxsize=64)
def _small_d_coeffs(l: int):
    """Precompute the Wigner small-d summation coefficients for degree l."""
    coeffs = {}
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = sqrt(
                factorial(l + mp) * factorial(l - mp)
                * factorial(l + m) * factorial(l - m)
            )
            terms = []
            for s in range(max(0, m - mp), min(l + m, l - mp) + 1):
                denom = (
                    factorial(l + m - s) * factorial(s)
                    * factorial(mp - m + s) * factorial(l - mp - s)
                )
                terms.append((s, (-1) ** (mp - m + s) * pref / denom))
            coeffs[(mp, m)] = terms
    return coeffs


def small_d(l: int, beta: float) -> np.ndarray:
    """Complex-basis Wigner small-d matrix d^l_{m'm}(beta), [2l+1, 2l+1]."""
    beta = float(beta)
    c, s = np.cos(beta / 2.0), np.sin(beta / 2.0)
    out = np.zeros((2 * l + 1, 2 * l + 1))
    coeffs = _small_d_coeffs(l)
    for (mp, m), terms in coeffs.items():
        val = 0.0
        for sidx, coef in terms:
            p_cos = 2 * l + m - mp - 2 * sidx
            p_sin = mp - m + 2 * sidx
            val += coef * (c ** p_cos) * (s ** p_sin)
        out[mp + l, m + l] = val
    return out


def wigner_d_complex(l: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Complex-basis Wigner D: D^l_{m'm} = e^{-i m' a} d^l_{m'm}(b) e^{-i m g}."""
    m = np.arange(-l, l + 1)
    d = small_d(l, beta).astype(np.complex128)
    return np.exp(-1j * m[:, None] * alpha) * d * np.exp(-1j * m[None, :] * gamma)


@lru_cache(maxsize=64)
def _complex_to_real_basis(l: int) -> np.ndarray:
    """Unitary change of basis from complex to real spherical harmonics."""
    n = 2 * l + 1
    u = np.zeros((n, n), np.complex128)
    isq = 1.0 / sqrt(2.0)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            u[i, l + m] = 1j * isq
            u[i, l - m] = -1j * isq * (-1) ** m
        elif m == 0:
            u[i, l] = 1.0
        else:
            u[i, l - m] = isq
            u[i, l + m] = isq * (-1) ** m
    return u


def wigner_D(l: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Real-basis Wigner D matrix (reference wigner_D, transform3D.py:331-350).

    Real and orthogonal; for l=1 it is conjugate (by a fixed permutation) to
    the ordinary 3x3 rotation R_z(alpha) R_y(beta) R_z(gamma).
    """
    u = _complex_to_real_basis(l)
    dc = wigner_d_complex(l, alpha, beta, gamma)
    dr = u @ dc @ u.conj().T
    assert np.abs(dr.imag).max() < 1e-10
    return dr.real


@lru_cache(maxsize=64)
def _small_d_tables(l: int):
    """Static term tables for the torch small-d: one row per summation term.

    Returns (coef [T], p_cos [T], p_sin [T], onehot [(2l+1)^2, T]) numpy
    arrays; ``onehot @ terms`` assembles the matrix.
    """
    n = 2 * l + 1
    coefs, p_cos, p_sin, cell = [], [], [], []
    for (mp, m), terms in _small_d_coeffs(l).items():
        for s, coef in terms:
            coefs.append(coef)
            p_cos.append(2 * l + m - mp - 2 * s)
            p_sin.append(mp - m + 2 * s)
            cell.append((mp + l) * n + (m + l))
    t = len(coefs)
    onehot = np.zeros((n * n, t))
    onehot[cell, np.arange(t)] = 1.0
    return (np.asarray(coefs), np.asarray(p_cos), np.asarray(p_sin), onehot)


def _safe_pow(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x**p for integer exponents p >= 0 with a finite gradient at x == 0
    where p == 0 (plain ``x**0`` backpropagates 0 * x**-1 = nan)."""
    xsafe = torch.where(p == 0, torch.ones_like(x), x)
    return torch.where(p == 0, torch.ones_like(x), xsafe ** p)


def _complex_type(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def small_d_torch(l: int, beta: torch.Tensor) -> torch.Tensor:
    """Wigner small-d [2l+1, 2l+1] of a 0-d tensor beta, differentiable in
    beta (finite gradient at beta = 0 and pi, through _safe_pow)."""
    coef, p_cos, p_sin, onehot = _small_d_tables(l)
    n = 2 * l + 1
    dt, dev = beta.dtype, beta.device
    c = torch.cos(beta / 2.0)
    s = torch.sin(beta / 2.0)
    terms = (torch.as_tensor(coef, dtype=dt, device=dev)
             * _safe_pow(c, torch.as_tensor(p_cos, device=dev))
             * _safe_pow(s, torch.as_tensor(p_sin, device=dev)))
    return (torch.as_tensor(onehot, dtype=dt, device=dev) @ terms).reshape(n, n)


def wigner_D_torch(l: int, alpha: torch.Tensor, beta: torch.Tensor,
                   gamma: torch.Tensor) -> torch.Tensor:
    """Real-basis Wigner D [2l+1, 2l+1] of ZYZ angles (0-d tensors),
    differentiable in all three; equal to wigner_D to the angles' precision
    (complex64 arithmetic for f32 angles, complex128 for f64)."""
    ct = _complex_type(beta.dtype)
    dev = beta.device
    m = torch.arange(-l, l + 1, device=dev).to(beta.dtype)
    d = small_d_torch(l, beta).to(ct)
    dc = (torch.exp(-1j * (m[:, None] * alpha).to(ct)) * d
          * torch.exp(-1j * (m[None, :] * gamma).to(ct)))
    u = torch.as_tensor(_complex_to_real_basis(l), device=dev).to(ct)
    return ((u @ dc) @ u.conj().T).real


def matrix_to_zyz_torch(r: torch.Tensor):
    """Rotation [3, 3] -> ZYZ angles (alpha, beta, gamma) as 0-d tensors,
    branch-free at the gimbal set: each arctan2's inputs are selected before
    the call, so the branch not taken cannot make the gradient nan."""
    beta = torch.arccos(torch.clamp(r[2, 2], -1.0, 1.0))
    gimbal = torch.abs(r[2, 2]) > 1 - 1e-7
    ay = torch.where(gimbal, r[1, 0], r[1, 2])
    ax = torch.where(gimbal, r[0, 0], r[0, 2])
    alpha = torch.arctan2(ay, ax)
    gy = torch.where(gimbal, torch.zeros_like(r[2, 1]), r[2, 1])
    gx = torch.where(gimbal, torch.ones_like(r[2, 0]), -r[2, 0])
    gamma = torch.arctan2(gy, gx)
    return alpha, beta, gamma


def D_from_matrix_torch(l: int, r: torch.Tensor) -> torch.Tensor:
    """Wigner D of a rotation matrix, differentiable in its entries away
    from the gimbal set."""
    return wigner_D_torch(l, *matrix_to_zyz_torch(r))


def matrix_to_zyz(r: np.ndarray):
    """Rotation matrix -> ZYZ Euler angles (reference matrix_to_angles /
    xyz_to_angles, transform3D.py:270-330)."""
    beta = float(np.arccos(np.clip(r[2, 2], -1.0, 1.0)))
    if abs(r[2, 2]) > 1 - 1e-9:  # gimbal: alpha + gamma degenerate
        alpha = float(np.arctan2(r[1, 0], r[0, 0]))
        gamma = 0.0
    else:
        alpha = float(np.arctan2(r[1, 2], r[0, 2]))
        gamma = float(np.arctan2(r[2, 1], -r[2, 0]))
    return alpha, beta, gamma


def D_from_matrix(l: int, r: np.ndarray) -> np.ndarray:
    """Wigner D of a rotation matrix (reference D_from_matrix,
    transform3D.py:383-397)."""
    return wigner_D(l, *matrix_to_zyz(r))


def zyz_to_matrix(alpha: float, beta: float, gamma: float) -> np.ndarray:
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    cg, sg = np.cos(gamma), np.sin(gamma)
    rz1 = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz2 = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
    return rz1 @ ry @ rz2
