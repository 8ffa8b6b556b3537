"""Closed-form batched symmetric 3x3 eigendecomposition.

Port of ``pfilter_tpu/ops/eig3.py``: the trigonometric (Cardano) eigenvalue
formula plus Cayley-Hamilton eigenvectors (Eberly, "A Robust Eigensolver for
3x3 Symmetric Matrices").  The port keeps the closed form instead of
``torch.linalg.eigh`` because it is the reference's numerics, degenerate
cases included: for a degenerate spectrum (p ~ 0, or a repeated eigenvalue)
the eigenvector direction is ill-defined, callers gate on eigenvalue ratios
or plane residuals, and the solver still returns finite values for all
inputs (e_z for a spherical spectrum).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def eigvalsh3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3] matrices, ascending."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    ps = torch.clamp(p, min=_EPS)

    # det((A - qI) / p) / 2, clamped into the acos domain.
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) / (ps * ps * ps)
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    big = q + 2.0 * p * torch.cos(phi)
    small = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    mid = 3.0 * q - big - small
    return torch.stack([small, mid, big], dim=-1)


def _eigvec_for(a: torch.Tensor, l_other1: torch.Tensor, l_other2: torch.Tensor):
    """Unit eigenvector whose eigenvalue is the one NOT passed in, via the
    largest column of (A - l1 I)(A - l2 I)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m1 = a - l_other1[..., None, None] * eye
    m2 = a - l_other2[..., None, None] * eye
    prod = m1 @ m2  # [..., 3, 3]; columns span the target eigenspace
    norms = torch.sum(prod * prod, dim=-2)  # [..., 3] column sq-norms
    best = torch.argmax(norms, dim=-1)
    v = torch.take_along_dim(prod, best[..., None, None].expand(*best.shape, 3, 1), dim=-1)[
        ..., 0
    ]
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    safe = torch.where(n > _EPS, v / torch.clamp(n, min=_EPS), torch.zeros_like(v))
    fallback = torch.zeros_like(safe)
    fallback[..., 2] = 1.0
    return torch.where(n > _EPS, safe, fallback)


def eigh3_smallest(a: torch.Tensor):
    """(eigenvalues ascending [..., 3], unit eigenvector of the smallest)."""
    w = eigvalsh3(a)
    v = _eigvec_for(a, w[..., 1], w[..., 2])
    return w, v


def eigh3_largest(a: torch.Tensor):
    """(eigenvalues ascending [..., 3], unit eigenvector of the largest)."""
    w = eigvalsh3(a)
    v = _eigvec_for(a, w[..., 0], w[..., 1])
    return w, v


def eigh3(a: torch.Tensor):
    """Full decomposition: (eigenvalues ascending [..., 3], eigenvectors
    [..., 3, 3] with column k matching eigenvalue k).  The middle vector is
    the cross product of the outer two."""
    w = eigvalsh3(a)
    v_small = _eigvec_for(a, w[..., 1], w[..., 2])
    v_big = _eigvec_for(a, w[..., 0], w[..., 1])
    v_mid = torch.linalg.cross(v_big, v_small, dim=-1)
    n = torch.sqrt(torch.sum(v_mid * v_mid, dim=-1, keepdim=True))
    fallback = torch.zeros_like(v_mid)
    fallback[..., 1] = 1.0
    v_mid = torch.where(n > _EPS, v_mid / torch.clamp(n, min=_EPS), fallback)
    return w, torch.stack([v_small, v_mid, v_big], dim=-1)
