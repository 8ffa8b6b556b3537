"""Batched analytic Gauss-Newton for scan-to-map SE(3) registration.

Port of ``pfilter_tpu/ops/gauss_newton.py``: the reference's Ceres solve
(DENSE_QR + HuberLoss(0.1) + <=4 iterations, ref:
src/odomEstimationClass.cpp:252-272) as batched tensor math — residuals and
1x6 Jacobians for all correspondences at once, Huber IRLS weights, one
``J^T W J`` reduce to the 6x6 normal equations, a damped Cholesky solve and a
left-multiplicative se(3) update.

- point-to-line (edge): ``r = |(Tp - a) x (Tp - b)| / |a - b|``
  (ref: src/lidarOptimization.cpp:12-46),
- point-to-plane (surf): ``r = n . Tp + d`` (ref: src/lidarOptimization.cpp:56-78).

The Cholesky factor comes from ``cholesky_ex`` without error checks: a
non-positive-definite system yields NaN (as the reference package's does),
which the step's device-side frame guard turns into a dropped frame — and no
host synchronisation is needed to find out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pfilter_tpu_torch.ops import eig3, se3


class Correspondences(NamedTuple):
    """Fixed-size batch of residual factors (masked)."""

    kind: str  # "edge" | "surf"
    points: torch.Tensor  # [M, 3] scan points (sensor frame)
    geom_a: torch.Tensor  # [M, 3] edge: endpoint a   | surf: unit normal
    geom_b: torch.Tensor  # [M, 3] edge: endpoint b   | surf: (d, 0, 0)
    weight: torch.Tensor  # [M] residual weight
    valid: torch.Tensor  # [M] bool


def edge_residual_jacobian(pose: se3.Pose, pts, pa, pb):
    """Point-to-line residual + analytic 1x6 Jacobian (ref: src/lidarOptimization.cpp:12-46)."""
    lp = se3.transform_points(pose, pts)
    nu = se3.cross(lp - pa, lp - pb)
    de = pa - pb
    de_norm = torch.linalg.vector_norm(de, dim=-1)
    nu_norm = torch.linalg.vector_norm(nu, dim=-1)
    safe_nu = torch.clamp(nu_norm, min=1e-12)
    safe_de = torch.clamp(de_norm, min=1e-12)
    r = nu_norm / safe_de
    g = -torch.einsum("mi,mij->mj", nu / safe_nu[:, None], se3.skew(de)) / safe_de[:, None]
    j_rot = torch.einsum("mi,mij->mj", g, -se3.skew(lp))
    return r, torch.cat([j_rot, g], dim=-1)


def surf_residual_jacobian(pose: se3.Pose, pts, normal, d):
    """Point-to-plane residual + analytic 1x6 Jacobian (ref: src/lidarOptimization.cpp:56-78)."""
    pw = se3.transform_points(pose, pts)
    r = torch.sum(normal * pw, dim=-1) + d
    j_rot = torch.einsum("mi,mij->mj", normal, -se3.skew(pw))
    return r, torch.cat([j_rot, normal], dim=-1)


def huber_irls_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of Ceres' HuberLoss(delta): 1 inside, delta/|r| outside."""
    a = torch.abs(r)
    return torch.where(a <= delta, torch.ones_like(a), delta / torch.clamp(a, min=1e-12))


def normal_equations(residuals, jacobians, weights, valid):
    """H = J^T W J (6x6) and b = J^T W r with row weights and a validity mask."""
    w = torch.where(valid, weights, torch.zeros_like(weights))
    jw = jacobians * w[:, None]
    if jw.device.type == "cpu":
        return _ordered_normal_equations(residuals, jacobians, jw)
    return jw.T @ jacobians, jw.T @ residuals


def _ordered_normal_equations(residuals, jacobians, jw):
    """``J^T W J`` and ``J^T W r`` on the CPU, summed row after row in
    float64 (a running sum, ``cumsum``): the same bits on any number of
    threads, where a BLAS product splits its sum by thread."""
    jw64 = jw.double()
    terms = torch.cat([(jw64[:, :, None] * jacobians.double()[:, None, :]).reshape(-1, 36), jw64 * residuals.double()[:, None]], 1)
    total = torch.cumsum(terms, 0)[-1].float()
    return total[:36].reshape(6, 6), total[36:]


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, all NaN when ``a`` is not positive definite
    (the reference's semantics; decided on the device, no sync)."""
    l, info = torch.linalg.cholesky_ex(a, check_errors=False)
    return torch.where(info == 0, l, torch.full_like(l, float("nan")))


def solve_step(h: torch.Tensor, b: torch.Tensor, damping: float) -> torch.Tensor:
    """Damped 6x6 solve ``delta = -(H + lambda*diag(H))^-1 b``."""
    eye = torch.eye(6, dtype=h.dtype, device=h.device)
    scale = torch.clamp(torch.diagonal(h), min=1e-6)
    hd = h + damping * torch.diag(scale) + 1e-9 * eye
    l = cholesky_or_nan(hd)
    y = torch.linalg.solve_triangular(l, -b[:, None], upper=False)
    return torch.linalg.solve_triangular(l.T, y, upper=True)[:, 0]


def gn_iteration(pose: se3.Pose, factor_sets, huber_delta: float, damping: float, reduce=None):
    """One Gauss-Newton step over any number of factor sets.  Point weights
    scale both the residual and the Jacobian (consistent IRLS).  ``reduce``
    maps the local ``(H, b)`` to the ones solved (the map-sharded step sums
    them over its shards)."""
    h = torch.zeros((6, 6), dtype=torch.float32, device=pose.q.device)
    b = torch.zeros(6, dtype=torch.float32, device=pose.q.device)
    for fs in factor_sets:
        if fs.kind == "edge":
            r, j = edge_residual_jacobian(pose, fs.points, fs.geom_a, fs.geom_b)
        elif fs.kind == "surf":
            r, j = surf_residual_jacobian(pose, fs.points, fs.geom_a, fs.geom_b[:, 0])
        else:
            raise ValueError(fs.kind)
        rw = r * fs.weight
        jw = j * fs.weight[:, None]
        irls = huber_irls_weight(rw, huber_delta)
        hi, bi = normal_equations(rw, jw, irls, fs.valid)
        h, b = h + hi, b + bi
    if reduce is not None:
        h, b = reduce(h, b)
    delta = solve_step(h, b, damping)
    return se3.pose_update_left(delta, pose), (h, b)


def _covariance(neighbors: torch.Tensor):
    center = torch.mean(neighbors, dim=1)
    zm = neighbors - center[:, None, :]
    return center, torch.einsum("mki,mkj->mij", zm, zm)


def fit_lines(neighbors: torch.Tensor, eig_ratio: float, half_length: float):
    """Batched PCA line fit over [M, 5, 3] neighborhoods
    (ref: src/odomEstimationClass.cpp:302-331): valid iff
    lambda_max > eig_ratio * lambda_mid; endpoints at centroid +- half_length * dir."""
    center, cov = _covariance(neighbors)
    evals, direction = eig3.eigh3_largest(cov)
    ok = evals[..., 2] > eig_ratio * evals[..., 1]
    return center + half_length * direction, center - half_length * direction, ok


def fit_planes(neighbors: torch.Tensor, tol: float):
    """Batched total-least-squares plane fit over [M, 5, 3] neighborhoods;
    valid iff every neighbor is within ``tol`` of the plane (ref: :449-476).
    Returns (normal [M,3], d [M], ok [M]) with plane n.p + d = 0."""
    center, cov = _covariance(neighbors)
    _, normal = eig3.eigh3_smallest(cov)
    d = -torch.sum(normal * center, dim=-1)
    resid = torch.abs(torch.einsum("mkj,mj->mk", neighbors, normal) + d[:, None])
    return normal, d, torch.all(resid <= tol, dim=-1)


def masked_minmax(values: torch.Tensor, valid: torch.Tensor):
    big = 3.0e38
    vmin = torch.amin(torch.where(valid, values, torch.full_like(values, big)))
    vmax = torch.amax(torch.where(valid, values, torch.full_like(values, -big)))
    return vmin, vmax


def fold_normalize(values, vmin, vmax, floor: float):
    """The reference's weight normalizer core: min-max normalize, fold
    (x -> |x-1|), scale to [0, 2], clamp at ``floor`` — an inversion that maps
    the largest input to ``floor`` (see the reference package's note on
    weightType 1, ``pfilter_tpu/ops/gauss_newton.py:172-204``)."""
    length = vmax - vmin
    ok = length > 0
    x = (values - vmin) / torch.where(ok, length, torch.ones_like(length))
    x = torch.abs(x - 1.0) * 2.0
    x = torch.clamp(x, min=floor)
    return torch.where(ok, x, torch.ones_like(x))


def minmax_normalize_weights(values: torch.Tensor, valid: torch.Tensor, floor: float):
    """observeMean/pointSparsityMean normalizer (ref:
    src/odomEstimationClass.cpp:136-160): weights degenerate to 1 when all
    values are equal or none is valid."""
    vmin, vmax = masked_minmax(values, valid)
    normed = fold_normalize(values, vmin, vmax, floor)
    return torch.where(valid.any(), normed, torch.ones_like(normed))
