"""SE(3) geometry: quaternions, the se(3) exponential map, point transforms.

Port of ``pfilter_tpu/ops/se3.py`` (ref: src/lidarOptimization.cpp:80-156 —
``PoseSE3Parameterization``, ``getTransformFromSe3``, ``skew``).  Plain,
batched, fp32 tensor functions that ``torch.func`` can differentiate (the
pose-graph smoother takes their Hessian); poses are (quaternion wxyz,
translation) pairs.

Conventions
-----------
- Quaternions are stored ``[w, x, y, z]``.
- The se(3) tangent is ``[omega(3), upsilon(3)]`` — rotation first.
- Pose update is a *left* perturbation: ``q+ = dq * q``, ``t+ = dq * t + dt``
  (ref: src/lidarOptimization.cpp:91-92).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pose(NamedTuple):
    """A rigid transform: x_world = rotate(q, x_body) + t."""

    q: torch.Tensor  # [..., 4] quaternion wxyz (unit)
    t: torch.Tensor  # [..., 3]


def identity_pose(device=None, dtype=torch.float32) -> Pose:
    return Pose(
        q=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device),
        t=torch.zeros(3, dtype=dtype, device=device),
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector cross product over the last axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Batched skew-symmetric matrix of ``[..., 3]`` vectors (ref: src/lidarOptimization.cpp:145-156)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v [..., 3]`` by quaternions ``q [..., 4]`` (wxyz):
    ``v + 2 w (u x v) + 2 u x (u x v)`` with u = q.xyz."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion -> [..., 3, 3] rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        -2,
    )


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrix -> wxyz quaternion (branch-free Shepperd):
    all four candidate constructions, the one with the largest pivot kept."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    piv = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    piv = torch.sqrt(torch.clamp(piv, min=1e-12)) * 0.5
    w0, x1, y2, z3 = piv[..., 0], piv[..., 1], piv[..., 2], piv[..., 3]
    cand = torch.stack(
        [
            torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0)], -1),
            torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1)], -1),
            torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2)], -1),
            torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3], -1),
        ],
        -2,
    )
    idx = torch.argmax(piv, dim=-1)  # the first of tied maxima, as jnp.argmax
    q = torch.take_along_dim(cand, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)  # canonical sign, w >= 0
    return quat_normalize(q)


def exp_se3(xi: torch.Tensor) -> Pose:
    """se(3) exponential: tangent ``[omega, upsilon]`` -> (q, t).

    Matches ``getTransformFromSe3`` (ref: src/lidarOptimization.cpp:106-143),
    including the small-angle Taylor branch, written branch-free with
    ``torch.where`` (double-where keeps the sqrt away from 0 so derivatives
    stay finite at xi == 0)."""
    omega = xi[..., :3]
    upsilon = xi[..., 3:]
    theta_sq = torch.sum(omega * omega, -1, keepdim=True)
    small = theta_sq < 1e-12
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    half = 0.5 * theta

    w = torch.where(small, 1.0 - theta_sq / 8.0 + theta_sq * theta_sq / 384.0, torch.cos(half))
    imag = torch.where(
        small,
        0.5 - theta_sq / 48.0 + theta_sq * theta_sq / 3840.0,
        torch.sin(half) / theta,
    )
    q = torch.cat([w, imag * omega], -1)

    # t = V(omega) upsilon, V = I + (1-cos)/th^2 Om + (th - sin)/th^3 Om^2
    om = skew(omega)
    om2 = om @ om
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (safe_sq * theta),
    )
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(om.shape)
    V = eye + a[..., None] * om + b[..., None] * om2
    t = torch.einsum("...ij,...j->...i", V, upsilon)
    return Pose(q=q, t=t)


def log_se3(pose: Pose) -> torch.Tensor:
    """Inverse of :func:`exp_se3` — returns ``[omega, upsilon]``."""
    q = quat_normalize(pose.q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn_sq = torch.sum(v * v, -1, keepdim=True)
    small_v = vn_sq < 1e-14
    vn = torch.sqrt(torch.where(small_v, torch.ones_like(vn_sq), vn_sq))
    theta = 2.0 * torch.atan2(torch.where(small_v, torch.zeros_like(vn), vn), w[..., None])
    omega = v * torch.where(small_v, torch.full_like(theta, 2.0), theta / vn)
    theta_sq = torch.sum(omega * omega, -1, keepdim=True)
    small = theta_sq < 1e-12
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    om = skew(omega)
    om2 = om @ om
    # V^{-1} = I - 1/2 Om + (1/th^2 - (1+cos)/(2 th sin)) Om^2
    coef = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - theta * torch.cos(theta * 0.5) / (2.0 * torch.sin(theta * 0.5))) / safe_sq,
    )
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(om.shape)
    Vinv = eye - 0.5 * om + coef[..., None] * om2
    upsilon = torch.einsum("...ij,...j->...i", Vinv, pose.t)
    return torch.cat([omega, upsilon], -1)


def pose_compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b (apply b first, then a)."""
    return Pose(q=quat_normalize(quat_mul(a.q, b.q)), t=quat_rotate(a.q, b.t) + a.t)


def pose_inverse(p: Pose) -> Pose:
    qinv = quat_conj(p.q)
    return Pose(q=qinv, t=-quat_rotate(qinv, p.t))


def pose_update_left(delta_xi: torch.Tensor, p: Pose) -> Pose:
    """Left-multiplicative update: exp(delta) ∘ p with the reference's
    translation rule ``t+ = dq t + dt`` (ref: src/lidarOptimization.cpp:91-92)."""
    d = exp_se3(delta_xi)
    return Pose(q=quat_normalize(quat_mul(d.q, p.q)), t=quat_rotate(d.q, p.t) + d.t)


def transform_points(p: Pose, xyz: torch.Tensor) -> torch.Tensor:
    """Apply a single pose to ``[..., 3]`` points (ref ``pointAssociateToMap``,
    src/odomEstimationClass.cpp:162-174)."""
    return quat_rotate(p.q, xyz) + p.t


def constant_velocity_predict(odom: Pose, last_odom: Pose) -> Pose:
    """odom * (last_odom^-1 * odom) (ref: src/odomEstimationClass.cpp:235)."""
    return pose_compose(odom, pose_compose(pose_inverse(last_odom), odom))
