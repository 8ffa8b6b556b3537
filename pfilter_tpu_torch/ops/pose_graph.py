"""Windowed pose-graph smoother over the last K scan-matched poses.

Port of ``pfilter_tpu/ops/pose_graph.py``: K recent poses, each anchored to
its scan-match result by the 6x6 GN information matrix, plus
constant-velocity smoothness factors.  Per window slot i the tangent
increment xi_i = (omega_i, upsilon_i) acts around the anchor A_i as
``X_i = (exp_q(omega_i) * A_i.q, A_i.t + upsilon_i)``.

Cost:  sum_i  xi_i^T H_i xi_i                      (anchors)
     + sum_i  || log( rel_i^{-1} rel_{i+1} ) ||^2_W (constant-velocity)

with rel_i = X_i^{-1} X_{i+1} and W = diag(w_rot I3, w_xy, w_xy, w_z),
minimised by a few damped Newton steps.  The gradient and Hessian come from
``torch.func.grad``/``torch.func.hessian`` (the reference package uses
``jax.grad``/``jax.hessian``); the solve is Jacobi-preconditioned and its
Cholesky factor is NaN on a non-positive-definite system, which the guard in
:func:`smoothed_newest` catches on the device.
"""

from __future__ import annotations

import torch
from torch.func import grad, hessian

from pfilter_tpu_torch.ops import se3
from pfilter_tpu_torch.ops.gauss_newton import cholesky_or_nan


def _apply_xi(xi: torch.Tensor, q: torch.Tensor, t: torch.Tensor):
    """xi [K,6] = (omega, upsilon) around anchors (q [K,4], t [K,3])."""
    dq = se3.exp_se3(xi)
    qn = se3.quat_normalize(se3.quat_mul(dq.q, q))
    return qn, t + xi[:, 3:]


def _window_cost(xi, q, t, anchor_h, valid, w_rot: float, w_xy: float, w_z: float):
    qn, tn = _apply_xi(xi, q, t)
    e_anchor = torch.einsum("ki,kij,kj->k", xi, anchor_h, xi)
    cost = torch.sum(torch.where(valid, e_anchor, torch.zeros_like(e_anchor)))

    pa = se3.Pose(q=qn[:-1], t=tn[:-1])
    pb = se3.Pose(q=qn[1:], t=tn[1:])
    rel = se3.pose_compose(se3.pose_inverse(pa), pb)  # [K-1]
    acc = se3.log_se3(
        se3.pose_compose(
            se3.pose_inverse(se3.Pose(q=rel.q[:-1], t=rel.t[:-1])),
            se3.Pose(q=rel.q[1:], t=rel.t[1:]),
        )
    )  # [K-2, 6]
    tri_ok = valid[:-2] & valid[1:-1] & valid[2:]
    sq = acc * acc
    e_cv = w_rot * sq[:, :3].sum(-1) + w_xy * sq[:, 3:5].sum(-1) + w_z * sq[:, 5]
    return cost + torch.sum(torch.where(tri_ok, e_cv, torch.zeros_like(e_cv)))


def smooth_window(
    q: torch.Tensor,  # [K,4] anchor quaternions (oldest..newest)
    t: torch.Tensor,  # [K,3]
    anchor_h: torch.Tensor,  # [K,6,6] scan-match information
    valid: torch.Tensor,  # [K]
    w_rot: float = 400.0,
    w_xy: float = 25.0,
    w_z: float = 100.0,
    iters: int = 3,
    damping: float = 1.0e-3,
):
    """Solve the windowed pose graph; returns corrected (q [K,4], t [K,3])."""
    kdim = q.shape[0] * 6

    def cost_flat(x):
        return _window_cost(x.reshape(-1, 6), q, t, anchor_h, valid, w_rot, w_xy, w_z)

    grad_f = grad(cost_flat)
    hess_f = hessian(cost_flat)
    eye = torch.eye(kdim, dtype=torch.float32, device=q.device)
    x = torch.zeros(kdim, dtype=torch.float32, device=q.device)
    for _ in range(iters):
        g = grad_f(x)
        h = hess_f(x)
        # Jacobi preconditioning: anchor information spans ~1e10 down to ~0,
        # beyond fp32 Cholesky's range unscaled.
        d = torch.sqrt(torch.clamp(torch.diagonal(h), min=1e-8))
        hn = h / d[:, None] / d[None, :] + damping * eye
        y = torch.cholesky_solve((g / d)[:, None], cholesky_or_nan(hn))[:, 0]
        x = x - y / d
    xi = x.reshape(-1, 6)
    xi = torch.where(valid[:, None], xi, torch.zeros_like(xi))  # never move invalid slots
    return _apply_xi(xi, q, t)


def smoothed_newest(pg_q, pg_t, pg_h, pg_valid, raw_pose: se3.Pose, pgc, max_correction_m: float = 1.0) -> se3.Pose:
    """Smooth the window and return the newest corrected pose; a non-finite
    or implausibly large correction falls back to the raw scan-match pose."""
    sm_q, sm_t = smooth_window(
        pg_q,
        pg_t,
        pg_h * pgc.anchor_scale,
        pg_valid,
        w_rot=pgc.w_rot,
        w_xy=pgc.w_xy,
        w_z=pgc.w_z,
        iters=pgc.iters,
        damping=pgc.damping,
    )
    nq, nt = sm_q[-1], sm_t[-1]
    fin_t = torch.isfinite(nt)
    fin_q = torch.isfinite(nq)
    ok = (
        fin_q.all()
        & fin_t.all()
        & (torch.linalg.vector_norm(torch.where(fin_t, nt - raw_pose.t, torch.full_like(nt, float("inf")))) < max_correction_m)
        & (torch.abs(torch.linalg.vector_norm(torch.where(fin_q, nq, torch.zeros_like(nq))) - 1.0) < 0.1)
    )
    return se3.Pose(q=torch.where(ok, nq, raw_pose.q), t=torch.where(ok, nt, raw_pose.t))


def push_window(wq, wt, wh, wvalid, q, t, h):
    """Shift the window left and append the newest (pose, information)."""
    return (
        torch.cat([wq[1:], q[None]], 0),
        torch.cat([wt[1:], t[None]], 0),
        torch.cat([wh[1:], h[None]], 0),
        torch.cat([wvalid[1:], torch.ones(1, dtype=torch.bool, device=wvalid.device)], 0),
    )
