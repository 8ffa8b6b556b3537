"""Trajectory evaluation: KITTI odometry drift protocol and ATE.

The port's own numpy copy of ``pfilter_tpu/utils/metrics.py``'s
``poses_to_matrices``, ``trajectory_distances``, ``kitti_drift`` and
``ate_rmse`` (the in-repo replacement for the external
``KITTI_odometry_evaluation_tool``, ref: runkitti.py:111-157): average
translational drift (%) and rotational drift (deg/m) over subsequences of
fixed lengths, evaluated every ``step`` frames.
"""

from __future__ import annotations

import numpy as np

KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def poses_to_matrices(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """wxyz quaternions [N,4] + translations [N,3] -> [N,4,4] transforms."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    m = np.zeros((len(q), 4, 4), np.float64)
    m[:, 0, 0] = 1 - 2 * (y * y + z * z)
    m[:, 0, 1] = 2 * (x * y - w * z)
    m[:, 0, 2] = 2 * (x * z + w * y)
    m[:, 1, 0] = 2 * (x * y + w * z)
    m[:, 1, 1] = 1 - 2 * (x * x + z * z)
    m[:, 1, 2] = 2 * (y * z - w * x)
    m[:, 2, 0] = 2 * (x * z - w * y)
    m[:, 2, 1] = 2 * (y * z + w * x)
    m[:, 2, 2] = 1 - 2 * (x * x + y * y)
    m[:, :3, 3] = t
    m[:, 3, 3] = 1.0
    return m


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative path length at each frame."""
    d = np.zeros(len(poses))
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    d[1:] = np.cumsum(steps)
    return d


def _last_frame_from_len(dist, first, length):
    target = dist[first] + length
    idx = np.searchsorted(dist, target)
    return idx if idx < len(dist) else -1


def kitti_drift(
    gt: np.ndarray, est: np.ndarray, lengths=KITTI_LENGTHS, step: int = 10
) -> dict:
    """KITTI odometry error: for each start frame (every ``step``) and each
    segment length, compare relative transforms; report average translational
    error (%) and rotational error (deg/m)."""
    if gt.shape != est.shape:
        raise ValueError(f"trajectory shapes differ: {gt.shape} vs {est.shape}")
    dist = trajectory_distances(gt)
    t_errs, r_errs = [], []
    for first in range(0, len(gt), step):
        for length in lengths:
            last = _last_frame_from_len(dist, first, length)
            if last < 0:
                continue
            gt_rel = np.linalg.inv(gt[first]) @ gt[last]
            est_rel = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(est_rel) @ gt_rel
            t_err = np.linalg.norm(err[:3, 3]) / length
            a = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1.0, 1.0)
            r_err = np.degrees(np.arccos(a)) / length
            t_errs.append(t_err)
            r_errs.append(r_err)
    if not t_errs:
        return {"t_err_pct": float("nan"), "r_err_deg_per_m": float("nan"), "n_segments": 0}
    return {
        "t_err_pct": float(np.mean(t_errs) * 100.0),
        "r_err_deg_per_m": float(np.mean(r_errs)),
        "n_segments": len(t_errs),
    }


def ate_rmse(gt: np.ndarray, est: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of translations, no alignment —
    trajectories share the identity start frame)."""
    d = gt[:, :3, 3] - est[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))
