"""Dynamic Curved-Voxel Clustering (DCVC; ref ``curvedVoxel``,
src/additionClass.cpp:60-500, config/config.yaml:49-54).

Port of ``pfilter_tpu/ops/dcvc.py``.  Points go to polar voxels (pitch,
azimuth, range) whose radial bins follow the reference's recurrence
(``range += startR - step*deltaR``, ref :126-133); the reference's sequential
flood fill over the 3x3x3 polar neighbourhood (ref :221-317) becomes
iterated min-label propagation on a dense ``[pitch, azimuth, range]`` grid:
every occupied voxel starts with its own linear id, and each of
``max_iters`` rounds takes the minimum over its occupied 3x3x3 neighbourhood
(azimuth wraps, pitch and range clamp at the edges).  Labels are then
connected-component minima, the reference's partition; clusters of at most
``min_seg`` points are dropped (ref :324-360).

The voxel scatter writes into one spare pitch slab (invalid points), sliced
off afterwards; cluster sizes are counted onto each label's root voxel with
an int32 ``index_put_`` (exact, order-free).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pfilter_tpu_torch.config import DCVCConfig, LidarConfig

_BIG = 2**30


class DCVCResult(NamedTuple):
    label: torch.Tensor  # [N] int32 cluster label (voxel-id minima); -1 = invalid
    cluster_size: torch.Tensor  # [N] int32 — size of the point's cluster
    keep: torch.Tensor  # [N] bool — valid & cluster_size > minSeg
    n_iters: int = 0  # kept for the reference's API; always its default
    n_vox_dropped: int = 0


def polar_bounds(cfg: DCVCConfig, lidar: LidarConfig, max_bins: int = 256) -> np.ndarray:
    """Static radial bin bounds via the reference's recurrence
    (ref: src/additionClass.cpp:126-133) anchored at the sensor min range."""
    bounds = []
    rng = lidar.min_distance
    step = 1
    while rng <= lidar.max_distance and len(bounds) < max_bins:
        rng += cfg.start_r - step * cfg.delta_r
        bounds.append(rng)
        step += 1
    while len(bounds) < max_bins:  # pad to the static table length
        bounds.append(bounds[-1] if bounds else lidar.max_distance)
    return np.asarray(bounds, np.float32)


def _grid_dims(cfg: DCVCConfig, lidar: LidarConfig, max_polar: int = 256):
    n_az = int(round(360.0 / cfg.delta_a)) + 1
    # Static pitch window: generous band covering 16/32/64-beam sensors.
    pitch_min, pitch_max = -30.0, 15.0
    n_pitch = int(np.ceil((pitch_max - pitch_min) / cfg.delta_p)) + 1
    return n_pitch, n_az, max_polar, pitch_min


@functools.lru_cache(maxsize=8)
def _bounds_on(cfg: DCVCConfig, lidar: LidarConfig, max_bins: int, device: torch.device) -> torch.Tensor:
    """The bounds table on ``device``, copied there once (a copy from host
    memory inside the step would make the host wait)."""
    return torch.from_numpy(polar_bounds(cfg, lidar, max_bins)).to(device)


def _shift_min(x: torch.Tensor, dim: int, wrap: bool) -> torch.Tensor:
    """Min of each cell and its two neighbours along ``dim``."""
    if wrap:
        lo, hi = torch.roll(x, 1, dim), torch.roll(x, -1, dim)
    else:
        n = x.shape[dim]
        lo = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        hi = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    return torch.minimum(x, torch.minimum(lo, hi))


def _pool(a: torch.Tensor) -> torch.Tensor:
    """3x3x3 min; azimuth wraps, pitch and range clamp."""
    return _shift_min(_shift_min(_shift_min(a, 0, False), 1, True), 2, False)


def cluster(
    xyz: torch.Tensor,
    valid: torch.Tensor,
    cfg: DCVCConfig,
    lidar: LidarConfig,
    max_polar_bins: int = 256,
) -> DCVCResult:
    n_pitch, n_az, n_polar, pitch_min = _grid_dims(cfg, lidar, max_polar_bins)
    dev = xyz.device
    bounds = _bounds_on(cfg, lidar, max_polar_bins, dev)

    # Polar conversion (ref convertToPolar, :81-118).
    r = torch.linalg.vector_norm(xyz, dim=-1)
    ok = valid & (r > lidar.min_distance) & (r < lidar.max_distance)
    safe_r = torch.clamp(r, min=1e-6)
    pitch = torch.rad2deg(torch.asin(torch.clamp(xyz[:, 2] / safe_r, -1.0, 1.0)))
    az = torch.rad2deg(torch.atan2(xyz[:, 1], xyz[:, 0]))
    az = torch.where(az < 0, az + 360.0, az)

    ip = torch.clamp(torch.round((pitch - pitch_min) / cfg.delta_p).to(torch.int32), 0, n_pitch - 1)
    ia = torch.clamp(torch.round(az / cfg.delta_a).to(torch.int32), 0, n_az - 1)
    ir = torch.clamp(torch.searchsorted(bounds, r, right=True).to(torch.int32), 0, n_polar - 1)

    # Dense occupancy (spare pitch slab n_pitch for invalid points).
    lin = (ip * n_az + ia) * n_polar + ir
    sp = torch.where(ok, ip, torch.full_like(ip, n_pitch))
    flat = ((sp * n_az + ia) * n_polar + ir).long()
    vox = torch.full(((n_pitch + 1) * n_az * n_polar,), _BIG, dtype=torch.int32, device=dev)
    vox.scatter_reduce_(0, flat, torch.where(ok, lin, torch.full_like(lin, _BIG)), "amin", include_self=True)
    vox = vox[: n_pitch * n_az * n_polar].reshape(n_pitch, n_az, n_polar)

    # Iterated min-pool over occupied voxels (a fixed count, no host test).
    occupied = vox < _BIG
    big = torch.full_like(vox, _BIG)
    labels = vox
    for _ in range(cfg.max_iters):
        labels = torch.where(occupied, _pool(labels), big)

    # Per-point label and cluster size, counted onto each label's root voxel.
    n_vox = n_pitch * n_az * n_polar
    gather = torch.where(ok, flat, torch.zeros_like(flat))
    plabel = torch.where(ok, labels.reshape(-1)[gather], torch.full_like(lin, _BIG))
    root = torch.where(ok, plabel, torch.full_like(plabel, n_vox)).long()
    counts = torch.zeros(n_vox + 1, dtype=torch.int32, device=dev)
    counts.index_put_((root,), ok.to(torch.int32), accumulate=True)
    csize = torch.where(ok, counts[torch.where(ok, root, torch.zeros_like(root))], torch.zeros_like(lin))

    keep = ok & (csize > cfg.min_seg)
    return DCVCResult(label=torch.where(ok, plabel, torch.full_like(plabel, -1)), cluster_size=csize, keep=keep)
