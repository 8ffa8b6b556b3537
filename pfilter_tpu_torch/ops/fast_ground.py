"""Fast ground filter (``GroundConfig.method = "fast"``), the form of
``groundSeg::fast_ground_filter`` (ref: src/preProcess.cpp:56-346).

Port of ``pfilter_tpu/ops/fast_ground.py``.  Over the simple grid
segmentation (``ops/ground.py``) it adds:

- an approximate mean-height prefilter: points above
  ``mean_z + max_ground_height`` skip the grid and are non-ground
  (ref: :140-156);
- per-grid reliability gating: a grid counts only with ``>= min_grid_pt_num``
  points and ``>= reliable_neighbor_thre`` populated 3x3 neighbours
  (ref: :212);
- distance-weighted downsampling: each grid keeps every ``rate``-th point by
  rank within the grid, ``rate`` scaled by ``standard_distance / dist`` to
  the power ``distance_weight_method`` (ref: :139-151, :214-226);
- height above ground of each non-ground point (ref: :259, :276);
- ground normals: (0, 0, 1), or the per-grid total-least-squares plane
  normal for methods 1-3 (ref: :296-321).

Everything is fixed-shape: one stable sort by grid id gives every point its
rank within its grid (a running max of run starts, ``torch.cummax``); grid
reductions write into ``G*G + 1`` rows whose last one takes the unbinned
points and is dropped.  Sums of the normals' moments use
``voxel.segment_add`` on the sorted grid ids, which sums each grid in a
fixed order on the card and on the CPU (no float atomics), so repeated runs
are bit-identical.  The scan's mean height and centroid are summed in float64
and rounded to float32, so they do not depend on the summation order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pfilter_tpu_torch.config import FastGroundConfig
from pfilter_tpu_torch.ops import eig3, voxel

_INVALID = 2**31 - 1
_BIG = 3.0e38
# Keep rates are clamped below 2^31 before the cast to int32 (only a grid
# whose nearest point lies within ~1 mm of the sensor reaches it).
_RATE_MAX = 2147483520.0


class FastGroundResult(NamedTuple):
    ground_mask: torch.Tensor  # [N] kept ground points (downsampled)
    ground_down_mask: torch.Tensor  # [N] further-downsampled ground subset
    nonground_mask: torch.Tensor  # [N] kept non-ground points (downsampled)
    normal: torch.Tensor  # [N, 3] ground normal per point (0 for non-ground)
    height_above_ground: torch.Tensor  # [N] z - grid min_z (non-ground points)


def _segment_sum(values, seg, n_seg: int):
    """Per-segment sums of ``values`` over sorted ``seg`` (row ``n_seg`` is
    the dump row and is dropped)."""
    out = torch.zeros((n_seg + 1,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return voxel.segment_add(out, seg, values)[:n_seg]


def _segment_min(values, seg, n_seg: int):
    """Per-segment minima; empty segments hold +inf (the reference's identity)."""
    out = torch.full((n_seg + 1,), float("inf"), dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, seg, values, "amin", include_self=True)
    return out[:n_seg]


def _up(rows: int, dev):
    """``rows`` copies of (0, 0, 1), built on the device (no host copy)."""
    up = torch.zeros((rows, 3), dtype=torch.float32, device=dev)
    up[:, 2] = 1.0
    return up


def _mean64(values, mask, count):
    """Masked mean summed in float64, rounded to float32."""
    total = torch.sum(torch.where(mask, values, torch.zeros_like(values)).to(torch.float64), dim=0)
    return (total / count).to(torch.float32)


def grid_layout(xyz: torch.Tensor, valid: torch.Tensor, cfg: FastGroundConfig):
    """``(mean_z, origin, gid)``: the approximate mean height from every
    100th point (ref: :90-99), the origin of the fixed ``G x G`` window
    centred at the valid points' centroid, and each point's grid id (the
    clip is done in float before the cast, which is undefined on CUDA out
    of range)."""
    g, res = cfg.num_cells, cfg.grid_resolution
    pm = ((torch.arange(xyz.shape[0], device=xyz.device) % 100) == 0) & valid
    mean_z = _mean64(xyz[:, 2], pm, torch.clamp(pm.sum(), min=1))
    center = _mean64(xyz, valid[:, None], torch.clamp(valid.sum(), min=1))
    origin = torch.floor(center[:2] / res) * res - (g // 2) * res
    c = torch.nan_to_num(torch.floor((xyz[:, :2] - origin) / res), nan=0.0)
    cxy = torch.clamp(c, 1, g - 2).to(torch.int32)
    return mean_z, origin, cxy[:, 0] * g + cxy[:, 1]


def fast_ground_filter(xyz: torch.Tensor, valid: torch.Tensor, cfg: FastGroundConfig) -> FastGroundResult:
    n = xyz.shape[0]
    dev = xyz.device
    g = cfg.num_cells
    res = cfg.grid_resolution
    ar = torch.arange(n, device=dev)
    z = xyz[:, 2]

    mean_z, origin, gid = grid_layout(xyz, valid, cfg)
    high_thre = mean_z + cfg.max_ground_height

    high = valid & (z > high_thre)
    binned = valid & ~high
    gid_b = torch.where(binned, gid, torch.full_like(gid, _INVALID))

    # Per-grid reductions over the sorted layout.
    order = torch.argsort(gid_b, stable=True)
    sgid = gid_b[order]
    sval = sgid != _INVALID
    seg = torch.where(sval, sgid, torch.full_like(sgid, g * g)).long()
    big = torch.full_like(z, _BIG)
    min_z = _segment_min(torch.where(sval, z[order], big), seg, g * g)
    pts_count = _segment_sum(sval.to(torch.int32), seg, g * g)
    dist = torch.sqrt(xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1] + xyz[:, 2] * xyz[:, 2])
    dist_grid = _segment_min(torch.where(sval, dist[order], big), seg, g * g)

    # Rank within grid (the reference's j index into grid.point_id).
    head = torch.ones_like(sval)
    head[1:] = sgid[1:] != sgid[:-1]
    run_start = torch.cummax(torch.where(head, ar, torch.zeros_like(ar)), 0).values
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = ar - run_start

    # 3x3 neighbour pass (ref: :170-186).
    pad_mz = torch.nn.functional.pad(min_z.reshape(g, g), (1, 1, 1, 1), value=_BIG)
    pad_rel = torch.nn.functional.pad((pts_count.reshape(g, g) >= cfg.min_grid_pt_num).to(torch.int32), (1, 1, 1, 1))
    neigh_min = torch.full((g, g), _BIG, dtype=torch.float32, device=dev)
    reliable = torch.zeros((g, g), dtype=torch.int32, device=dev)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            neigh_min = torch.minimum(neigh_min, pad_mz[1 + dr : 1 + dr + g, 1 + dc : 1 + dc + g])
            reliable = reliable + pad_rel[1 + dr : 1 + dr + g, 1 + dc : 1 + dc + g]
    neigh_min = neigh_min.reshape(-1)
    reliable = reliable.reshape(-1)

    # Distance-weighted keep rates (ref: :214-226): rate = dw^p * base + 1.
    p = cfg.distance_weight_method
    if p == 0:
        g_rate = torch.full((g * g,), cfg.ground_down_rate, dtype=torch.int64, device=dev)
        ng_rate = torch.full((g * g,), cfg.nonground_down_rate, dtype=torch.int64, device=dev)
    else:
        dw = cfg.standard_distance / (dist_grid + 1e-4)
        w = dw if p == 1 else dw * dw
        g_rate = torch.clamp(w * cfg.ground_down_rate + 1.0, max=_RATE_MAX).to(torch.int32).long()
        ng_rate = torch.clamp(w * cfg.nonground_down_rate + 1.0, max=_RATE_MAX).to(torch.int32).long()
    g_rate = torch.clamp(g_rate, min=1)
    ng_rate = torch.clamp(ng_rate, min=1)

    # Per-point classification (ref: :228-283).
    gid_l = gid.long()
    gmin = min_z[gid_l]
    gneigh = neigh_min[gid_l]
    grid_ok = (pts_count[gid_l] >= cfg.min_grid_pt_num) & (reliable[gid_l] >= cfg.reliable_neighbor_thre)
    grid_is_ground = (gmin - gneigh) < cfg.neighbor_height_diff
    near_floor = (z - gmin) < cfg.max_height_difference
    keep_g = (rank % g_rate[gid_l]) == 0
    keep_ng = (rank % ng_rate[gid_l]) == 0

    ground_mask = binned & grid_ok & grid_is_ground & near_floor & keep_g
    nong_inner = binned & grid_ok & grid_is_ground & ~near_floor & keep_ng
    nong_grid = binned & grid_ok & ~grid_is_ground & keep_ng
    nonground_mask = high | nong_inner | nong_grid

    hag = torch.where(high, z - (mean_z - 3.0), torch.where(nong_grid, z - gneigh, z - gmin))  # ref: :153
    hag = torch.where(nonground_mask, hag, torch.zeros_like(hag))

    # Ground normals (ref: :296-321).  Methods 1/2/3 -> per-grid TLS plane.
    up = _up(n, dev)
    if cfg.normal_method == 0:
        normal = torch.where(ground_mask[:, None], up, torch.zeros_like(up))
    else:
        # Moments about each grid's anchor (cell centre in xy, the grid's
        # min z): the same TLS plane as the reference's moments in sensor
        # coordinates, without their float32 cancellation (at 90 m it
        # exceeds the ground's vertical spread).
        cells = torch.arange(g * g, device=dev)
        anchor = torch.stack(
            [origin[0] + ((cells // g).to(torch.float32) + 0.5) * res, origin[1] + ((cells % g).to(torch.float32) + 0.5) * res, min_z], -1
        )
        w_ = ground_mask[order].to(torch.float32)
        sxyz = torch.where(ground_mask[order][:, None], xyz[order] - anchor[seg.clamp(max=g * g - 1)], torch.zeros_like(xyz))
        s1 = _segment_sum(w_, seg, g * g)
        sx = _segment_sum(sxyz * w_[:, None], seg, g * g)
        sxx = _segment_sum((sxyz[:, :, None] * sxyz[:, None, :]) * w_[:, None, None], seg, g * g)
        mean = sx / torch.clamp(s1, min=1.0)[:, None]
        cov = sxx - s1[:, None, None] * mean[:, None, :] * mean[:, :, None]
        _, nrm = eig3.eigh3_smallest(cov)
        nrm = torch.where(nrm[:, 2:3] < 0, -nrm, nrm)  # orient +z
        nrm = torch.where((s1 >= 3.0)[:, None], nrm, _up(g * g, dev))
        normal = torch.where(ground_mask[:, None], nrm[gid_l], torch.zeros_like(up))

    # Down-down sampling of the ground set (ref: :303-317): every
    # ground_down_down_rate-th kept ground point by rank, or a fixed count.
    if cfg.fixed_num_downsampling:
        grank = torch.empty(n, dtype=torch.int64, device=dev)
        grank[order] = torch.cumsum(ground_mask[order].to(torch.int64), 0) - 1
        stride = torch.clamp(ground_mask.sum() // max(cfg.down_fixed_num, 1), min=1)
        ground_down = ground_mask & ((grank % stride) == 0)
    else:
        ground_down = ground_mask & ((rank % (g_rate[gid_l] * cfg.ground_down_down_rate)) == 0)

    return FastGroundResult(
        ground_mask=ground_mask,
        ground_down_mask=ground_down,
        nonground_mask=nonground_mask,
        normal=normal,
        height_above_ground=hag,
    )


def tls_normals_float64(xyz, ground, gid):
    """The plain float64 reference the filter's TLS normals are held to (by
    the CPU tests and by the card check): for each ground point of numpy
    ``xyz`` [N,3] (mask ``ground``, grid ids ``gid`` from
    :func:`grid_layout`), the TLS normal of its grid's ground points
    (oriented +z), the grid's relative eigengap (lambda_1 - lambda_0) /
    trace, and whether the grid has at least 3 ground points.  Zero and
    False off the ground."""
    x, gg = xyz.astype(np.float64)[ground], gid[ground]
    _, inv = np.unique(gg, return_inverse=True)
    cnt = np.bincount(inv).astype(np.float64)
    mean = np.stack([np.bincount(inv, x[:, k]) for k in range(3)], 1) / cnt[:, None]
    r = x - mean[inv]
    cov = np.zeros((len(cnt), 3, 3))
    np.add.at(cov, inv, r[:, :, None] * r[:, None, :])
    w, v = np.linalg.eigh(cov)
    nrm = v[:, :, 0] * np.where(v[:, 2:3, 0] < 0, -1.0, 1.0)
    gap = (w[:, 1] - w[:, 0]) / np.maximum(w.sum(1), 1e-30)
    out_n, out_gap, out_ok = np.zeros((len(xyz), 3)), np.zeros(len(xyz)), np.zeros(len(xyz), bool)
    out_n[ground], out_gap[ground], out_ok[ground] = nrm[inv], gap[inv], (cnt >= 3)[inv]
    return out_n, out_gap, out_ok
