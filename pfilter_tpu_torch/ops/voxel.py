"""Voxel-grid operations: persistence-aware downsampling and the eviction
predicate.

Port of ``pfilter_tpu/ops/voxel.py``:

- :func:`voxel_downsample_rgbds_counted` (and :func:`voxel_downsample_rgbds`,
  which drops the overflow count) replaces ``pcl::VoxelGrid`` (scan
  downsampling, ref: src/odomEstimationClass.cpp:176-180) and the ``rgbds``
  map re-voxelizer (ref: :34-134) — per-voxel centroid with per-voxel
  **max** of the persistence counters (r = age, g = observation count);
- :func:`persistence_keep` is ``extractstablepoint``'s predicate
  (ref: :7-25).

Everything is fixed-capacity: the voxel hash map is a stable sort by cell id
plus segment reductions.  Segment reductions write into ``cap + 1`` rows and
drop the last one: the reference's segment ops drop out-of-range segment ids
silently, ``index_add_``/``scatter_reduce`` would raise on them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_ID = 2**31 - 1


class PointSet(NamedTuple):
    """A fixed-capacity masked point cloud with persistence counters."""

    xyz: torch.Tensor  # [N, 3] float32
    rg: torch.Tensor  # [N, W] float32 — (r = age rounds, g = observations, ...)
    valid: torch.Tensor  # [N] bool


def voxel_ids_dynamic(xyz: torch.Tensor, valid: torch.Tensor, leaf: float) -> torch.Tensor:
    """Linear voxel ids on a grid anchored at the cloud minimum, mirroring
    rgbds' min_b_/divb_mul_ indexing (ref: src/odomEstimationClass.cpp:43-70).
    Invalid points get a sentinel id that sorts last."""
    big = 3.0e38
    v = valid[:, None]
    min_b = torch.floor(torch.amin(torch.where(v, xyz, big), dim=0) / leaf)
    max_b = torch.floor(torch.amax(torch.where(v, xyz, -big), dim=0) / leaf)
    any_valid = valid.any()
    min_b = torch.where(any_valid, min_b, torch.zeros_like(min_b))
    max_b = torch.where(any_valid, max_b, torch.zeros_like(max_b))
    div = (max_b - min_b + 1.0).to(torch.int32)
    ijk = (torch.floor(xyz / leaf) - min_b).to(torch.int32)
    ids = ijk[:, 0] + div[0] * (ijk[:, 1] + div[1] * ijk[:, 2])
    return torch.where(valid, ids, torch.full_like(ids, INVALID_ID))


def segment_reduce_sorted(sxyz, srg, svalid, seg, cap: int):
    """Centroid, counter max and occupancy of ``cap`` segments.

    ``seg`` [N] holds each sorted point's segment; invalid points and
    segments at or beyond ``cap`` go to a dump row that is dropped.
    Returns ``(centroid [cap,3], rg [cap,W], occupied [cap], seg [N])`` with
    ``seg`` the int64 row each point was reduced into (``cap`` = dropped)."""
    keep = svalid & (seg < cap)
    seg = torch.where(keep, seg, torch.full_like(seg, cap)).long()
    ones = svalid.to(torch.float32)
    w = srg.shape[1]
    # On CUDA, index_put_ with accumulate sums each segment in sorted order
    # (a sort-based kernel, no float atomics), so runs are bit-identical.
    cnt = torch.zeros(cap + 1, dtype=torch.float32, device=sxyz.device)
    cnt.index_put_((seg,), ones, accumulate=True)
    sums = torch.zeros(cap + 1, 3, dtype=torch.float32, device=sxyz.device)
    sums.index_put_((seg,), sxyz * ones[:, None], accumulate=True)
    rg_max = torch.zeros(cap + 1, w, dtype=torch.float32, device=sxyz.device)
    rg_max.scatter_reduce_(
        0,
        seg[:, None].expand(-1, w),
        torch.where(svalid[:, None], srg, torch.full_like(srg, -float("inf"))),
        "amax",
        include_self=False,
    )
    cnt, sums, rg_max = cnt[:cap], sums[:cap], rg_max[:cap]
    occupied = cnt > 0
    centroid = sums / torch.clamp(cnt, min=1.0)[:, None]
    rg = torch.where(occupied[:, None], rg_max, torch.zeros_like(rg_max))
    return centroid, rg, occupied, seg


def voxel_downsample_rgbds_counted(points: PointSet, leaf: float, out_cap: int):
    """Per-voxel centroid + max-r + max-g downsample (ref rgbds,
    src/odomEstimationClass.cpp:34-134).

    Output is compacted: valid voxels occupy the first ``count`` slots, in
    ascending voxel-id order; voxels beyond ``out_cap`` are dropped.
    Returns ``(PointSet, n_dropped)`` with ``n_dropped`` the count of occupied
    voxels that did not fit (a 0-dim int tensor, never read on the host here)."""
    ids = voxel_ids_dynamic(points.xyz, points.valid, leaf)
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    sxyz = points.xyz[order]
    srg = points.rg[order]
    svalid = points.valid[order]

    head = torch.ones_like(svalid)
    head[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32) - 1
    n_occupied = torch.amax(torch.where(svalid, seg, torch.full_like(seg, -1))) + 1
    n_dropped = torch.clamp(n_occupied - out_cap, min=0)
    centroid, rg, occupied, _ = segment_reduce_sorted(sxyz, srg, svalid, seg, out_cap)
    return PointSet(xyz=centroid, rg=rg, valid=occupied), n_dropped


def voxel_downsample_rgbds(points: PointSet, leaf: float, out_cap: int) -> PointSet:
    """See :func:`voxel_downsample_rgbds_counted`; drops the overflow count."""
    return voxel_downsample_rgbds_counted(points, leaf, out_cap)[0]


def persistence_keep(rg: torch.Tensor, k_new: float, theta_p: float, theta_max: float) -> torch.Tensor:
    """The persistence predicate of ``extractstablepoint``
    (ref: src/odomEstimationClass.cpp:12-13): evict iff
    ``g < r*theta_p && r > k_new && g < theta_max + 1``.  Returns keep mask."""
    r, g = rg[..., 0], rg[..., 1]
    evict = (g < r * theta_p) & (r > k_new) & (g < theta_max + 1.0)
    return ~evict
