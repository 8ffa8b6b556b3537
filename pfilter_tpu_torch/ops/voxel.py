"""Voxel-grid operations: persistence-aware downsampling and the eviction
predicate.

Port of ``pfilter_tpu/ops/voxel.py``:

- :func:`voxel_downsample_rgbds_counted` (and :func:`voxel_downsample_rgbds`,
  which drops the overflow count) replaces ``pcl::VoxelGrid`` (scan
  downsampling, ref: src/odomEstimationClass.cpp:176-180) and the ``rgbds``
  map re-voxelizer (ref: :34-134) — per-voxel centroid with per-voxel
  **max** of the persistence counters (r = age, g = observation count);
- :func:`crop_box` replaces ``pcl::CropBox`` (ref: :606-623);
- :func:`persistence_keep` is ``extractstablepoint``'s predicate
  (ref: :7-25), and :func:`evict_unstable` applies it;
- :func:`age_points` is the per-frame ``r += 2`` aging with the 250/255 cap
  (ref: :634-646);
- :func:`voxel_ids_anchored` and :func:`spatial_hash` index absolute voxels
  (the anchored downsample and the map-sharding partition);
- :func:`empty_pointset` and :func:`concat_pointsets` build the fixed-capacity
  sets the global map and the unfused map merge use.

Everything is fixed-capacity: the voxel hash map is a stable sort by cell id
plus segment reductions.  Segment reductions write into ``cap + 1`` rows and
drop the last one: the reference's segment ops drop out-of-range segment ids
silently, ``index_add_``/``scatter_reduce`` would raise on them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_ID = 2**31 - 1
# Float voxel coordinates are clamped into this range before the cast to
# int32: a float -> int cast of a non-finite or far-away value is undefined on
# CUDA.  Every coordinate a real cloud gives lies far inside it.
_COORD_CLAMP = float(2**30)


class PointSet(NamedTuple):
    """A fixed-capacity masked point cloud with persistence counters."""

    xyz: torch.Tensor  # [N, 3] float32
    rg: torch.Tensor  # [N, W] float32 — (r = age rounds, g = observations, ...)
    valid: torch.Tensor  # [N] bool


def empty_pointset(capacity: int, device=None) -> PointSet:
    return PointSet(
        xyz=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        rg=torch.zeros((capacity, 2), dtype=torch.float32, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def concat_pointsets(a: PointSet, b: PointSet) -> PointSet:
    """Concatenate two fixed-capacity sets (result capacity = sum)."""
    return PointSet(
        xyz=torch.cat([a.xyz, b.xyz], 0),
        rg=torch.cat([a.rg, b.rg], 0),
        valid=torch.cat([a.valid, b.valid], 0),
    )


def voxel_ids_dynamic(xyz: torch.Tensor, valid: torch.Tensor, leaf: float) -> torch.Tensor:
    """Linear voxel ids on a grid anchored at the cloud minimum, mirroring
    rgbds' min_b_/divb_mul_ indexing (ref: src/odomEstimationClass.cpp:43-70).
    Invalid points get a sentinel id that sorts last.

    Ids are packed in int32.  Over the map merge's +-100 m crop the grid is
    at most 501 voxels per axis at the 0.4 m leaf (251 at 0.8 m), so the
    largest id, 501^3 ~ 1.26e8, stays well below 2^31."""
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


def _voxel_coords(xyz: torch.Tensor, leaf: float) -> torch.Tensor:
    """``floor(xyz / leaf)`` as int32, clamped in float first (``_COORD_CLAMP``;
    NaN goes to 0, as the reference's saturating cast gives)."""
    c = torch.nan_to_num(torch.floor(xyz / leaf), nan=0.0)
    return torch.clamp(c, -_COORD_CLAMP, _COORD_CLAMP).to(torch.int32)


def voxel_ids_anchored(xyz: torch.Tensor, valid: torch.Tensor, leaf: float, anchor_t: torch.Tensor) -> torch.Tensor:
    """Voxel ids on an absolute grid (boundaries at integer multiples of
    ``leaf``), packed relative to a 512^3 window centred at ``anchor_t``.
    Unlike :func:`voxel_ids_dynamic` the decomposition does not depend on
    which points are present (the sharded map needs every shard to agree on
    voxel boundaries).  Points outside the window get the sentinel id."""
    base = _voxel_coords(anchor_t, leaf) - 256
    ijk = _voxel_coords(xyz, leaf) - base
    in_window = torch.all((ijk >= 0) & (ijk < 512), dim=-1)
    ijk = torch.clamp(ijk, 0, 511)
    ids = ijk[:, 0] * (512 * 512) + ijk[:, 1] * 512 + ijk[:, 2]
    return torch.where(valid & in_window, ids, torch.full_like(ids, INVALID_ID))


def spatial_hash(xyz: torch.Tensor, leaf: float) -> torch.Tensor:
    """Frame-invariant XOR-of-primes hash of absolute voxel coordinates (int32
    products wrap, as the reference's).  A partition function for map
    sharding only: collisions are harmless there."""
    ijk = _voxel_coords(xyz, leaf)
    h = (ijk[:, 0] * 73856093) ^ (ijk[:, 1] * 19349663) ^ (ijk[:, 2] * 83492791)
    return h & 0x7FFFFFFF


def segment_add(out: torch.Tensor, seg: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out[seg] += values`` in place, rows of a repeated ``seg`` summed in
    the order they come, on any device and any number of threads: runs are
    bit-identical.  On CUDA, ``index_put_`` with accumulate (a sort-based
    kernel, no float atomics); on the CPU, ``index_add_``, a serial loop,
    since there ``index_put_`` adds float rows with atomics from several
    threads once the work passes PyTorch's grain size."""
    if out.device.type == "cpu":
        return out.index_add_(0, seg, values)
    return out.index_put_((seg,), values, accumulate=True)


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
    cnt = segment_add(torch.zeros(cap + 1, dtype=torch.float32, device=sxyz.device), seg, ones)
    sums = segment_add(torch.zeros(cap + 1, 3, dtype=torch.float32, device=sxyz.device), seg, sxyz * ones[:, None])
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


def voxel_downsample_rgbds_counted(points: PointSet, leaf: float, out_cap: int, anchor_t=None):
    """Per-voxel centroid + max-r + max-g downsample (ref rgbds,
    src/odomEstimationClass.cpp:34-134), on the cloud-min grid or, given
    ``anchor_t``, on the absolute grid of :func:`voxel_ids_anchored`.

    Output is compacted: valid voxels occupy the first ``count`` slots, in
    ascending voxel-id order; voxels beyond ``out_cap`` are dropped.
    Returns ``(PointSet, n_dropped)`` with ``n_dropped`` the count of occupied
    voxels that did not fit (a 0-dim int tensor, never read on the host here)."""
    if anchor_t is None:
        ids = voxel_ids_dynamic(points.xyz, points.valid, leaf)
    else:
        ids = voxel_ids_anchored(points.xyz, points.valid, leaf, anchor_t)
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


def voxel_downsample_rgbds(points: PointSet, leaf: float, out_cap: int, anchor_t=None) -> PointSet:
    """See :func:`voxel_downsample_rgbds_counted`; drops the overflow count."""
    return voxel_downsample_rgbds_counted(points, leaf, out_cap, anchor_t)[0]


def crop_box(points: PointSet, center: torch.Tensor, half_extent: float) -> PointSet:
    """Keep points within a cube of +-half_extent around ``center``
    (ref: src/odomEstimationClass.cpp:606-623, +-100 m around the pose)."""
    inside = torch.all(torch.abs(points.xyz - center) <= half_extent, dim=-1)
    return points._replace(valid=points.valid & inside)


def persistence_keep(rg: torch.Tensor, k_new: float, theta_p: float, theta_max: float) -> torch.Tensor:
    """The persistence predicate of ``extractstablepoint``
    (ref: src/odomEstimationClass.cpp:12-13): evict iff
    ``g < r*theta_p && r > k_new && g < theta_max + 1``.  Returns keep mask."""
    r, g = rg[..., 0], rg[..., 1]
    evict = (g < r * theta_p) & (r > k_new) & (g < theta_max + 1.0)
    return ~evict


def evict_unstable(points: PointSet, k_new: float, theta_p: float, theta_max: float) -> PointSet:
    return points._replace(valid=points.valid & persistence_keep(points.rg, k_new, theta_p, theta_max))


def age_points(points: PointSet, increment: float = 2.0, cap: float = 255.0) -> PointSet:
    """Per-frame aging of the valid points: ``r = r > 250 ? 255 : r + 2``
    (ref: src/odomEstimationClass.cpp:634-646)."""
    r = points.rg[:, 0]
    aged = torch.where(r > cap - 5.0, torch.full_like(r, cap), r + increment)
    rg = points.rg.clone()
    rg[:, 0] = torch.where(points.valid, aged, r)
    return points._replace(rg=rg)
