"""Persistent feature-map state: the voxel map with persistence counters.

Port of ``pfilter_tpu/models/map_state.py``.  A map is one of two indexes,
by ``CapacityConfig.knn_impl``:

- ``"tiled"``: a :class:`~pfilter_tpu_torch.ops.knn_tiled.TiledMap` — point
  coords, (r, g) counters, validity mask, the kNN kernel's transposed
  coordinates and per-tile slot ranges — rebuilt every frame by one fused
  sort that serves both the rgbds re-voxelization and the kNN tile layout;
- ``"grid"``: a :class:`~pfilter_tpu_torch.ops.knn.HashGrid` sorted by 1 m
  cell id, queried by ``ops/knn.knn_query`` and merged by the unfused chain
  (crop, rgbds downsample, evict, age, re-sort).

Both expose ``.xyz``, ``.rg`` and ``.valid`` (ref addPointsToMap,
src/odomEstimationClass.cpp:589-647).  Any other ``knn_impl`` raises
``ValueError``.
"""

from __future__ import annotations

import torch

from pfilter_tpu_torch.config import PipelineConfig
from pfilter_tpu_torch.ops import knn, knn_tiled, voxel

LINE_KINDS = ("edge", "beam", "pillar")
PLANE_KINDS = ("surf", "facade")


def is_line_kind(kind: str) -> bool:
    if kind in LINE_KINDS:
        return True
    if kind in PLANE_KINDS:
        return False
    raise ValueError(f"unknown feature kind {kind}")


def is_tiled(cfg: PipelineConfig) -> bool:
    """True for the tiled index, False for the grid; raises on anything else."""
    impl = cfg.capacity.knn_impl
    if impl not in ("tiled", "grid"):
        raise ValueError(f"unknown knn_impl {impl!r} (expected 'tiled' or 'grid')")
    return impl == "tiled"


def _tile_params(cfg: PipelineConfig, kind: str):
    cap = cfg.capacity
    tile_cap = cap.edge_tile_cap if is_line_kind(kind) else cap.surf_tile_cap
    if kind in ("beam", "pillar") and cap.bpf_line_tile_cap:
        tile_cap = cap.bpf_line_tile_cap
    elif kind == "facade" and cap.bpf_plane_tile_cap:
        tile_cap = cap.bpf_plane_tile_cap
    return cap.knn_tiles, cap.tile_cells, tile_cap


def map_capacity(cfg: PipelineConfig, kind: str) -> int:
    c = cfg.capacity
    if kind in ("beam", "pillar") and c.bpf_line_map_points:
        return c.bpf_line_map_points
    if kind == "facade" and c.bpf_plane_map_points:
        return c.bpf_plane_map_points
    return c.edge_map_points if is_line_kind(kind) else c.surf_map_points


def build_index(xyz, rg, valid, pose_t, cfg: PipelineConfig, kind: str):
    """Build the per-frame index over map points (replaces the reference's
    per-frame KD-tree rebuild, src/odomEstimationClass.cpp:249-250)."""
    if is_tiled(cfg):
        nt, tc, tcap = _tile_params(cfg, kind)
        origin = knn_tiled.tile_origin_for_pose(pose_t, nt, tc)
        return knn_tiled.build_tiled(xyz, rg, valid, origin, nt, tc, tcap)
    cell = cfg.capacity.knn_cell_size
    return knn.build_grid(xyz, rg, valid, knn.grid_origin_for_pose(pose_t, cell), cell)


def empty_index(cfg: PipelineConfig, kind: str, rg_width: int = 2, device=None):
    """An empty map; ``rg_width=3`` adds the provenance channel (column 2: a
    mover-origin bit, max-merged per voxel like the counters)."""
    capacity = map_capacity(cfg, kind)
    return build_index(
        torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        torch.zeros((capacity, rg_width), dtype=torch.float32, device=device),
        torch.zeros(capacity, dtype=torch.bool, device=device),
        torch.zeros(3, dtype=torch.float32, device=device),
        cfg,
        kind,
    )


def sort_queries_for_index(index, q_xyz_world, q_valid, cfg: PipelineConfig, kind: str):
    """Tile-sort a query cloud once per frame (the tiled index; None for the
    grid): GN outer iterations refine the pose by far less than the halo
    margin, so the sort at the predicted pose holds for every iteration."""
    if not is_tiled(cfg):
        return None
    nt, tc, _ = _tile_params(cfg, kind)
    return knn_tiled.sort_queries(q_xyz_world, q_valid, index.origin, nt, tc)


def query_index_presorted(index, sq_xyz_world, bounds, cfg: PipelineConfig, kind: str):
    """5-NN for queries already in tile-sorted order (results in that order)."""
    nt, tc, tcap = _tile_params(cfg, kind)
    res = knn_tiled.query_tiled_sorted(index, sq_xyz_world, bounds, nt, tc, tcap, k=cfg.capacity.knn_k)
    return res.idx, res.sqdist


def query_index(index, q_xyz, q_valid, cfg: PipelineConfig, kind: str):
    """5-NN of each query against the index; returns (idx [Q,5], sqdist [Q,5])."""
    cap = cfg.capacity
    if not is_tiled(cfg):
        res = knn.knn_query(index, q_xyz, q_valid, cap.knn_k, cap.knn_candidates_per_cell)
        return res.idx, res.sqdist
    nt, tc, tcap = _tile_params(cfg, kind)
    res = knn_tiled.query_tiled(index, q_xyz, q_valid, nt, tc, tcap, k=cap.knn_k)
    return res.idx, res.sqdist


def empty_map(capacity: int, cell_size: float, device=None) -> knn.HashGrid:
    """An empty grid map anchored at the origin."""
    return knn.HashGrid(
        xyz=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        rg=torch.zeros((capacity, 2), dtype=torch.float32, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        cell_ids=torch.full((capacity,), knn.INVALID_ID, dtype=torch.int32, device=device),
        origin=knn.grid_origin_for_pose(torch.zeros(3, dtype=torch.float32, device=device), cell_size),
        cell_size=torch.full((), cell_size, dtype=torch.float32, device=device),
    )


def map_from_points(xyz, rg, valid, pose_t, capacity: int, cell_size: float) -> knn.HashGrid:
    """A grid map from raw feature points (ref ``initMapWithPoints``,
    src/odomEstimationClass.cpp:217-222: no downsampling, no filtering),
    padded to ``capacity``."""
    n = xyz.shape[0]
    if n > capacity:
        raise ValueError(f"init cloud ({n}) exceeds map capacity ({capacity})")
    pad = capacity - n
    xyz = torch.cat([xyz, xyz.new_zeros((pad, 3))])
    rg = torch.cat([rg, rg.new_zeros((pad, rg.shape[1]))])
    valid = torch.cat([valid, valid.new_zeros(pad)])
    return knn.build_grid(xyz, rg, valid, knn.grid_origin_for_pose(pose_t, cell_size), cell_size)


def tile_overflow_count(index, cfg: PipelineConfig, kind: str) -> torch.Tensor:
    """Map slots the kNN query cannot read: each query tile's halo is three
    3-tile rows capped at ``w = 3 * tile_cap`` slots, and this sums the
    excess over every (query tile, halo row) pair — 0 means every kNN read
    was complete.  The grid index has no such counter (0), as in the
    reference: its per-cell candidate cap is neither enforced nor counted."""
    if not is_tiled(cfg):
        return torch.zeros((), dtype=torch.int32, device=index.valid.device)
    nt, _, tcap = _tile_params(cfg, kind)
    return knn_tiled.halo_overflow(index, nt, 3 * tcap)


_FUSED_NZ = 1024  # z-voxel window (1024 * leaf meters, centered at the pose)
_INT32_MAX = 2**31 - 1


def _fused_merge_tiled(
    index: knn_tiled.TiledMap,
    scan_xyz_world,
    scan_rg,
    scan_valid,
    pose_t,
    leaf: float,
    cfg: PipelineConfig,
    kind: str,
    capacity: int | None = None,
):
    """Fused map merge: ONE sort on the packed ``(tile_id, local_voxel_id)``
    key serves both the rgbds re-voxelization (segment reduce per voxel) and
    the kNN tile layout (ascending key is tile-major).  Voxel boundaries are
    absolute multiples of ``leaf``; ``leaf`` must divide the tile size.
    Returns ``(TiledMap, n_voxel_dropped)``."""
    o = cfg.odometry
    nt, tc, tile_cap = _tile_params(cfg, kind)
    if capacity is None:
        capacity = map_capacity(cfg, kind)
    ts = float(tc)
    nvx = int(round(ts / leaf))
    if abs(nvx * leaf - ts) > 1e-6:
        raise ValueError(f"leaf {leaf} must divide tile size {ts}")
    nz = _FUSED_NZ
    if (nt * nt) * nvx * nvx * nz >= 2**31:
        raise ValueError("fused merge key exceeds int32")
    i32 = torch.int32

    origin = knn_tiled.tile_origin_for_pose(pose_t, nt, tc)
    xyz = torch.cat([index.xyz, scan_xyz_world], 0)
    rg = torch.cat([index.rg, scan_rg], 0)
    valid = torch.cat([index.valid, scan_valid], 0)
    # Crop (ref: src/odomEstimationClass.cpp:606-623); strictly inside the
    # tile window, so the tile clip below never binds.
    valid = valid & torch.all(torch.abs(xyz - pose_t) <= o.crop_half_extent, dim=-1)

    rel = xyz[:, :2] - origin[:2]
    t2 = torch.clamp(torch.floor(rel / ts).to(i32), 1, nt - 2)
    tid = t2[:, 0] * nt + t2[:, 1]
    # fp rounding near a shared tile/voxel boundary can push lxy one off: clip.
    lxy = torch.clamp(torch.floor(rel / leaf).to(i32) - t2 * nvx, 0, nvx - 1)
    # z window origin snapped to the leaf grid (absolute z voxel boundaries).
    zmin = torch.floor(pose_t[2] / leaf) * leaf - nz * leaf / 2.0
    lz = torch.clamp(torch.floor((xyz[:, 2] - zmin) / leaf).to(i32), 0, nz - 1)
    key = ((tid * nvx + lxy[:, 0]) * nvx + lxy[:, 1]) * nz + lz
    key = torch.where(valid, key, torch.full_like(key, _INT32_MAX))

    order = torch.argsort(key, stable=True)
    skey, sxyz, srg, sval = key[order], xyz[order], rg[order], valid[order]

    head = torch.ones_like(sval)
    head[1:] = skey[1:] != skey[:-1]
    seg = torch.cumsum(head.to(i32), 0, dtype=i32) - 1
    n_occupied = torch.amax(torch.where(sval, seg, torch.full_like(seg, -1))) + 1
    n_dropped = torch.clamp(n_occupied - capacity, min=0)
    centroid, out_rg, occupied, seg_l = voxel.segment_reduce_sorted(sxyz, srg, sval, seg, capacity)
    key_min = torch.full((capacity + 1,), _INT32_MAX, dtype=i32, device=xyz.device)
    key_min.scatter_reduce_(
        0, seg_l, torch.where(sval, skey, torch.full_like(skey, _INT32_MAX)), "amin", include_self=True
    )
    key_min = key_min[:capacity]

    # Persistence eviction + aging (ref: :631-646).
    keep = voxel.persistence_keep(out_rg, o.k_new, o.theta_p, o.theta_max)
    out_valid = occupied & keep
    r = out_rg[:, 0]
    r = torch.where(r > o.counter_cap - 5.0, torch.full_like(r, o.counter_cap), r + o.aging_increment)
    out_rg = out_rg.clone()
    out_rg[:, 0] = torch.where(out_valid, r, out_rg[:, 0])

    # Tile ranges straight from the keys: outputs are ascending-key, hence
    # ascending-tile; empty slots get the one-past-last tile id.
    out_tid = torch.where(occupied, key_min // (nvx * nvx * nz), torch.full_like(key_min, nt * nt))
    tile_start = knn_tiled._tile_range(out_tid, nt)
    # Evicted/empty slots sit at FAR in the kernel's copy (they still occupy
    # slot ranges — harmless).
    tmap = knn_tiled.TiledMap(
        xyz=centroid,
        rg=out_rg,
        valid=out_valid,
        xyz_t=knn_tiled.transposed_coords(centroid, out_valid, tile_cap),
        tile_start=tile_start,
        origin=origin,
    )
    return tmap, n_dropped


def merge_scan_into_index(index, scan_xyz_world, scan_rg, scan_valid, pose_t, leaf: float, cfg: PipelineConfig, kind: str, capacity: int | None = None):
    """Per-frame map update against either index (ref ``addPointsToMap``,
    src/odomEstimationClass.cpp:589-647): append the pose-transformed scan,
    crop +-100 m, rgbds re-voxelize (centroid + max r/g), evict, age, re-sort.
    The tiled index takes the fused merge; the grid the unfused chain, whose
    segment sums are ``voxel.segment_reduce_sorted``'s (sorted, no float
    atomics).  ``capacity`` overrides the config map capacity.
    Returns ``(index, n_voxel_dropped)``."""
    if is_tiled(cfg):
        return _fused_merge_tiled(index, scan_xyz_world, scan_rg, scan_valid, pose_t, leaf, cfg, kind, capacity=capacity)
    if capacity is None:
        capacity = map_capacity(cfg, kind)
    return _merge_unfused(index, scan_xyz_world, scan_rg, scan_valid, pose_t, leaf, cfg.odometry, capacity, cfg.capacity.knn_cell_size)


def _merge_unfused(grid: knn.HashGrid, scan_xyz_world, scan_rg, scan_valid, pose_t, leaf: float, ocfg, capacity: int, cell_size: float, anchored: bool = False):
    """The grid index's merge: append the pose-transformed scan, crop +-100 m
    around the pose, rgbds re-voxelize, evict non-persistent points, age the
    survivors, re-sort into the grid anchored at the pose.  ``ocfg`` is the
    OdometryConfig.  ``anchored`` re-voxelizes on the absolute voxel grid
    around the pose (``voxel.voxel_ids_anchored``), on which every map shard
    agrees.  Returns ``(HashGrid, n_voxel_dropped)``."""
    combined = voxel.concat_pointsets(
        voxel.PointSet(xyz=grid.xyz, rg=grid.rg, valid=grid.valid),
        voxel.PointSet(xyz=scan_xyz_world, rg=scan_rg, valid=scan_valid),
    )
    combined = voxel.crop_box(combined, pose_t, ocfg.crop_half_extent)
    ds, n_dropped = voxel.voxel_downsample_rgbds_counted(combined, leaf, out_cap=capacity, anchor_t=pose_t if anchored else None)
    ds = voxel.evict_unstable(ds, ocfg.k_new, ocfg.theta_p, ocfg.theta_max)
    ds = voxel.age_points(ds, ocfg.aging_increment, ocfg.counter_cap)
    return knn.build_grid(ds.xyz, ds.rg, ds.valid, knn.grid_origin_for_pose(pose_t, cell_size), cell_size), n_dropped


def merge_scan_into_map(grid: knn.HashGrid, scan_xyz_world, scan_rg, scan_valid, pose_t, leaf: float, ocfg, capacity: int, cell_size: float) -> knn.HashGrid:
    """Per-frame grid map update (ref ``addPointsToMap``,
    src/odomEstimationClass.cpp:589-647): :func:`_merge_unfused` without the
    overflow count."""
    return _merge_unfused(grid, scan_xyz_world, scan_rg, scan_valid, pose_t, leaf, ocfg, capacity, cell_size)[0]
