"""BPF (beam + pillar + facade) scan-to-map odometry.

Port of ``pfilter_tpu/models/bpf_odometry.py`` (ref
``Odom_BPF_EstimationClass``, src/odomEstimationClass.cpp:649-1306), both
outer loops (``assoc_once``) and both indexes (``knn_impl``).  The skeleton
is the ES step's (``models/es_odometry.py``) with three feature maps: beam and pillar use the point-to-line cost, facade the point-to-plane
cost (ref :736-738); each map keeps its own persistence counters, rgbds
re-voxelization (facade at 2x leaf, ref :1262-1264) and eviction/aging.
``merged_map`` mirrors ``mergeFeatures`` (ref :1297-1306).

As in the ES port, ``opt_count`` is a Python int (a function of the frame
index) and the outer loop a Python loop; the device-valued map-size gate
(ref :722, beam > 10 and pillar > 10 and facade > 50) selects between the
loop's result and the zero-iteration result with ``torch.where``, so the step
never waits on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pfilter_tpu_torch.config import PipelineConfig
from pfilter_tpu_torch.models import map_state
from pfilter_tpu_torch.models.es_odometry import (
    _add_g,
    _associate_static,
    _compact_idx,
    _g_increment,
    _outer_per_iter,
    _regate,
    _reorder,
    _scan_writeback,
    _weights_from,
    guard_and_window,
)
from pfilter_tpu_torch.ops import gauss_newton as gn
from pfilter_tpu_torch.ops import se3, voxel

CHANNELS = ("beam", "pillar", "facade")


class BPFState(NamedTuple):
    beam_map: object  # knn_tiled.TiledMap | knn.HashGrid (CapacityConfig.knn_impl)
    pillar_map: object
    facade_map: object
    pose: se3.Pose
    last_pose: se3.Pose
    opt_count: int  # outer iterations of the last frame (a function of the frame index)
    pg_q: torch.Tensor  # [K,4] pose-graph window (ops/pose_graph.py)
    pg_t: torch.Tensor  # [K,3]
    pg_h: torch.Tensor  # [K,6,6]
    pg_valid: torch.Tensor  # [K]


class BPFDiag(NamedTuple):
    n_corr: torch.Tensor  # [3] per-channel correspondence counts
    map_sizes: torch.Tensor  # [3]
    dropped: torch.Tensor  # device-side corrupt-frame guard fired
    # [3, 4] int32 per-channel overflow counters:
    # [compact_over, ds_voxel_over, merge_voxel_over, tile_cap_over]
    overflow: torch.Tensor


def init_state(cfg: PipelineConfig, device=None) -> BPFState:
    k = cfg.pose_graph.window
    maps = {kind: map_state.empty_index(cfg, kind, device=device) for kind in CHANNELS}
    return BPFState(
        beam_map=maps["beam"],
        pillar_map=maps["pillar"],
        facade_map=maps["facade"],
        pose=se3.identity_pose(device),
        last_pose=se3.identity_pose(device),
        opt_count=cfg.odometry.max_outer_iters,
        pg_q=torch.tensor([1.0, 0, 0, 0], device=device).repeat(k, 1),
        pg_t=torch.zeros((k, 3), dtype=torch.float32, device=device),
        pg_h=torch.zeros((k, 6, 6), dtype=torch.float32, device=device),
        pg_valid=torch.zeros(k, dtype=torch.bool, device=device),
    )


def _leaf(cfg: PipelineConfig, kind: str) -> float:
    # beam/pillar at map_resolution, facade at 2x (ref: :658-660, :1262-1264).
    return cfg.odometry.map_resolution * (2.0 if kind == "facade" else 1.0)


def _compact_cap(cfg: PipelineConfig, kind: str) -> int:
    cap = cfg.capacity
    return cap.edge_points if map_state.is_line_kind(kind) else (cap.bpf_plane_points or cap.surf_points)


def first_frame(state: BPFState, xyz, masks, cfg: PipelineConfig) -> BPFState:
    """Seed the three maps with the first scan's classified features (ref
    ``initMapWithPoints``, src/odomEstimationClass.cpp:689-695), rgbds-voxelized
    at the channel leaf first, as the reference package does (a raw dense seed
    would overflow near-sensor kNN tiles for one frame)."""
    new_maps = {}
    for kind in CHANNELS:
        comp_cap = _compact_cap(cfg, kind)
        cxyz, cvalid, _ = _compact_idx(xyz, masks[kind], comp_cap)
        seed = voxel.voxel_downsample_rgbds(
            voxel.PointSet(cxyz, torch.zeros((comp_cap, 2), dtype=torch.float32, device=xyz.device), cvalid),
            _leaf(cfg, kind),
            map_state.map_capacity(cfg, kind),
        )
        new_maps[kind] = map_state.build_index(seed.xyz, seed.rg, seed.valid, state.pose.t, cfg, kind)
    return state._replace(
        beam_map=new_maps["beam"],
        pillar_map=new_maps["pillar"],
        facade_map=new_maps["facade"],
        opt_count=cfg.odometry.max_outer_iters,
    )


def _bpf_outer_assoc_once(cfg, opt_count: int, enough, pose0, center, grids, ds, bounds):
    """Hoisted-association outer loop over three channels: one kNN, gather,
    fit and persistence pass per channel per frame; iterations re-gate the
    cached neighbours and re-run GN (see es_odometry._es_outer_assoc_once for
    the counter semantics).  ``enough`` selects the loop's result or the
    zero-iteration result."""
    o = cfg.odometry
    k = cfg.capacity.knn_k
    dev = center.device
    st = {
        kind: _associate_static(kind, grids[kind], grids[kind].rg, pose0, center, ds[kind].xyz, ds[kind].valid, cfg, bounds[kind])
        for kind in CHANNELS
    }
    zeros = {kind: torch.zeros(ds[kind].xyz.shape[0], dtype=torch.bool, device=dev) for kind in CHANNELS}
    m0s, matches, vcs = dict(zeros), dict(zeros), dict(zeros)
    pose_l = pose0
    h = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    for it in range(opt_count):
        gate_sq = o.nn_gate_wide_sq if it == 0 else o.nn_gate_sq
        for kind in CHANNELS:
            matches[kind], vcs[kind] = _regate(st[kind], pose_l, ds[kind].xyz, gate_sq)
        if it == 0:
            m0s = dict(matches)
        factors = [
            gn.Correspondences(
                "edge" if map_state.is_line_kind(kind) else "surf",
                ds[kind].xyz,
                st[kind].geom_a,
                st[kind].geom_b,
                _weights_from(st[kind].observe, st[kind].sparsity, vcs[kind], o.weight_type),
                vcs[kind],
            )
            for kind in CHANNELS
        ]
        for _ in range(o.inner_gn_iters):
            pose_l, (h, _b) = gn.gn_iteration(pose_l, factors, o.huber_delta, o.gn_damping)

    q = torch.where(enough, pose_l.q, pose0.q)
    t_l = torch.where(enough, pose_l.t, pose0.t)
    h_fin = torch.where(enough, h, torch.zeros_like(h))
    scale_rest = float(max(opt_count - 1, 0))
    rgs, scan_rgs, counts = [], [], []
    for kind in CHANNELS:
        m0, m_fin, vc = m0s[kind] & enough, matches[kind] & enough, vcs[kind] & enough
        grid_rg = grids[kind].rg
        inc = _g_increment(grid_rg.shape[0], st[kind].nn_idx, m0.float() + scale_rest * m_fin.float(), k)
        rgs.append(_add_g(grid_rg, inc, o.counter_cap))
        scan_rgs.append(_scan_writeback(st[kind].round_, st[kind].observe, ds[kind].rg, (m0 & st[kind].pers_ok) | vc, o))
        counts.append(vc.sum())
    return q, t_l, h_fin, rgs, scan_rgs, torch.stack(counts)


def _bpf_outer_per_iter(cfg, opt_count: int, enough, pose0, center, grids, ds, bounds):
    """es_odometry._outer_per_iter over the three channels (ref:
    src/odomEstimationClass.cpp:722-760), returning what
    :func:`_bpf_outer_assoc_once` returns."""
    q, t_l, h, rgs, scan_rgs, counts = _outer_per_iter(cfg, opt_count, enough, pose0, center, grids, ds, bounds)
    return q, t_l, h, [rgs[k] for k in CHANNELS], [scan_rgs[k] for k in CHANNELS], torch.stack([counts[k] for k in CHANNELS])


class _Frame(NamedTuple):
    """What a BPF frame registers: each channel's downsampled cloud at the
    predicted pose, tile-sorted for the tiled index."""

    opt_count: int
    pred: se3.Pose
    pose0: se3.Pose  # the prediction re-centred at ``pred.t`` (rotation only)
    ds: dict  # channel -> PointSet
    bounds: dict  # channel -> per-tile query ranges (None: grid index)
    over_compact: dict  # channel -> features beyond the compaction capacity
    over_ds: dict  # channel -> voxels beyond the downsample capacity


def _prepare_frame(state: BPFState, xyz, masks, cfg: PipelineConfig) -> _Frame:
    """Prediction, per-channel compaction and voxel downsample, and for the
    tiled index one tile sort per channel at the predicted pose, with
    everything downstream kept in sorted order."""
    o, cap = cfg.odometry, cfg.capacity
    dev = state.pose.t.device
    pred = se3.constant_velocity_predict(state.pose, state.last_pose)
    grids = _grids_of(state)
    ds, over_compact, over_ds = {}, {}, {}
    for kind in CHANNELS:
        line = map_state.is_line_kind(kind)
        comp_cap = _compact_cap(cfg, kind)
        ds_cap = cap.ds_edge_points if line else cap.ds_surf_points
        cxyz, cvalid, _ = _compact_idx(xyz, masks[kind], comp_cap)
        over_compact[kind] = torch.clamp(masks[kind].sum() - comp_cap, min=0)
        ds[kind], over_ds[kind] = voxel.voxel_downsample_rgbds_counted(
            voxel.PointSet(cxyz, torch.zeros((comp_cap, 2), dtype=torch.float32, device=dev), cvalid),
            _leaf(cfg, kind),
            ds_cap,
        )
    bounds = {kind: None for kind in CHANNELS}
    if map_state.is_tiled(cfg):
        for kind in CHANNELS:
            qs = map_state.sort_queries_for_index(grids[kind], se3.transform_points(pred, ds[kind].xyz), ds[kind].valid, cfg, kind)
            ds[kind] = _reorder(ds[kind], qs.order)
            bounds[kind] = qs.bounds
    return _Frame(
        opt_count=max(o.min_outer_iters, state.opt_count - 1),
        pred=pred,
        pose0=se3.Pose(q=pred.q, t=torch.zeros(3, dtype=torch.float32, device=dev)),
        ds=ds,
        bounds=bounds,
        over_compact=over_compact,
        over_ds=over_ds,
    )


def _grids_of(state: BPFState) -> dict:
    return {"beam": state.beam_map, "pillar": state.pillar_map, "facade": state.facade_map}


def bpf_step(state: BPFState, xyz, masks, cfg: PipelineConfig):
    """One BPF odometry frame (ref ``updatePointsToMap``,
    src/odomEstimationClass.cpp:702-760).  ``masks`` maps channel name ->
    boolean mask over ``xyz``.  Returns (new_state, BPFDiag)."""
    o = cfg.odometry
    grids = _grids_of(state)
    fr = _prepare_frame(state, xyz, masks, cfg)
    center = fr.pred.t
    enough = (grids["beam"].valid.sum() > 10) & (grids["pillar"].valid.sum() > 10) & (grids["facade"].valid.sum() > 50)
    outer = _bpf_outer_assoc_once if o.assoc_once else _bpf_outer_per_iter
    q, t_l, h_fin, rgs, scan_rgs, counts = outer(cfg, fr.opt_count, enough, fr.pose0, center, grids, fr.ds, fr.bounds)
    pose, last_pose, dropped, (pg_q, pg_t, pg_h, pg_valid) = guard_and_window(state, se3.Pose(q=q, t=t_l + center), h_fin, cfg)
    ds = fr.ds

    new_maps, over_rows = {}, []
    for i, kind in enumerate(CHANNELS):
        world = se3.transform_points(pose, ds[kind].xyz)
        new_maps[kind], over_merge = map_state.merge_scan_into_index(
            grids[kind]._replace(rg=rgs[i]), world, scan_rgs[i], ds[kind].valid, pose.t, _leaf(cfg, kind), cfg, kind
        )
        over_rows.append(
            torch.stack([fr.over_compact[kind], fr.over_ds[kind], over_merge, map_state.tile_overflow_count(new_maps[kind], cfg, kind)])
        )

    new_state = BPFState(
        beam_map=new_maps["beam"],
        pillar_map=new_maps["pillar"],
        facade_map=new_maps["facade"],
        pose=pose,
        last_pose=last_pose,
        opt_count=fr.opt_count,
        pg_q=pg_q,
        pg_t=pg_t,
        pg_h=pg_h,
        pg_valid=pg_valid,
    )
    diag = BPFDiag(
        n_corr=counts.to(torch.int32),
        map_sizes=torch.stack([new_maps[k].valid.sum() for k in CHANNELS]).to(torch.int32),
        dropped=dropped,
        overflow=torch.stack(over_rows).to(torch.int32),
    )
    return new_state, diag


def merged_map(state: BPFState) -> voxel.PointSet:
    """Concatenated beam+pillar+facade map (ref ``mergeFeatures``,
    src/odomEstimationClass.cpp:1297-1306)."""
    maps = [state.beam_map, state.pillar_map, state.facade_map]
    return voxel.PointSet(
        xyz=torch.cat([m.xyz for m in maps]),
        rg=torch.cat([m.rg for m in maps]),
        valid=torch.cat([m.valid for m in maps]),
    )
