"""ES (edge + surf) scan-to-map odometry — the PFilter paper's core loop.

Port of ``pfilter_tpu/models/es_odometry.py`` (ref
``Odom_ES_EstimationClass``, src/odomEstimationClass.cpp:182-647).  One
frame =

  1. constant-velocity pose prediction (ref: :235-240),
  2. voxel downsample of the edge/surf feature clouds (ref: :242-245),
  3. ``opt_count`` outer iterations (12 decaying to 2, ref: :232-233,252) of
     association and 4 Gauss-Newton steps.  With ``assoc_once=True`` (the
     default) one 5-NN association per feature type at the predicted pose
     serves every iteration, which re-gates the cached neighbours under the
     refining pose; with ``assoc_once=False`` every iteration re-associates
     from scratch (kNN, fits, persistence read and g increments), as the
     reference does (ref: :252-272).  The tiled index sorts the queries once
     per frame at the predicted pose; the grid index needs no sort,
  4. pose-graph window + smoothing, map merge: transform, crop, rgbds
     re-voxelize, persistence eviction, aging (ref: :589-647).

The step never waits on the host.  ``opt_count`` depends only on the frame
index, so it is a Python int and the outer loop a Python loop; the one
device-valued decision (are the maps big enough to register against?) picks
between the loop's result and the zero-iteration result with
``torch.where``.  Compaction is a cumsum scatter in place of
``nonzero(size=)``, and the corrupt-frame guard is a device-side select.

fp32 conditioning: association and GN run in a frame re-centered at the
predicted translation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pfilter_tpu_torch.config import PipelineConfig
from pfilter_tpu_torch.models import map_state
from pfilter_tpu_torch.ops import gauss_newton as gn
from pfilter_tpu_torch.ops import pose_graph, se3, voxel


class ESState(NamedTuple):
    edge_map: object  # knn_tiled.TiledMap | knn.HashGrid (CapacityConfig.knn_impl)
    surf_map: object
    pose: se3.Pose  # world <- sensor
    last_pose: se3.Pose
    opt_count: int  # outer iterations of the last frame (a function of the frame index)
    pg_q: torch.Tensor  # [K,4] pose-graph window (ops/pose_graph.py)
    pg_t: torch.Tensor  # [K,3]
    pg_h: torch.Tensor  # [K,6,6]
    pg_valid: torch.Tensor  # [K]


# Lanes of FrameDiag.overflow — every fixed capacity that can silently drop
# points gets a counter:
#   0 edge_compact     extracted edge features beyond capacity.edge_points
#   1 surf_compact     extracted surf features beyond capacity.surf_points
#   2 ds_edge_voxel    downsampled-scan voxels beyond ds_edge_points
#   3 ds_surf_voxel    downsampled-scan voxels beyond ds_surf_points
#   4 edge_merge_voxel map voxels beyond edge_map_points at merge
#   5 surf_merge_voxel map voxels beyond surf_map_points at merge
#   6 tile_cap_over    map points beyond their kNN tile cap (truncation risk)
#   7 halo_escape      queries whose final pose left their sorted tile's halo
OVERFLOW_LANES = (
    "edge_compact",
    "surf_compact",
    "ds_edge_voxel",
    "ds_surf_voxel",
    "edge_merge_voxel",
    "surf_merge_voxel",
    "tile_cap_over",
    "halo_escape",
)


class FrameDiag(NamedTuple):
    n_edge_corr: torch.Tensor
    n_surf_corr: torch.Tensor
    edge_map_size: torch.Tensor
    surf_map_size: torch.Tensor
    dropped: torch.Tensor  # device-side corrupt-frame guard fired
    overflow: torch.Tensor  # [8] int32 counters, lanes in OVERFLOW_LANES
    # [2] int32 (edge, surf) mover-contaminated map points (provenance channel
    # only; 0 otherwise).
    contam: torch.Tensor


def zero_overflow(device=None) -> torch.Tensor:
    return torch.zeros(len(OVERFLOW_LANES), dtype=torch.int32, device=device)


def init_state(cfg: PipelineConfig, rg_width: int = 2, device=None) -> ESState:
    """``rg_width=3`` enables the provenance channel: rg column 2 carries a
    mover-origin bit that rides the same voxel max-merge as the counters
    (diagnostics only; zero effect on the pose)."""
    k = cfg.pose_graph.window
    return ESState(
        edge_map=map_state.empty_index(cfg, "edge", rg_width, device=device),
        surf_map=map_state.empty_index(cfg, "surf", rg_width, device=device),
        pose=se3.identity_pose(device),
        last_pose=se3.identity_pose(device),
        opt_count=cfg.odometry.max_outer_iters,
        pg_q=torch.tensor([1.0, 0, 0, 0], device=device).repeat(k, 1),
        pg_t=torch.zeros((k, 3), dtype=torch.float32, device=device),
        pg_h=torch.zeros((k, 6, 6), dtype=torch.float32, device=device),
        pg_valid=torch.zeros(k, dtype=torch.bool, device=device),
    )


def _compact_idx(xyz: torch.Tensor, mask: torch.Tensor, out_cap: int):
    """Gather masked points into a fixed-size prefix, in index order (the
    fixed-size ``nonzero``: a cumsum gives each masked point its slot, rows
    past the capacity and unmasked rows scatter into a dropped row, empty
    slots read the last point).  Returns (xyz [cap,3], valid [cap], idx [cap])."""
    n = xyz.shape[0]
    slot = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(mask & (slot < out_cap), slot, torch.full_like(slot, out_cap)).long()
    idx = torch.full((out_cap + 1,), n - 1, dtype=torch.int64, device=xyz.device)
    idx.scatter_(0, slot, torch.arange(n, device=xyz.device))
    idx = idx[:out_cap]
    valid = torch.arange(out_cap, device=xyz.device) < mask.sum()
    return xyz[idx], valid, idx


def _scan_rg(valid, idx, width: int, cap: int, mover):
    """Fresh scan-point rg block; column 2 gets the mover-provenance bit."""
    rg = torch.zeros((cap, width), dtype=torch.float32, device=valid.device)
    if mover is not None:
        rg[:, 2] = torch.where(valid, mover[idx].to(torch.float32), torch.zeros_like(rg[:, 2]))
    return rg


def _contam(edge_map, surf_map) -> torch.Tensor:
    """(edge, surf) map points whose voxel absorbed a mover return."""
    return torch.stack(
        [
            (edge_map.valid & (edge_map.rg[:, 2] > 0.5)).sum(),
            (surf_map.valid & (surf_map.rg[:, 2] > 0.5)).sum(),
        ]
    ).to(torch.int32)


def first_frame(state: ESState, feat, cfg: PipelineConfig, mover=None) -> ESState:
    """Seed the maps with the raw first-scan features (ref
    ``initMapWithPoints``, src/odomEstimationClass.cpp:217-222)."""
    cap = cfg.capacity
    w = state.edge_map.rg.shape[1]
    e_xyz, e_valid, e_idx = _compact_idx(feat.xyz, feat.edge_mask, cap.edge_map_points)
    s_xyz, s_valid, s_idx = _compact_idx(feat.xyz, feat.surf_mask, cap.surf_map_points)
    zeros_e = _scan_rg(e_valid, e_idx, w, cap.edge_map_points, mover)
    zeros_s = _scan_rg(s_valid, s_idx, w, cap.surf_map_points, mover)
    origin_t = state.pose.t
    return state._replace(
        edge_map=map_state.build_index(e_xyz, zeros_e, e_valid, origin_t, cfg, "edge"),
        surf_map=map_state.build_index(s_xyz, zeros_s, s_valid, origin_t, cfg, "surf"),
        opt_count=cfg.odometry.max_outer_iters,
    )


def _query(kind: str, grid, q_world, scan_valid, cfg: PipelineConfig, qsort_bounds):
    """5-NN of the queries: tile-sorted ones (``qsort_bounds`` given) through
    the tiled kernel's wrapper, unsorted ones through ``query_index``."""
    if qsort_bounds is not None:
        return map_state.query_index_presorted(grid, q_world, qsort_bounds, cfg, kind)
    return map_state.query_index(grid, q_world, scan_valid, cfg, kind)


def _fit(kind: str, neigh, o):
    """Line or plane fit of each query's neighbours: (geom_a, geom_b, fit_ok)."""
    if map_state.is_line_kind(kind):
        return gn.fit_lines(neigh, o.line_eig_ratio, o.line_half_length)
    normal, d, fit_ok = gn.fit_planes(neigh, o.plane_fit_tol)
    zero = torch.zeros_like(d)
    return normal, torch.stack([d, zero, zero], -1), fit_ok


def _persistence_read(nrg, o):
    """Observe and round statistics of the 5 neighbours' counters ``nrg``
    [M,5,W] (ref: :332-349): observe = mean(g) + 1 saturated at ratio x
    round, round = mean(r).  The counters are small integers, so the means
    are exact in any summation order."""
    observe = torch.mean(nrg[..., 1], dim=1) + 1.0
    round_ = torch.mean(nrg[..., 0], dim=1)
    observe = torch.where(observe > o.observe_saturate_ratio * round_, torch.full_like(observe, o.counter_cap), observe)
    return observe, round_


def _sparsity(neigh):
    """Mean distance of the 5 neighbours to their centroid (ref: :367-385)."""
    nc = torch.mean(neigh, dim=1, keepdim=True)
    return torch.mean(torch.linalg.vector_norm(neigh - nc, dim=-1), dim=1)


def _scan_writeback(round_, observe, ds_rg, mask, o):
    """Scan-point r/g written back where ``mask`` holds (ref: :354-355);
    provenance columns keep the scan point's own values."""
    new_rg = torch.stack(
        [
            torch.clamp(torch.floor(round_), max=o.counter_cap),
            torch.clamp(torch.floor(observe), max=o.counter_cap),
        ],
        -1,
    )
    new_rg = torch.cat([new_rg, ds_rg[:, 2:]], -1)
    return torch.where(mask[:, None], new_rg, ds_rg)


def _g_increment(n_map: int, nn_idx, w, k: int):
    """Counter increments: each query's weight ``w`` added to its k
    neighbours' slots.  ``w`` holds small integers (match counts), so the
    sum is exact in any order and the scatter's atomics are safe."""
    inc = torch.zeros(n_map, dtype=torch.float32, device=w.device)
    inc.index_put_((nn_idx.reshape(-1).long(),), w.to(torch.float32).repeat_interleave(k), accumulate=True)
    return inc


def _add_g(rg, inc, cap: float):
    out = rg.clone()
    out[:, 1] = torch.clamp(rg[:, 1] + inc, max=cap)
    return out


class _Assoc(NamedTuple):
    """Result of one association pass over one feature type."""

    geom_a: torch.Tensor  # [M,3] line endpoint a / plane normal
    geom_b: torch.Tensor  # [M,3] line endpoint b / (plane d, 0, 0)
    valid: torch.Tensor  # [M] gated correspondence mask
    weight_obs: torch.Tensor  # [M] raw observe values (weightType 1/12)
    weight_spr: torch.Tensor  # [M] raw sparsity values (weightType 2/12)
    scan_rg: torch.Tensor  # [M,W] r/g to write back into matched scan points
    matched: torch.Tensor  # [M] matches before the persistence gate: each adds 1 to its neighbours' g


def _associate(kind: str, grid, map_rg, pose_local: se3.Pose, center, scan_xyz, scan_valid, scan_rg, cfg: PipelineConfig, qsort_bounds, gate_sq: float):
    """One correspondence-building pass of the per-iteration loop (ref
    ``addEdgeCostFactor``/``addSurfCostFactor``,
    src/odomEstimationClass.cpp:284-578): 5-NN at the current pose, then
    :func:`_assoc_from_neighbours`.  Tile-sorted queries keep the predicted
    pose's sort and bounds, so from the second iteration on they sit off the
    centre of their tile (the halo margin covers it).  Returns the pass and
    its g increments ([MAP_CAP], every match before the persistence gate,
    ref :345-346)."""
    k = cfg.capacity.knn_k
    q_world = se3.transform_points(pose_local, scan_xyz) + center
    nn_idx, nn_sq = _query(kind, grid, q_world, scan_valid, cfg, qsort_bounds)
    if qsort_bounds is not None:
        nn_sq = torch.where(scan_valid[:, None], nn_sq, torch.full_like(nn_sq, float("inf")))
    nn_idx_l = nn_idx.long()
    a = _assoc_from_neighbours(kind, nn_sq, grid.xyz[nn_idx_l], map_rg[nn_idx_l], scan_valid, scan_rg, center, cfg, gate_sq)
    return a, _g_increment(grid.rg.shape[0], nn_idx, a.matched, k)


def _assoc_from_neighbours(kind: str, nn_sq, nxyz, nrg, scan_valid, scan_rg, center, cfg: PipelineConfig, gate_sq: float) -> _Assoc:
    """A pass from each query's 5 nearest map points (squared distances
    ``nn_sq``, coordinates ``nxyz``, counters ``nrg``): gate, fits,
    persistence read and gate, scan writeback, sparsity."""
    o = cfg.odometry
    k = cfg.capacity.knn_k
    gate = nn_sq[:, k - 1] < gate_sq
    neigh = nxyz - center  # [M,5,3] local frame for fp32 fits
    geom_a, geom_b, fit_ok = _fit(kind, neigh, o)
    matched = scan_valid & gate & fit_ok
    observe, round_ = _persistence_read(nrg, o)
    gated_out = (observe < round_ * o.theta_p) & (round_ > o.k_new) & (observe < o.theta_max)
    valid_corr = matched & ~gated_out
    return _Assoc(
        geom_a=geom_a,
        geom_b=geom_b,
        valid=valid_corr,
        weight_obs=observe,
        weight_spr=_sparsity(neigh),
        scan_rg=_scan_writeback(round_, observe, scan_rg, valid_corr, o),
        matched=matched,
    )


def _weights(assoc: _Assoc, weight_type: int) -> torch.Tensor:
    return _weights_from(assoc.weight_obs, assoc.weight_spr, assoc.valid, weight_type)


class _AssocStatic(NamedTuple):
    """Frame-invariant association data: everything derived from the map and
    the predicted-pose kNN.  Only the distance gate depends on the refining pose."""

    nn_idx: torch.Tensor  # [M,5] map slot ids
    neigh: torch.Tensor  # [M,5,3] neighbour coords, center-relative
    nn_valid: torch.Tensor  # [M] query had a full finite 5-NN set
    geom_a: torch.Tensor  # [M,3] line endpoint a / plane normal
    geom_b: torch.Tensor  # [M,3] line endpoint b / (plane d, 0, 0)
    fit_ok: torch.Tensor  # [M]
    pers_ok: torch.Tensor  # [M] persistence gate (frame-start counters)
    observe: torch.Tensor  # [M] saturated observe statistic
    round_: torch.Tensor  # [M]
    sparsity: torch.Tensor  # [M]


def _associate_static(kind: str, grid, map_rg, pose_local: se3.Pose, center, scan_xyz, scan_valid, cfg: PipelineConfig, qsort_bounds) -> _AssocStatic:
    """The pose-independent half of a correspondence pass (ref
    ``addEdgeCostFactor``/``addSurfCostFactor``,
    src/odomEstimationClass.cpp:284-578): 5-NN at the predicted pose, then
    :func:`_static_from_neighbours`."""
    k = cfg.capacity.knn_k
    q_world = se3.transform_points(pose_local, scan_xyz) + center
    nn_idx, nn_sq = _query(kind, grid, q_world, scan_valid, cfg, qsort_bounds)
    nn_valid = scan_valid & torch.isfinite(nn_sq[:, k - 1])
    nn_idx_l = nn_idx.long()
    return _static_from_neighbours(kind, nn_idx, grid.xyz[nn_idx_l], map_rg[nn_idx_l], nn_valid, center, cfg.odometry)


def _static_from_neighbours(kind: str, nn_idx, nxyz, nrg, nn_valid, center, o) -> _AssocStatic:
    """Neighbour coordinates ``nxyz`` and counters ``nrg`` of the map slots
    ``nn_idx`` -> line/plane fits, persistence read and gate (ref: :332-353,
    on frame-start counters), sparsity.  ``o`` is the OdometryConfig."""
    neigh = nxyz - center  # [M,5,3] local frame for fp32 fits
    geom_a, geom_b, fit_ok = _fit(kind, neigh, o)
    observe, round_ = _persistence_read(nrg, o)
    gated_out = (observe < round_ * o.theta_p) & (round_ > o.k_new) & (observe < o.theta_max)
    return _AssocStatic(
        nn_idx=nn_idx,
        neigh=neigh,
        nn_valid=nn_valid,
        geom_a=geom_a,
        geom_b=geom_b,
        fit_ok=fit_ok,
        pers_ok=~gated_out,
        observe=observe,
        round_=round_,
        sparsity=_sparsity(neigh),
    )


def _regate(st: _AssocStatic, pose_local: se3.Pose, scan_xyz, gate_sq: float):
    """Re-gate the cached correspondences under the current pose: a query
    stays matched iff its worst cached neighbour is within ``gate_sq``."""
    q_local = se3.transform_points(pose_local, scan_xyz)
    d5 = torch.sum((q_local[:, None, :] - st.neigh) ** 2, dim=-1)
    gate = torch.amax(d5, dim=1) < gate_sq
    matched = st.nn_valid & gate & st.fit_ok
    return matched, matched & st.pers_ok


def _halo_escape_count(q_world, q_valid, bounds, origin, cfg: PipelineConfig, kind: str) -> torch.Tensor:
    """Tile-sorted queries whose final world position lies more than one
    tile from the tile they were sorted into (their halo no longer covers
    the gate ball)."""
    nt, tc, _ = map_state._tile_params(cfg, kind)
    ts = float(tc)
    p = torch.arange(q_world.shape[0], dtype=torch.int32, device=q_world.device)
    tid_s = torch.clamp(torch.searchsorted(bounds, p, right=True) - 1, 0, nt * nt - 1)
    tx_s, ty_s = tid_s // nt, tid_s % nt
    t2 = torch.clamp(torch.floor((q_world[:, :2] - origin[:2]) / ts).to(torch.int32), 1, nt - 2)
    escaped = q_valid & ((torch.abs(t2[:, 0] - tx_s) > 1) | (torch.abs(t2[:, 1] - ty_s) > 1))
    return escaped.sum().to(torch.int32)


def _weights_from(weight_obs, weight_spr, valid, weight_type: int, ranges=None) -> torch.Tensor:
    """Residual weights by weightType (ref: :389-426, :536-571).  ``ranges``
    ((obs min, obs max), (spr min, spr max)) replaces the ranges of the
    valid values here (the map-sharded step passes the ranges over every
    shard's queries); with no valid value anywhere both give weights of 1."""
    if weight_type == 0:
        return torch.ones_like(weight_obs)
    if ranges is None:
        w_obs = gn.minmax_normalize_weights(weight_obs, valid, floor=0.1)
        w_spr = gn.minmax_normalize_weights(weight_spr, valid, floor=0.0)
    else:
        w_obs = gn.fold_normalize(weight_obs, *ranges[0], floor=0.1)
        w_spr = gn.fold_normalize(weight_spr, *ranges[1], floor=0.0)
    if weight_type == 1:
        return w_obs
    if weight_type == 2:
        return w_spr
    if weight_type == 12:
        return 0.5 * (w_obs + w_spr)
    raise ValueError(f"unknown weight_type {weight_type}")


def _es_outer_assoc_once(cfg, opt_count: int, enough, pose0, center, edge_grid, surf_grid, ds_edge, ds_surf, e_bounds, s_bounds):
    """Hoisted-association outer loop (OdometryConfig.assoc_once): one kNN +
    gather + fit + persistence pass per feature type per frame; iterations
    re-gate cached neighbour distances and re-run GN.  ``enough`` (a bool
    tensor) selects the loop's result or the zero-iteration result.

    Counter semantics: g increments apply once after the loop, scaled by the
    number of outer iterations run (ref: :345-346)."""
    o = cfg.odometry
    k = cfg.capacity.knn_k
    dev = center.device

    ea = _associate_static("edge", edge_grid, edge_grid.rg, pose0, center, ds_edge.xyz, ds_edge.valid, cfg, e_bounds)
    sa = _associate_static("surf", surf_grid, surf_grid.rg, pose0, center, ds_surf.xyz, ds_surf.valid, cfg, s_bounds)

    pose_l = pose0
    h = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    e_m0 = e_match = e_vc = torch.zeros(ds_edge.xyz.shape[0], dtype=torch.bool, device=dev)
    s_m0 = s_match = s_vc = torch.zeros(ds_surf.xyz.shape[0], dtype=torch.bool, device=dev)
    for it in range(opt_count):
        # Coarse-to-fine: wide gate on the first outer iteration only.
        gate_sq = o.nn_gate_wide_sq if it == 0 else o.nn_gate_sq
        e_match, e_vc = _regate(ea, pose_l, ds_edge.xyz, gate_sq)
        s_match, s_vc = _regate(sa, pose_l, ds_surf.xyz, gate_sq)
        if it == 0:
            # Keep the wide first pass's match set for the g increments.
            e_m0, s_m0 = e_match, s_match
        factors = [
            gn.Correspondences("edge", ds_edge.xyz, ea.geom_a, ea.geom_b, _weights_from(ea.observe, ea.sparsity, e_vc, o.weight_type), e_vc),
            gn.Correspondences("surf", ds_surf.xyz, sa.geom_a, sa.geom_b, _weights_from(sa.observe, sa.sparsity, s_vc, o.weight_type), s_vc),
        ]
        for _ in range(o.inner_gn_iters):
            pose_l, (h, _b) = gn.gn_iteration(pose_l, factors, o.huber_delta, o.gn_damping)

    # Zero iterations when the maps are too small: the loop's outputs revert
    # to their initial values.
    def sel(x, x0):
        return torch.where(enough, x, x0)

    q = sel(pose_l.q, pose0.q)
    t_l = sel(pose_l.t, pose0.t)
    h_fin = sel(h, torch.zeros_like(h))
    e_m0, e_match, e_vc = (x & enough for x in (e_m0, e_match, e_vc))
    s_m0, s_match, s_vc = (x & enough for x in (s_m0, s_match, s_vc))

    # g increments (ref: :345-346): the wide first pass credits +1, the other
    # opt_eff-1 narrow passes credit the final match set.
    scale_rest = float(max(opt_count - 1, 0))
    e_rg = _add_g(edge_grid.rg, _g_increment(edge_grid.rg.shape[0], ea.nn_idx, e_m0.float() + scale_rest * e_match.float(), k), o.counter_cap)
    s_rg = _add_g(surf_grid.rg, _g_increment(surf_grid.rg.shape[0], sa.nn_idx, s_m0.float() + scale_rest * s_match.float(), k), o.counter_cap)

    # Scan-point r/g writeback for the merge (ref: :354-355) — the union of
    # the per-iteration valid sets.
    se_rg = _scan_writeback(ea.round_, ea.observe, ds_edge.rg, (e_m0 & ea.pers_ok) | e_vc, o)
    ss_rg = _scan_writeback(sa.round_, sa.observe, ds_surf.rg, (s_m0 & sa.pers_ok) | s_vc, o)
    return q, t_l, e_rg, s_rg, se_rg, ss_rg, e_vc.sum(), s_vc.sum(), h_fin


def _outer_per_iter(cfg, opt_count: int, enough, pose0, center, grids: dict, ds: dict, bounds: dict):
    """Reference-faithful outer loop (OdometryConfig.assoc_once=False) over
    the channels named by ``grids``' keys (ES: edge, surf; BPF: beam,
    pillar, facade): full re-association every iteration (ref:
    src/odomEstimationClass.cpp:252-272, :722-760) — kNN, fits and the
    persistence read on the counters as the previous iterations left them,
    whose g increments are added in every iteration.  ``enough`` (a bool
    tensor) selects the loop's result or the zero-iteration result (initial
    pose and counters, ``h`` zero, counts 0).  Returns ``(q, t_local, h,
    map_rgs, scan_rgs, counts)``, the last three dicts by channel."""
    o = cfg.odometry
    dev = center.device
    pose_l = pose0
    h = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    rgs = {kind: grids[kind].rg for kind in grids}
    scan_rgs = {kind: ds[kind].rg for kind in grids}
    counts = {kind: torch.zeros((), dtype=torch.int64, device=dev) for kind in grids}
    for it in range(opt_count):
        # Coarse-to-fine: wide gate on the first outer iteration only.
        gate_sq = o.nn_gate_wide_sq if it == 0 else o.nn_gate_sq
        factors = []
        for kind in grids:
            a, inc = _associate(kind, grids[kind], rgs[kind], pose_l, center, ds[kind].xyz, ds[kind].valid, scan_rgs[kind], cfg, bounds[kind], gate_sq)
            rgs[kind] = _add_g(rgs[kind], inc, o.counter_cap)
            scan_rgs[kind] = a.scan_rg
            counts[kind] = a.valid.sum()
            factor_kind = "edge" if map_state.is_line_kind(kind) else "surf"
            factors.append(gn.Correspondences(factor_kind, ds[kind].xyz, a.geom_a, a.geom_b, _weights(a, o.weight_type), a.valid))
        for _ in range(o.inner_gn_iters):
            pose_l, (h, _b) = gn.gn_iteration(pose_l, factors, o.huber_delta, o.gn_damping)

    def sel(x, x0):
        return torch.where(enough, x, x0)

    return (
        sel(pose_l.q, pose0.q),
        sel(pose_l.t, pose0.t),
        sel(h, torch.zeros_like(h)),
        {kind: sel(rgs[kind], grids[kind].rg) for kind in grids},
        {kind: sel(scan_rgs[kind], ds[kind].rg) for kind in grids},
        {kind: sel(c, torch.zeros_like(c)) for kind, c in counts.items()},
    )


def _es_outer_per_iter(cfg, opt_count: int, enough, pose0, center, edge_grid, surf_grid, ds_edge, ds_surf, e_bounds, s_bounds):
    """:func:`_outer_per_iter` over the edge and surf maps, returning what
    :func:`_es_outer_assoc_once` returns."""
    q, t_l, h, rgs, scan_rgs, counts = _outer_per_iter(
        cfg, opt_count, enough, pose0, center,
        {"edge": edge_grid, "surf": surf_grid}, {"edge": ds_edge, "surf": ds_surf}, {"edge": e_bounds, "surf": s_bounds},
    )
    return q, t_l, rgs["edge"], rgs["surf"], scan_rgs["edge"], scan_rgs["surf"], counts["edge"], counts["surf"], h


def _reorder(ps: voxel.PointSet, order) -> voxel.PointSet:
    return voxel.PointSet(xyz=ps.xyz[order], rg=ps.rg[order], valid=ps.valid[order])


class _Frame(NamedTuple):
    """What an ES frame registers: the downsampled feature clouds at the
    predicted pose, tile-sorted for the tiled index."""

    opt_count: int  # outer iterations of this frame
    pred: se3.Pose  # constant-velocity prediction
    pose0: se3.Pose  # the prediction re-centred at ``pred.t`` (rotation only)
    ds_edge: voxel.PointSet
    ds_surf: voxel.PointSet
    e_bounds: Optional[torch.Tensor]  # per-tile query ranges (None: grid index)
    s_bounds: Optional[torch.Tensor]
    overflow: list  # lanes 0-3: edge/surf compaction, edge/surf downsample


def _prepare_frame(state: ESState, feat, cfg: PipelineConfig, mover=None) -> _Frame:
    """Prediction (ref: :235-240), compaction and voxel downsample of the
    feature clouds (ref: :242-245; edge at map_resolution, surf at 2x), and
    for the tiled index one tile sort per cloud at the predicted pose, with
    everything downstream kept in sorted order."""
    o = cfg.odometry
    cap = cfg.capacity
    dev = state.pose.t.device
    w = state.edge_map.rg.shape[1]
    pred = se3.constant_velocity_predict(state.pose, state.last_pose)

    e_xyz, e_valid, e_idx = _compact_idx(feat.xyz, feat.edge_mask, cap.edge_points)
    s_xyz, s_valid, s_idx = _compact_idx(feat.xyz, feat.surf_mask, cap.surf_points)
    over_e_compact = torch.clamp(feat.edge_mask.sum() - cap.edge_points, min=0)
    over_s_compact = torch.clamp(feat.surf_mask.sum() - cap.surf_points, min=0)
    ds_edge, over_ds_e = voxel.voxel_downsample_rgbds_counted(
        voxel.PointSet(e_xyz, _scan_rg(e_valid, e_idx, w, cap.edge_points, mover), e_valid),
        o.map_resolution,
        cap.ds_edge_points,
    )
    ds_surf, over_ds_s = voxel.voxel_downsample_rgbds_counted(
        voxel.PointSet(s_xyz, _scan_rg(s_valid, s_idx, w, cap.surf_points, mover), s_valid),
        o.map_resolution * 2.0,
        cap.ds_surf_points,
    )

    # The grid index needs no sort: e_sort is None.
    e_sort = map_state.sort_queries_for_index(state.edge_map, se3.transform_points(pred, ds_edge.xyz), ds_edge.valid, cfg, "edge")
    s_sort = map_state.sort_queries_for_index(state.surf_map, se3.transform_points(pred, ds_surf.xyz), ds_surf.valid, cfg, "surf")
    e_bounds = s_bounds = None
    if e_sort is not None:
        ds_edge = _reorder(ds_edge, e_sort.order)
        ds_surf = _reorder(ds_surf, s_sort.order)
        e_bounds, s_bounds = e_sort.bounds, s_sort.bounds
    return _Frame(
        opt_count=max(o.min_outer_iters, state.opt_count - 1),
        pred=pred,
        pose0=se3.Pose(q=pred.q, t=torch.zeros(3, dtype=torch.float32, device=dev)),
        ds_edge=ds_edge,
        ds_surf=ds_surf,
        e_bounds=e_bounds,
        s_bounds=s_bounds,
        overflow=[over_e_compact, over_s_compact, over_ds_e, over_ds_s],
    )


def guard_and_window(state, pose: se3.Pose, h_fin, cfg: PipelineConfig):
    """After registration, for ES and BPF alike: the device-side corrupt-frame
    guard (a non-finite or implausibly large pose jump rolls the pose back to
    the previous frame's, with no host sync), then the pose-graph window,
    whose anchors are the raw scan-match poses weighted by their GN
    information (a dropped frame enters with near-zero information), and its
    smoothing when enabled.  Returns ``(pose, last_pose, dropped, (pg_q,
    pg_t, pg_h, pg_valid))``."""
    o = cfg.odometry
    dev = state.pose.t.device
    last_pose = state.pose
    finite = torch.isfinite(pose.q).all() & torch.isfinite(pose.t).all()
    jump = torch.linalg.vector_norm(torch.where(finite, pose.t - state.pose.t, torch.zeros_like(pose.t)))
    dropped = ~finite | (jump > o.max_jump_m)
    pose = se3.Pose(q=torch.where(dropped, state.pose.q, pose.q), t=torch.where(dropped, state.pose.t, pose.t))
    last_pose = se3.Pose(
        q=torch.where(dropped, state.last_pose.q, last_pose.q),
        t=torch.where(dropped, state.last_pose.t, last_pose.t),
    )
    pgc = cfg.pose_graph
    h_anchor = torch.where(dropped, 1e-3 * torch.eye(6, dtype=torch.float32, device=dev), h_fin)
    window = pose_graph.push_window(state.pg_q, state.pg_t, state.pg_h, state.pg_valid, pose.q, pose.t, h_anchor)
    if pgc.enabled:
        pose = pose_graph.smoothed_newest(*window, pose, pgc)
    return pose, last_pose, dropped, window


def halo_escapes(fr: _Frame, edge_world, surf_world, edge_origin, surf_origin, cfg: PipelineConfig) -> torch.Tensor:
    """Queries whose final position left their sorted tile's halo (tiled
    index only; the grid index queries every iteration's own cells: 0)."""
    if fr.e_bounds is None:
        return torch.zeros((), dtype=torch.int32, device=edge_world.device)
    return _halo_escape_count(edge_world, fr.ds_edge.valid, fr.e_bounds, edge_origin, cfg, "edge") + _halo_escape_count(
        surf_world, fr.ds_surf.valid, fr.s_bounds, surf_origin, cfg, "surf"
    )


def es_step(state: ESState, feat, cfg: PipelineConfig, mover=None):
    """One odometry frame (ref ``updatePointsToMap``,
    src/odomEstimationClass.cpp:229-282).  ``feat`` is a FeatureResult;
    ``mover`` an optional [R*C] mover-origin mask aligned with feat.xyz
    (requires init_state(rg_width=3)).  Returns (new_state, FrameDiag)."""
    o = cfg.odometry
    dev = state.pose.t.device
    w = state.edge_map.rg.shape[1]
    fr = _prepare_frame(state, feat, cfg, mover)
    center = fr.pred.t  # fp32 re-centering origin
    enough = (state.edge_map.valid.sum() > 10) & (state.surf_map.valid.sum() > 50)
    edge_grid, surf_grid = state.edge_map, state.surf_map

    outer = _es_outer_assoc_once if o.assoc_once else _es_outer_per_iter
    q, t_l, e_rg, s_rg, se_rg, ss_rg, ne, ns, h_fin = outer(
        cfg, fr.opt_count, enough, fr.pose0, center, edge_grid, surf_grid, fr.ds_edge, fr.ds_surf, fr.e_bounds, fr.s_bounds
    )
    pose, last_pose, dropped, (pg_q, pg_t, pg_h, pg_valid) = guard_and_window(state, se3.Pose(q=q, t=t_l + center), h_fin, cfg)

    # Map merge (ref addPointsToMap, :589-647) in world coords.
    edge_world = se3.transform_points(pose, fr.ds_edge.xyz)
    surf_world = se3.transform_points(pose, fr.ds_surf.xyz)
    new_edge, over_me = map_state.merge_scan_into_index(
        edge_grid._replace(rg=e_rg), edge_world, se_rg, fr.ds_edge.valid, pose.t, o.map_resolution, cfg, "edge"
    )
    new_surf, over_ms = map_state.merge_scan_into_index(
        surf_grid._replace(rg=s_rg), surf_world, ss_rg, fr.ds_surf.valid, pose.t, o.map_resolution * 2.0, cfg, "surf"
    )
    over_tile = map_state.tile_overflow_count(new_edge, cfg, "edge") + map_state.tile_overflow_count(new_surf, cfg, "surf")
    over_halo = halo_escapes(fr, edge_world, surf_world, edge_grid.origin, surf_grid.origin, cfg)
    overflow = torch.stack(fr.overflow + [over_me, over_ms, over_tile, over_halo]).to(torch.int32)

    new_state = ESState(
        edge_map=new_edge,
        surf_map=new_surf,
        pose=pose,
        last_pose=last_pose,
        opt_count=fr.opt_count,
        pg_q=pg_q,
        pg_t=pg_t,
        pg_h=pg_h,
        pg_valid=pg_valid,
    )
    contam = _contam(new_edge, new_surf) if w > 2 else torch.zeros((), dtype=torch.int32, device=dev)
    diag = FrameDiag(
        n_edge_corr=ne,
        n_surf_corr=ns,
        edge_map_size=new_edge.valid.sum(),
        surf_map_size=new_surf.valid.sum(),
        dropped=dropped,
        overflow=overflow,
        contam=contam,
    )
    return new_state, diag
