"""Map-sharded ES odometry: the map partitioned into voxel blocks across the
map ranks of a sequence row, with collective kNN merges and all-reduced
Gauss-Newton normal equations.

Port of ``pfilter_tpu/parallel/es_sharded.py``.  Each process holds one
cell of the seq x map grid (``parallel/mesh.py``) and its block of the
state: its shard of each map, at ``capacity // n_map`` points (a tiled shard
keeps the full tile cap), and the replicated pose, iteration count and
pose-graph window.  One frame:

- the scan's features, the prediction, the downsampled clouds and their tile
  sort are computed alike on every rank of the row (``es_odometry``'s own
  helpers);
- each shard runs the kNN against its map block (the same kNN kernel as the
  single-device step, at ``capacity // n_map``); the shards' top-5
  candidates are all-gathered and merged exactly; each shard then takes its
  contiguous slice of the queries (``Q // n_map``) and builds that slice's
  fits and factors; every Gauss-Newton step sums H and b over the shards;
- g increments go back to the shard that owns each merged neighbour, and the
  scan's r/g writebacks are gathered, through one all-gather per map;
- each shard merges the scan points whose voxel hashes to it
  (``spatial_hash % n_map``); voxel boundaries are absolute, so ownership is
  stable and map upkeep is local.

The collectives of a frame (one sequence row): an all-reduce of the map
sizes; per map an all-gather of the kNN candidates and, after the loop, one
of the g increments and writebacks (with ``assoc_once=False`` both in every
outer iteration); per outer iteration an all-reduce of the weights' ranges
(``weight_type`` > 0) and one of H and b per Gauss-Newton step; an
all-reduce of the counts and overflow lanes at the end.

The step never waits on the host: ``opt_count`` is a Python int, the
all-reduced "maps big enough" decision selects with ``torch.where``, and the
collectives queue on the device.  With ``n_map == 1`` the step equals
``es_odometry.es_step`` bit for bit (a collective of one rank is a copy, the
merge of one shard's sorted candidates is the identity, and ownership
selects every point).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pfilter_tpu_torch.config import PipelineConfig
from pfilter_tpu_torch.models import es_odometry as es
from pfilter_tpu_torch.models import map_state
from pfilter_tpu_torch.ops import features, se3, voxel
from pfilter_tpu_torch.ops import gauss_newton as gn
from pfilter_tpu_torch.parallel.mesh import Mesh
from pfilter_tpu_torch.pipeline import es_prefilter


def _local_capacity(cfg: PipelineConfig, kind: str, n_map: int) -> int:
    return map_state.map_capacity(cfg, kind) // n_map


def _empty_local(cfg: PipelineConfig, kind: str, mesh: Mesh):
    """An empty map shard at ``capacity // n_map`` points.  A grid map is one
    block of the reference's global ``[CAP]`` arrays, so ``n_map`` must
    divide its capacity."""
    if not map_state.is_tiled(cfg) and map_state.map_capacity(cfg, kind) % mesh.n_map:
        raise ValueError(f"{kind} map capacity {map_state.map_capacity(cfg, kind)} is not divisible by n_map={mesh.n_map}")
    cap = _local_capacity(cfg, kind, mesh.n_map)
    dev = mesh.device
    return map_state.build_index(
        torch.zeros((cap, 3), dtype=torch.float32, device=dev),
        torch.zeros((cap, 2), dtype=torch.float32, device=dev),
        torch.zeros(cap, dtype=torch.bool, device=dev),
        torch.zeros(3, dtype=torch.float32, device=dev),
        cfg,
        kind,
    )


def _factor_kind(kind: str) -> str:
    return "edge" if map_state.is_line_kind(kind) else "surf"


# ---------------------------------------------------------------------------
# Collective association
# ---------------------------------------------------------------------------


def _merged_neighbours(mesh: Mesh, kind: str, grid, map_rg, pose_l, center, scan_xyz, scan_valid, cfg: PipelineConfig, bounds):
    """Shard-local k-NN of every query, then the exact global k-NN: every
    shard's k candidates (squared distance, x, y, z, the W counters, the
    owner-local slot) are all-gathered and the k nearest of the ``n_map * k``
    taken by a stable sort, so equal distances keep the lower shard, then the
    shard's own order, as the reference's ``lax.top_k`` does.  Returns
    ``(best [Q,k,5+W], owner shard [Q,k])``."""
    k = cfg.capacity.knn_k
    q = scan_xyz.shape[0]
    q_world = se3.transform_points(pose_l, scan_xyz) + center
    nn_idx, nn_sq = es._query(kind, grid, q_world, scan_valid, cfg, bounds)
    if bounds is not None:
        nn_sq = torch.where(scan_valid[:, None], nn_sq, torch.full_like(nn_sq, float("inf")))
    nn_l = nn_idx.long()
    # Slots are below 2^24, so they travel exactly as float32.
    cand = torch.cat([nn_sq[..., None], grid.xyz[nn_l], map_rg[nn_l], nn_idx.to(torch.float32)[..., None]], -1)
    comb = mesh.all_gather(cand).transpose(0, 1).reshape(q, mesh.n_map * k, cand.shape[-1])
    sel = torch.sort(comb[..., 0], dim=1, stable=True).indices[:, :k]
    return torch.take_along_dim(comb, sel[..., None], dim=1), sel // k


def _route_back(mesh: Mesh, n_slots: int, shard, lidx, w, scan_rg):
    """One all-gather of every slice's (owner shard, owner slot, g increment
    ``w`` per query, scan r/g writeback): this shard adds the increments of
    the neighbours it owns (small integers: exact in any order).  Returns
    (this shard's increments [n_slots], the whole scan's r/g [Q,W])."""
    k = lidx.shape[1]
    f32 = torch.float32
    g = mesh.all_gather(torch.cat([shard.to(f32), lidx.to(f32), w[:, None], scan_rg], 1))
    mine = g[..., :k] == mesh.map_index
    inc = torch.where(mine, g[..., 2 * k : 2 * k + 1].expand(mine.shape), torch.zeros((), dtype=f32, device=g.device))
    increments = es._g_increment(n_slots, g[..., k : 2 * k].reshape(-1, 1).long(), inc.reshape(-1), 1)
    return increments, g[..., 2 * k + 1 :].reshape(-1, scan_rg.shape[1])


class _ShardStatic(NamedTuple):
    """``es_odometry._AssocStatic`` over this shard's slice of the queries,
    ``st.nn_idx`` holding each merged neighbour's slot in its owner's map."""

    st: es._AssocStatic
    shard: torch.Tensor  # [Qs,k] owner shard of each merged neighbour
    points: torch.Tensor  # [Qs,3] scan points (sensor frame)
    scan_rg: torch.Tensor  # [Qs,W] incoming scan r/g (the writeback's fallback)


def _associate_static(mesh: Mesh, kind: str, grid, pose_l, center, ds: voxel.PointSet, cfg: PipelineConfig, bounds) -> _ShardStatic:
    """Collective twin of ``es_odometry._associate_static``: the merged 5-NN
    at the predicted pose, then this shard's slice's fits and persistence."""
    k = cfg.capacity.knn_k
    w = grid.rg.shape[1]
    best, shard = _merged_neighbours(mesh, kind, grid, grid.rg, pose_l, center, ds.xyz, ds.valid, cfg, bounds)
    sl = mesh.query_slice(ds.xyz.shape[0])
    best = best[sl]
    nn_valid = ds.valid[sl] & torch.isfinite(best[:, k - 1, 0])
    st = es._static_from_neighbours(kind, best[..., -1].long(), best[..., 1:4], best[..., 4 : 4 + w], nn_valid, center, cfg.odometry)
    return _ShardStatic(st=st, shard=shard[sl], points=ds.xyz[sl], scan_rg=ds.rg[sl])


def _associate(mesh: Mesh, kind: str, grid, map_rg, pose_l, center, ds: voxel.PointSet, scan_rg, cfg: PipelineConfig, bounds, gate_sq: float):
    """Collective twin of ``es_odometry._associate``: the merged 5-NN at the
    current pose, this shard's slice's pass, its g increments routed to
    their owners and the writebacks gathered.  Returns (the slice's pass, the
    slice's points, this shard's g increments, the whole scan's r/g)."""
    w = map_rg.shape[1]
    best, shard = _merged_neighbours(mesh, kind, grid, map_rg, pose_l, center, ds.xyz, ds.valid, cfg, bounds)
    sl = mesh.query_slice(ds.xyz.shape[0])
    best = best[sl]
    a = es._assoc_from_neighbours(kind, best[..., 0], best[..., 1:4], best[..., 4 : 4 + w], ds.valid[sl], scan_rg[sl], center, cfg, gate_sq)
    inc, scan_rg_full = _route_back(mesh, grid.rg.shape[0], shard[sl], best[..., -1].long(), a.matched.to(torch.float32), a.scan_rg)
    return a, ds.xyz[sl], inc, scan_rg_full


def _weight_ranges(mesh: Mesh, stats: dict, weight_type: int) -> dict:
    """``{channel: (observe, sparsity, valid)}`` -> ``{channel: ((observe
    min, max), (sparsity min, max))}`` over every shard's valid values: one
    all-reduce (min; the maxima travel negated) for all channels.  None for
    ``weight_type == 0``, which needs no ranges."""
    if weight_type == 0:
        return {kind: None for kind in stats}
    local = []
    for obs, spr, valid in stats.values():
        for values in (obs, spr):
            vmin, vmax = gn.masked_minmax(values, valid)
            local += [vmin, -vmax]
    red = mesh.pmin(torch.stack(local)).reshape(-1, 2, 2)
    return {kind: ((red[i, 0, 0], -red[i, 0, 1]), (red[i, 1, 0], -red[i, 1, 1])) for i, kind in enumerate(stats)}


def _summed_normal_equations(mesh: Mesh):
    """``gauss_newton.gn_iteration``'s ``reduce``: H and b summed over the
    shards in one all-reduce."""

    def reduce(h, b):
        hb = mesh.psum(torch.cat([h.reshape(-1), b]))
        return hb[:36].reshape(6, 6), hb[36:]

    return reduce


def _gn_inner(mesh: Mesh, cfg: PipelineConfig, pose_l, factors):
    """``inner_gn_iters`` Gauss-Newton steps on the shards' summed normal
    equations.  Returns the pose and the last H."""
    o = cfg.odometry
    reduce = _summed_normal_equations(mesh)
    h = torch.zeros((6, 6), dtype=torch.float32, device=pose_l.q.device)
    for _ in range(o.inner_gn_iters):
        pose_l, (h, _b) = gn.gn_iteration(pose_l, factors, o.huber_delta, o.gn_damping, reduce)
    return pose_l, h


# ---------------------------------------------------------------------------
# Outer loops, over the channels of ``grids`` (ES: edge, surf; BPF: beam,
# pillar, facade).  Each returns (q, t_local, h, map_rgs, scan_rgs, counts),
# the last three dicts by channel, the counts this shard's.
# ---------------------------------------------------------------------------


def _outer_assoc_once(mesh: Mesh, cfg: PipelineConfig, opt_count: int, enough, pose0, center, grids: dict, ds: dict, bounds: dict):
    """Collective twin of ``es_odometry._es_outer_assoc_once`` (and of
    ``bpf_odometry._bpf_outer_assoc_once``): one merged 5-NN per channel per
    frame; iterations re-gate the cached neighbours and run Gauss-Newton on
    the summed normal equations; ``enough`` selects the loop's result or the
    zero-iteration result; the g increments (the wide first pass's matches
    plus ``opt_count - 1`` times the final ones) go to their owners after the
    loop."""
    o = cfg.odometry
    dev = center.device
    st = {kind: _associate_static(mesh, kind, grids[kind], pose0, center, ds[kind], cfg, bounds[kind]) for kind in grids}
    zeros = {kind: torch.zeros(st[kind].points.shape[0], dtype=torch.bool, device=dev) for kind in grids}
    m0s, matches, vcs = dict(zeros), dict(zeros), dict(zeros)
    pose_l = pose0
    h = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    for it in range(opt_count):
        # Coarse-to-fine: wide gate on the first outer iteration only.
        gate_sq = o.nn_gate_wide_sq if it == 0 else o.nn_gate_sq
        for kind in grids:
            matches[kind], vcs[kind] = es._regate(st[kind].st, pose_l, st[kind].points, gate_sq)
        if it == 0:
            m0s = dict(matches)
        ranges = _weight_ranges(mesh, {kind: (st[kind].st.observe, st[kind].st.sparsity, vcs[kind]) for kind in grids}, o.weight_type)
        factors = [
            gn.Correspondences(
                _factor_kind(kind),
                st[kind].points,
                st[kind].st.geom_a,
                st[kind].st.geom_b,
                es._weights_from(st[kind].st.observe, st[kind].st.sparsity, vcs[kind], o.weight_type, ranges[kind]),
                vcs[kind],
            )
            for kind in grids
        ]
        pose_l, h = _gn_inner(mesh, cfg, pose_l, factors)

    q = torch.where(enough, pose_l.q, pose0.q)
    t_l = torch.where(enough, pose_l.t, pose0.t)
    h_fin = torch.where(enough, h, torch.zeros_like(h))
    scale_rest = float(max(opt_count - 1, 0))
    rgs, scan_rgs, counts = {}, {}, {}
    for kind in grids:
        s = st[kind]
        m0, m_fin, vc = m0s[kind] & enough, matches[kind] & enough, vcs[kind] & enough
        writeback = es._scan_writeback(s.st.round_, s.st.observe, s.scan_rg, (m0 & s.st.pers_ok) | vc, o)
        inc, scan_rgs[kind] = _route_back(mesh, grids[kind].rg.shape[0], s.shard, s.st.nn_idx, m0.float() + scale_rest * m_fin.float(), writeback)
        rgs[kind] = es._add_g(grids[kind].rg, inc, o.counter_cap)
        counts[kind] = vc.sum()
    return q, t_l, h_fin, rgs, scan_rgs, counts


def _outer_per_iter(mesh: Mesh, cfg: PipelineConfig, opt_count: int, enough, pose0, center, grids: dict, ds: dict, bounds: dict):
    """Collective twin of ``es_odometry._outer_per_iter``
    (``assoc_once=False``): a full collective re-association in every outer
    iteration, on the counters as the previous iterations left them."""
    o = cfg.odometry
    dev = center.device
    pose_l = pose0
    h = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    rgs = {kind: grids[kind].rg for kind in grids}
    scan_rgs = {kind: ds[kind].rg for kind in grids}
    counts = {kind: torch.zeros((), dtype=torch.int64, device=dev) for kind in grids}
    for it in range(opt_count):
        gate_sq = o.nn_gate_wide_sq if it == 0 else o.nn_gate_sq
        passes = {}
        for kind in grids:
            a, points, inc, scan_rgs[kind] = _associate(mesh, kind, grids[kind], rgs[kind], pose_l, center, ds[kind], scan_rgs[kind], cfg, bounds[kind], gate_sq)
            rgs[kind] = es._add_g(rgs[kind], inc, o.counter_cap)
            counts[kind] = a.valid.sum()
            passes[kind] = (a, points)
        ranges = _weight_ranges(mesh, {kind: (a.weight_obs, a.weight_spr, a.valid) for kind, (a, _) in passes.items()}, o.weight_type)
        factors = [
            gn.Correspondences(
                _factor_kind(kind), points, a.geom_a, a.geom_b, es._weights_from(a.weight_obs, a.weight_spr, a.valid, o.weight_type, ranges[kind]), a.valid
            )
            for kind, (a, points) in passes.items()
        ]
        pose_l, h = _gn_inner(mesh, cfg, pose_l, factors)

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


def outer_loop(cfg: PipelineConfig):
    return _outer_assoc_once if cfg.odometry.assoc_once else _outer_per_iter


def merge(mesh: Mesh, grid, scan_world, scan_rg, scan_valid, pose_t, leaf: float, cfg: PipelineConfig, kind: str):
    """This shard's map merge: adopt the scan points whose voxel hashes to it,
    then crop, rgbds re-voxelize, evict, age and re-sort locally, at
    ``capacity // n_map``.  The tiled index's fused merge has absolute voxel
    boundaries; the grid index's unfused merge is anchored at the pose on
    the absolute grid.  Returns ``(index, n_voxel_dropped)``."""
    own = (voxel.spatial_hash(scan_world, leaf) % mesh.n_map) == mesh.map_index
    cap_local = _local_capacity(cfg, kind, mesh.n_map)
    if map_state.is_tiled(cfg):
        return map_state.merge_scan_into_index(grid, scan_world, scan_rg, scan_valid & own, pose_t, leaf, cfg, kind, capacity=cap_local)
    return map_state._merge_unfused(
        grid, scan_world, scan_rg, scan_valid & own, pose_t, leaf, cfg.odometry, cap_local, cfg.capacity.knn_cell_size, anchored=True
    )


def seed_shard(mesh: Mesh, xyz, mask, pose_t, leaf: float, cfg: PipelineConfig, kind: str):
    """This shard's first-frame map: the masked points whose voxel hashes to
    it, compacted into ``capacity // n_map`` slots (beyond that they are
    dropped, as in the reference).  Returns ``(index, points owned)``."""
    cap_local = _local_capacity(cfg, kind, mesh.n_map)
    own = mask & ((voxel.spatial_hash(xyz, leaf) % mesh.n_map) == mesh.map_index)
    oxyz, ovalid, _ = es._compact_idx(xyz, own, cap_local)
    rg = torch.zeros((cap_local, 2), dtype=torch.float32, device=xyz.device)
    return map_state.build_index(oxyz, rg, ovalid, pose_t, cfg, kind), own.sum()


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------


def _first_frame_block(mesh: Mesh, state: es.ESState, feat, cfg: PipelineConfig):
    """Sharded ``initMapWithPoints``: each shard adopts its hash-owned raw
    features (ES counts no seed overflow, as the reference)."""
    o = cfg.odometry
    dev = mesh.device
    edge, _ = seed_shard(mesh, feat.xyz, feat.edge_mask, state.pose.t, o.map_resolution, cfg, "edge")
    surf, _ = seed_shard(mesh, feat.xyz, feat.surf_mask, state.pose.t, o.map_resolution * 2.0, cfg, "surf")
    new = state._replace(edge_map=edge, surf_map=surf, opt_count=o.max_outer_iters)
    sizes = mesh.psum(torch.stack([edge.valid.sum(), surf.valid.sum()]))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    diag = es.FrameDiag(
        n_edge_corr=zero,
        n_surf_corr=zero,
        edge_map_size=sizes[0],
        surf_map_size=sizes[1],
        dropped=torch.zeros((), dtype=torch.bool, device=dev),
        overflow=es.zero_overflow(dev),
        contam=torch.zeros(2, dtype=torch.int32, device=dev),
    )
    return new, diag


def _es_step_block(mesh: Mesh, state: es.ESState, feat, cfg: PipelineConfig):
    """One sharded odometry frame, the collective twin of
    ``es_odometry.es_step``."""
    o = cfg.odometry
    dev = mesh.device
    fr = es._prepare_frame(state, feat, cfg)
    center = fr.pred.t
    edge_grid, surf_grid = state.edge_map, state.surf_map
    sizes = mesh.psum(torch.stack([edge_grid.valid.sum(), surf_grid.valid.sum()]))
    enough = (sizes[0] > 10) & (sizes[1] > 50)
    q, t_l, h_fin, rgs, scan_rgs, counts = outer_loop(cfg)(
        mesh, cfg, fr.opt_count, enough, fr.pose0, center,
        {"edge": edge_grid, "surf": surf_grid}, {"edge": fr.ds_edge, "surf": fr.ds_surf}, {"edge": fr.e_bounds, "surf": fr.s_bounds},
    )
    # Every shard holds the same summed normal equations, so the guard and
    # the pose graph decide alike with no further collective.
    pose, last_pose, dropped, (pg_q, pg_t, pg_h, pg_valid) = es.guard_and_window(state, se3.Pose(q=q, t=t_l + center), h_fin, cfg)

    edge_world = se3.transform_points(pose, fr.ds_edge.xyz)
    surf_world = se3.transform_points(pose, fr.ds_surf.xyz)
    new_edge, over_me = merge(mesh, edge_grid._replace(rg=rgs["edge"]), edge_world, scan_rgs["edge"], fr.ds_edge.valid, pose.t, o.map_resolution, cfg, "edge")
    new_surf, over_ms = merge(mesh, surf_grid._replace(rg=rgs["surf"]), surf_world, scan_rgs["surf"], fr.ds_surf.valid, pose.t, o.map_resolution * 2.0, cfg, "surf")
    over_tile = map_state.tile_overflow_count(new_edge, cfg, "edge") + map_state.tile_overflow_count(new_surf, cfg, "surf")
    # Counts, map sizes and the merge and tile lanes are shard-local: one
    # all-reduce.  The compaction, downsample and halo lanes come from
    # replicated data.
    local = [counts["edge"], counts["surf"], new_edge.valid.sum(), new_surf.valid.sum(), over_me, over_ms, over_tile]
    red = mesh.psum(torch.stack([x.to(torch.int64) for x in local]))
    over_halo = es.halo_escapes(fr, edge_world, surf_world, edge_grid.origin, surf_grid.origin, cfg)
    overflow = torch.stack(fr.overflow + [red[4], red[5], red[6], over_halo]).to(torch.int32)

    new_state = es.ESState(
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
    diag = es.FrameDiag(
        n_edge_corr=red[0],
        n_surf_corr=red[1],
        edge_map_size=red[2],
        surf_map_size=red[3],
        dropped=dropped,
        overflow=overflow,
        contam=torch.zeros(2, dtype=torch.int32, device=dev),
    )
    return new_state, diag


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def init_sharded_state(cfg: PipelineConfig, mesh: Mesh) -> es.ESState:
    """This rank's block of an empty ES state on ``mesh.device``: its shard
    of each map at ``capacity // n_map`` points, and the replicated rest."""
    base = es.init_state(cfg, device=mesh.device)
    return base._replace(edge_map=_empty_local(cfg, "edge", mesh), surf_map=_empty_local(cfg, "surf", mesh))


def make_sharded_step(cfg: PipelineConfig, mesh: Mesh, first: bool = False):
    """This rank's sharded frame function ``step(state, xyz, mask) -> (state,
    FrameDiag)``: ``state`` is its block (from :func:`init_sharded_state`),
    ``xyz`` [N,3] and ``mask`` [N] its row's raw scan on ``mesh.device``.
    The optional ES pre-filters and the feature extraction run replicated on
    every rank of the row, and every rank of a row returns the same pose
    and diagnostics."""
    def step(state, xyz, mask):
        mask = es_prefilter(xyz, mask, cfg)
        feat = features.extract_features(xyz, mask, cfg.lidar, cfg.features, cfg.capacity)
        if first:
            return _first_frame_block(mesh, state, feat, cfg)
        return _es_step_block(mesh, state, feat, cfg)

    return step
