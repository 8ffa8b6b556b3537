"""Map-sharded BPF odometry: the reference's default launch pipeline (ground
seg -> DCVC -> PCA classify -> beam/pillar/facade scan-to-map GN, ref:
launch/pfilter_kitti.launch:5-10, src/odomEstimationClass.cpp:649-1306) over
the seq x map grid of :mod:`pfilter_tpu_torch.parallel.es_sharded`.

Port of ``pfilter_tpu/parallel/bpf_sharded.py``.  The collective
association and the outer loops of ``es_sharded`` take any channels, so this
is the three-channel frame around them: each of the three feature maps is
hash-partitioned across the map ranks, the shards' 5-NN candidates are
all-gathered and merged, each query slice builds its factors for all
channels, and one all-reduce per Gauss-Newton step sums the combined
normal equations.  The front-end runs replicated on every rank of a row
(with ``pca.impl="radius"`` each rank launches the PCA kernel).

The collectives of a frame are those of the ES step with three maps in place
of two (``es_sharded``'s docstring).  With ``n_map == 1`` the step equals
``bpf_odometry.bpf_step`` bit for bit.
"""

from __future__ import annotations

import torch

from pfilter_tpu_torch.config import PipelineConfig
from pfilter_tpu_torch.models import bpf_frontend, map_state
from pfilter_tpu_torch.models import bpf_odometry as bo
from pfilter_tpu_torch.models.bpf_odometry import CHANNELS, BPFDiag, BPFState
from pfilter_tpu_torch.models.es_odometry import _compact_idx, guard_and_window
from pfilter_tpu_torch.ops import se3, voxel
from pfilter_tpu_torch.parallel.es_sharded import _empty_local, merge, outer_loop, seed_shard
from pfilter_tpu_torch.parallel.mesh import Mesh


def _first_frame_block(mesh: Mesh, state: BPFState, xyz, masks, cfg: PipelineConfig):
    """Sharded ``initMapWithPoints`` over the three channels: the replicated
    seed cloud is rgbds-voxelized as in ``bpf_odometry.first_frame``, then
    each shard adopts its hash-owned voxel centroids, an exact partition of
    the single-device seed map (ref: src/odomEstimationClass.cpp:689-695).
    A hash-skewed seed can exceed a shard's ``capacity // n_map`` slots: the
    excess is counted in the merge lane of the overflow rows."""
    dev = mesh.device
    new_maps, seed_over = {}, []
    for kind in CHANNELS:
        comp_cap = bo._compact_cap(cfg, kind)
        cxyz, cvalid, _ = _compact_idx(xyz, masks[kind], comp_cap)
        seed = voxel.voxel_downsample_rgbds(
            voxel.PointSet(cxyz, torch.zeros((comp_cap, 2), dtype=torch.float32, device=dev), cvalid),
            bo._leaf(cfg, kind),
            map_state.map_capacity(cfg, kind),
        )
        new_maps[kind], n_own = seed_shard(mesh, seed.xyz, seed.valid, state.pose.t, bo._leaf(cfg, kind), cfg, kind)
        seed_over.append(torch.clamp(n_own - new_maps[kind].valid.shape[0], min=0))
    # The shard-local seed excess and the map sizes: one all-reduce.
    red = mesh.psum(torch.stack(seed_over + [new_maps[k].valid.sum() for k in CHANNELS]).to(torch.int64))
    overflow = torch.zeros((3, 4), dtype=torch.int32, device=dev)
    overflow[:, 2] = red[:3].to(torch.int32)
    new_state = state._replace(
        beam_map=new_maps["beam"],
        pillar_map=new_maps["pillar"],
        facade_map=new_maps["facade"],
        opt_count=cfg.odometry.max_outer_iters,
    )
    diag = BPFDiag(
        n_corr=torch.zeros(3, dtype=torch.int32, device=dev),
        map_sizes=red[3:].to(torch.int32),
        dropped=torch.zeros((), dtype=torch.bool, device=dev),
        overflow=overflow,
    )
    return new_state, diag


def _bpf_step_block(mesh: Mesh, state: BPFState, xyz, masks, cfg: PipelineConfig):
    """One sharded BPF frame, the collective twin of ``bpf_odometry.bpf_step``."""
    grids = bo._grids_of(state)
    fr = bo._prepare_frame(state, xyz, masks, cfg)
    center = fr.pred.t
    # Map-size gate (ref :722, beam > 10 and pillar > 10 and facade > 50)
    # on the summed shard sizes.
    sizes = mesh.psum(torch.stack([grids[kind].valid.sum() for kind in CHANNELS]))
    enough = (sizes[0] > 10) & (sizes[1] > 10) & (sizes[2] > 50)
    q, t_l, h_fin, rgs, scan_rgs, counts = outer_loop(cfg)(mesh, cfg, fr.opt_count, enough, fr.pose0, center, grids, fr.ds, fr.bounds)
    pose, last_pose, dropped, (pg_q, pg_t, pg_h, pg_valid) = guard_and_window(state, se3.Pose(q=q, t=t_l + center), h_fin, cfg)

    new_maps, over_merge, over_tile = {}, [], []
    for kind in CHANNELS:
        world = se3.transform_points(pose, fr.ds[kind].xyz)
        new_maps[kind], over = merge(
            mesh, grids[kind]._replace(rg=rgs[kind]), world, scan_rgs[kind], fr.ds[kind].valid, pose.t, bo._leaf(cfg, kind), cfg, kind
        )
        over_merge.append(over)
        over_tile.append(map_state.tile_overflow_count(new_maps[kind], cfg, kind))
    # Counts, map sizes and the merge and tile lanes are shard-local: one
    # all-reduce.  The compaction and downsample lanes come from replicated data.
    local = [counts[k] for k in CHANNELS] + [new_maps[k].valid.sum() for k in CHANNELS] + over_merge + over_tile
    red = mesh.psum(torch.stack([x.to(torch.int64) for x in local])).reshape(4, 3)
    over_rows = [
        torch.stack([fr.over_compact[kind], fr.over_ds[kind], red[2, i], red[3, i]]) for i, kind in enumerate(CHANNELS)
    ]
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
        n_corr=red[0].to(torch.int32),
        map_sizes=red[1].to(torch.int32),
        dropped=dropped,
        overflow=torch.stack(over_rows).to(torch.int32),
    )
    return new_state, diag


def init_sharded_state(cfg: PipelineConfig, mesh: Mesh) -> BPFState:
    """This rank's block of an empty BPF state on ``mesh.device``: its shard
    of each of the three maps at ``capacity // n_map`` points, and the
    replicated rest."""
    base = bo.init_state(cfg, device=mesh.device)
    return base._replace(**{f"{kind}_map": _empty_local(cfg, kind, mesh) for kind in CHANNELS})


def sharded_frame(mesh: Mesh, cfg: PipelineConfig, state: BPFState, xyz, masks, first: bool):
    """One sharded BPF frame on the front-end's channel ``masks``."""
    if first:
        return _first_frame_block(mesh, state, xyz, masks, cfg)
    return _bpf_step_block(mesh, state, xyz, masks, cfg)


def make_sharded_step(cfg: PipelineConfig, mesh: Mesh, first: bool = False):
    """This rank's sharded BPF frame function ``step(state, xyz, mask) ->
    (state, BPFDiag)`` on its row's raw scan (xyz [N,3], mask [N] on
    ``mesh.device``); the front-end (ground seg -> DCVC -> PCA classify) runs
    replicated on every rank of the row."""
    def step(state, xyz, mask):
        fr = bpf_frontend.run_frontend(xyz, mask, cfg)
        masks = {"beam": fr.beam_mask, "pillar": fr.pillar_mask, "facade": fr.facade_mask}
        return sharded_frame(mesh, cfg, state, xyz, masks, first)

    return step
