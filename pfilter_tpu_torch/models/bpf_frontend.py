"""BPF front-end: ground removal -> DCVC clustering -> PCA classification.

Port of ``pfilter_tpu/models/bpf_frontend.py`` (ref ``curvedVoxel_node``,
src/additionNode.cpp:12-54): each stage is optional and gated like the
reference's ``groundfilter`` / ``curvedfilter`` / ``featurePreExtract``
(launch/pfilter_kitti.launch:5-10); the output is a set of boolean masks over
the input scan (beam/pillar/facade for BPF odometry, plus the surviving
non-ground cloud).

Two moment back-ends, by ``cfg.pca.impl``:

- ``"voxel"`` (default): the non-ground cloud is compacted to an ``n//2``
  prefix, clustered, and classified at voxel resolution
  (``ops/pca_voxel.py``); masks go back to scan indexing through one masked
  scatter (invalid prefix rows write into a spare row that is dropped).
- ``"radius"``: exact 1 m balls through the radius-PCA kernel
  (``ops/pca_radius.py``, ``csrc/pca_radius.cu`` on the card) over the raw
  scan tiled at ``capacity.frontend_tile_cap``; candidate slots beyond the
  halo-row cap are counted in ``n_halo_truncated``.

``n_halo_truncated`` means what it means in the reference package: for
``"voxel"`` it sums dropped voxels, the always-zero ``dcvc_dropped`` and the
prefix overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pfilter_tpu_torch.config import PipelineConfig
from pfilter_tpu_torch.models.es_odometry import _compact_idx
from pfilter_tpu_torch.ops import dcvc, ground, knn_tiled, pca_classify, pca_radius, pca_voxel


class FrontendResult(NamedTuple):
    ground_mask: torch.Tensor
    nonground_mask: torch.Tensor  # after optional DCVC small-cluster removal
    beam_mask: torch.Tensor
    pillar_mask: torch.Tensor
    facade_mask: torch.Tensor
    # Points or candidate slots a fixed capacity dropped (0 in a correctly
    # sized run): halo slots past the radius kernel's cap, or voxel-path drops.
    n_halo_truncated: torch.Tensor


def run_frontend(xyz, valid, cfg: PipelineConfig, use_ground_filter: bool = True, use_curved_filter: bool = True) -> FrontendResult:
    """Masks over the raw scan (sensor frame).  Stages:

    1. grid ground segmentation (ref: include/preProcess.hpp:398-505),
    2. DCVC clustering on non-ground points; clusters < minSeg dropped
       (ref: src/additionClass.cpp:457-497),
    3. neighbourhood-PCA moments + beam/pillar/facade thresholds
       (ref: include/preProcess.hpp:646-736).
    """
    n = xyz.shape[0]
    dev = xyz.device
    if use_ground_filter:
        g = ground.segment_ground_dispatch(xyz, valid, cfg)
        ground_mask, nonground = g.ground_mask, g.nonground_mask
    else:
        ground_mask, nonground = torch.zeros_like(valid), valid

    # Optional ground->facade routing (PCAClassifyConfig.ground_as_facade:
    # without it the channel set has no z-constraining geometry).
    ground_extra = ground_mask if cfg.pca.ground_as_facade else torch.zeros_like(valid)
    if cfg.pca.ground_as_facade and cfg.pca.ground_facade_decimate > 1:
        stride = torch.arange(n, device=dev) % cfg.pca.ground_facade_decimate == 0
        ground_extra = ground_extra & stride

    if cfg.pca.impl == "voxel":
        ccap = max(n // 2, 8)
        cxyz, cvalid, cidx = _compact_idx(xyz, nonground, ccap)
        n_c_over = torch.clamp(nonground.sum() - ccap, min=0)
        ckeep = cvalid
        dcvc_dropped = 0
        if use_curved_filter:
            c = dcvc.cluster(cxyz, cvalid, cfg.dcvc, cfg.lidar)
            ckeep = c.keep
            dcvc_dropped = c.n_vox_dropped
        vc = pca_voxel.voxel_pca_classify(cxyz, ckeep, cfg.pca, max_voxels=cfg.pca.max_voxels)
        i32 = torch.int32
        code = (
            ckeep.to(i32)
            + 2 * (vc.beam_mask & cvalid).to(i32)
            + 4 * (vc.pillar_mask & cvalid).to(i32)
            + 8 * (vc.facade_mask & cvalid).to(i32)
        )
        full = torch.zeros(n + 1, dtype=i32, device=dev)
        full.scatter_(0, torch.where(cvalid, cidx, torch.full_like(cidx, n)), torch.where(cvalid, code, torch.zeros_like(code)))
        full = full[:n]
        return FrontendResult(
            ground_mask=ground_mask,
            nonground_mask=(full & 1) > 0,
            beam_mask=(full & 2) > 0,
            pillar_mask=(full & 4) > 0,
            facade_mask=((full & 8) > 0) | ground_extra,
            n_halo_truncated=(vc.n_voxel_dropped + dcvc_dropped + n_c_over).to(i32),
        )

    if use_curved_filter:
        nonground = dcvc.cluster(xyz, nonground, cfg.dcvc, cfg.lidar).keep
    # Exact balls over the raw scan, tiled at its own capacity.
    cap = cfg.capacity
    nt, tc, tile_cap = cap.knn_tiles, cap.tile_cells, cap.frontend_tile_cap
    origin = knn_tiled.tile_origin_for_pose(torch.zeros(3, dtype=torch.float32, device=dev), nt, tc)
    rg = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    tmap = knn_tiled.build_tiled(xyz, rg, nonground, origin, nt, tc, tile_cap)
    moments = pca_radius.radius_pca_moments(tmap, xyz, nonground, nt, tc, tile_cap, radius=cfg.pca.neighbor_radius)
    cls = pca_classify.classify(xyz, nonground, moments, cfg.pca)
    return FrontendResult(
        ground_mask=ground_mask,
        nonground_mask=nonground,
        beam_mask=cls.beam_mask,
        pillar_mask=cls.pillar_mask,
        facade_mask=cls.facade_mask | ground_extra,
        n_halo_truncated=knn_tiled.halo_overflow(tmap, nt, 3 * tile_cap),
    )
