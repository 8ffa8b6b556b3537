"""Grid-based ground segmentation (ref ``groundSeg::ground_seg``,
include/preProcess.hpp:398-505).

Port of ``pfilter_tpu/ops/ground.py``.  A static ``[G, G]`` grid centered on
the sensor (default 3 m cells) tracks each cell's minimum z and point count;
a 3x3 min-pool gives the neighbourhood minimum; a point is ground iff its
cell is populated (``min_grid_pt_num``), the cell's min-z is within
``neighbor_height_tol`` of the neighbourhood's, and the point lies within
``point_height_tol`` of the cell min-z inside the
[min_ground_height, max_ground_height] band.  Points above the band or
outside the grid window pass through as non-ground (ref :436-437); band
points of under-populated cells are dropped, as the reference's grid loop
never emits them (ref :473).

The scatter-min and the count scatter write into one spare cell past the
grid (out-of-window and invalid points), which is then dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pfilter_tpu_torch.config import GroundConfig

_ZBIG = 1.0e9


class GroundResult(NamedTuple):
    ground_mask: torch.Tensor  # [N] bool — ground points
    nonground_mask: torch.Tensor  # [N] bool — everything else that is valid


def segment_ground(
    xyz: torch.Tensor,
    valid: torch.Tensor,
    cfg: GroundConfig,
    min_grid_pt_num: int = 8,  # ref gf_grid_pt_num_thre (include/preProcess.hpp:575)
    max_ground_height: float = 5.0,  # ref gf_max_ground_height (:600)
    min_ground_height: float = -5.0,  # ref gf_min_ground_height (:601)
) -> GroundResult:
    max_height_difference = cfg.point_height_tol  # ref gf_max_grid_height_diff (:603)
    g = cfg.num_cells
    res = cfg.grid_size
    half = g * res / 2.0

    cx = torch.floor((xyz[:, 0] + half) / res).to(torch.int32)
    cy = torch.floor((xyz[:, 1] + half) / res).to(torch.int32)
    in_window = (cx >= 0) & (cx < g) & (cy >= 0) & (cy < g)
    cell_ok = valid & in_window

    z = xyz[:, 2]
    band = (z <= max_ground_height) & (z > min_ground_height)

    # Cell min-z over band points (ref :441-445) and point counts over all
    # in-window points (ref :435); row g*g is the spare cell.
    cell = torch.where(cell_ok, cx * g + cy, torch.full_like(cx, g * g)).long()
    minz = torch.full((g * g + 1,), _ZBIG, dtype=torch.float32, device=xyz.device)
    minz.scatter_reduce_(0, cell, torch.where(cell_ok & band, z, torch.full_like(z, _ZBIG)), "amin", include_self=True)
    counts = torch.zeros(g * g + 1, dtype=torch.int32, device=xyz.device)
    counts.index_put_((cell,), cell_ok.to(torch.int32), accumulate=True)
    minz = minz[: g * g].reshape(g, g)
    counts = counts[: g * g]

    # 3x3 neighbour min; border cells keep their own min (the reference skips
    # the border ring, ref :456).
    def pool1d(a, dim):
        return torch.minimum(a, torch.minimum(torch.roll(a, 1, dim), torch.roll(a, -1, dim)))

    inner = pool1d(pool1d(minz, 0), 1)
    ar = torch.arange(g, device=xyz.device)
    edge = (ar == 0) | (ar == g - 1)
    border = edge[:, None] | edge[None, :]
    neighbor_min = torch.where(border, minz, inner).reshape(-1)
    minz = minz.reshape(-1)

    # Per-point classification (the spare cell's index reads cell 0's values
    # for points that are not cell_ok; every use below is gated on cell_ok).
    safe = torch.where(cell_ok, cell, torch.zeros_like(cell))
    cell_minz = minz[safe]
    cell_nmin = neighbor_min[safe]
    cell_cnt = counts[safe]
    cell_reliable = (
        (cell_cnt >= min_grid_pt_num)
        & ((cell_minz - cell_nmin) < cfg.neighbor_height_tol)
        & (cell_minz < _ZBIG * 0.5)
    )
    is_ground = cell_ok & band & cell_reliable & ((z - cell_minz) < max_height_difference)
    out_window = valid & ~in_window
    above_band = cell_ok & (z > max_ground_height)
    in_counted = cell_ok & band & (cell_cnt >= min_grid_pt_num)
    nonground = out_window | above_band | (in_counted & ~is_ground)
    return GroundResult(ground_mask=is_ground, nonground_mask=nonground)


def segment_ground_dispatch(xyz, valid, pipeline_cfg) -> GroundResult:
    """Ground segmentation by ``GroundConfig.method``: "grid" is the
    reference's ground_seg (the only variant its launch graph calls,
    src/additionNode.cpp:24); "fast" the fast_ground_filter variant
    (``ops/fast_ground.py``, parameterised by ``FastGroundConfig``), whose
    distance-weighted downsampling also thins the surviving masks.
    ``pipeline_cfg`` is the full PipelineConfig."""
    method = pipeline_cfg.ground.method
    if method == "fast":
        from pfilter_tpu_torch.ops import fast_ground

        r = fast_ground.fast_ground_filter(xyz, valid, pipeline_cfg.fast_ground)
        return GroundResult(ground_mask=r.ground_mask, nonground_mask=r.nonground_mask)
    if method != "grid":
        raise ValueError(f"unknown ground.method {method!r}")
    return segment_ground(xyz, valid, pipeline_cfg.ground)
