"""Sorted voxel-grid k-nearest-neighbour search (``CapacityConfig.knn_impl
= "grid"``), the index that replaces ``pcl::KdTreeFLANN``
(ref: src/odomEstimationClass.cpp:249-250,299,447).

Port of ``pfilter_tpu/ops/knn.py``.  The map is kept sorted by packed 1 m
cell id on a 256^3 grid anchored near the pose; a query gathers up to
``candidates_per_cell`` points from each of its 27 neighbouring cells (two
``searchsorted`` probes per cell give the runs), masks the rest to +inf and
keeps the k smallest squared distances.  All of it is plain PyTorch on
either device: the reference has no kernel here.

Exactness: correspondences are gated at 5th-NN sq-distance < 1.0
(ref: src/odomEstimationClass.cpp:300) and every point within 1 m of a query
lies in its 27-cell neighbourhood at ``cell_size >= 1``, so gated results are
exact kNN as long as no cell holds more than ``candidates_per_cell`` map
points.  Neither package enforces or counts that bound (a 1 m cell meets at
most 27 voxels of a 0.4 m-leaf map, so 32 holds for the maps the engine
builds); ``chip_smoke.py`` checks it on the card.

Ties: the k smallest are taken by a stable sort over the ``[Q, 27 * P]``
candidate distances, so among equal distances the lower candidate position
comes first, the order ``lax.top_k`` gives the reference (duplicate map
points are common: every voxel merge can leave two centroids on one spot).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_ID = 2**31 - 1
_GRID_N = 256  # cells per axis; ids pack into ix*65536 + iy*256 + iz < 2^24


class HashGrid(NamedTuple):
    """A point map stored sorted by spatial cell id."""

    xyz: torch.Tensor  # [CAP, 3] float32, sorted by cell id
    rg: torch.Tensor  # [CAP, W] float32 persistence counters (r, g, ...)
    valid: torch.Tensor  # [CAP] bool
    cell_ids: torch.Tensor  # [CAP] int32 sorted; invalid slots = INT32_MAX
    origin: torch.Tensor  # [3] float32 — world coords of cell (0,0,0) corner
    cell_size: torch.Tensor  # [] float32


class KnnResult(NamedTuple):
    idx: torch.Tensor  # [Q, K] int32 indices into the grid arrays
    sqdist: torch.Tensor  # [Q, K] float32; +inf where no candidate


def _cell_coords(xyz: torch.Tensor, origin: torch.Tensor, cell_size) -> torch.Tensor:
    """Cell coordinates clipped to [1, 254] (the border ring is unused, so the
    27 neighbours never wrap).  The clip is done in float before the cast: a
    float -> int cast of a non-finite or far value is undefined on CUDA; NaN
    goes to 0 and so to cell 1, as the reference's saturating cast gives."""
    c = torch.nan_to_num(torch.floor((xyz - origin) / cell_size), nan=0.0)
    return torch.clamp(c, 1, _GRID_N - 2).to(torch.int32)


def _pack(c: torch.Tensor) -> torch.Tensor:
    return c[..., 0] * (_GRID_N * _GRID_N) + c[..., 1] * _GRID_N + c[..., 2]


def grid_origin_for_pose(pose_t: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Anchor the 256^3 grid so the pose sits at its centre; the +-100 m map
    crop (ref: src/odomEstimationClass.cpp:606-623) always fits."""
    return torch.floor(pose_t / cell_size) * cell_size - (_GRID_N // 2) * cell_size


def build_grid(xyz, rg, valid, origin, cell_size: float) -> HashGrid:
    """Sort points by cell id (one sort per map per frame, in place of the
    per-frame KD-tree rebuild at src/odomEstimationClass.cpp:249-250)."""
    ids = torch.where(valid, _pack(_cell_coords(xyz, origin, cell_size)), torch.full_like(valid, INVALID_ID, dtype=torch.int32))
    order = torch.argsort(ids, stable=True)
    return HashGrid(
        xyz=xyz[order],
        rg=rg[order],
        valid=valid[order],
        cell_ids=ids[order],
        origin=origin,
        # torch.full, not torch.tensor: no host-to-device copy.
        cell_size=torch.full((), cell_size, dtype=torch.float32, device=xyz.device),
    )


def _top_k_small(sq: torch.Tensor, k: int):
    """The k smallest along the last axis, ascending, lower position first
    among equal values.  Returns (values, positions)."""
    vals, pos = torch.sort(sq, dim=-1, stable=True)
    return vals[..., :k], pos[..., :k]


def knn_query(grid: HashGrid, query_xyz, query_valid, k: int, candidates_per_cell: int) -> KnnResult:
    """Batched k-NN: for each query, gather candidates from its 27 neighbour
    cells and keep the k nearest.  Invalid queries get +inf distances."""
    q = query_xyz.shape[0]
    p = candidates_per_cell
    dev = query_xyz.device

    qids = _pack(_cell_coords(query_xyz, grid.origin, grid.cell_size))  # [Q]
    # The 27 neighbour offsets, dx outermost, built on the device (no host copy).
    offsets = torch.arange(27, device=dev, dtype=torch.int32)
    offsets = (offsets // 9 - 1) * (_GRID_N * _GRID_N) + (offsets // 3 % 3 - 1) * _GRID_N + (offsets % 3 - 1)
    nids = qids[:, None] + offsets[None, :]  # [Q, 27]

    starts = torch.searchsorted(grid.cell_ids, nids, out_int32=True)  # [Q, 27]
    ends = torch.searchsorted(grid.cell_ids, nids, right=True, out_int32=True)

    slots = starts[..., None] + torch.arange(p, dtype=torch.int32, device=dev)  # [Q, 27, P]
    in_run = slots < ends[..., None]
    cap = grid.xyz.shape[0]
    cand = torch.where(in_run, slots, torch.full_like(slots, cap - 1)).reshape(q, 27 * p)
    cand_ok = in_run.reshape(q, 27 * p)

    cxyz = grid.xyz[cand.long()]  # [Q, 27P, 3]
    d = query_xyz[:, None, :] - cxyz
    sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    sq = torch.where(cand_ok & query_valid[:, None], sq, torch.full_like(sq, float("inf")))

    top_val, arg_top = _top_k_small(sq, k)
    idx = torch.gather(cand, 1, arg_top)
    return KnnResult(idx=idx.to(torch.int32), sqdist=top_val)
