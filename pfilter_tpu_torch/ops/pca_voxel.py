"""Voxel-aggregated neighbourhood PCA: the BPF front-end's default moments.

Port of ``pfilter_tpu/ops/pca_voxel.py`` (ref per-point radius kNN + PCL
PCA, include/preProcess.hpp:200-247, 283-324, reformulated):

1. bin the cloud into ``leaf``-sized voxels (one stable sort),
2. segment-sum per-voxel moments [n, Σx, Σy, Σz, Σxx, Σyy, Σzz, Σxy, Σxz,
   Σyz] in voxel-local coordinates (fp32 second moments at |coord| ~ 90 m
   would cancel; locals stay below the leaf),
3. write each occupied voxel's row into a dense 3D cell table (the
   sensor-frame scan is bounded by the lidar range: ~8M int32 cells, 32 MB),
4. sum each occupied voxel's 3x3x3 neighbours' moments (27 direct gathers),
   shifted by the constant inter-voxel offset, and classify per voxel;
   points inherit their voxel's class.

The neighbourhood is a voxel-aligned cube of edge ``3*leaf`` around the
query's voxel instead of the reference's 1 m ball; it is exact for that
cube, with no capacity truncation of candidates.  Occupied voxels beyond
``max_voxels`` are dropped and counted.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pfilter_tpu_torch.config import PCAClassifyConfig
from pfilter_tpu_torch.ops import pca_classify, voxel
from pfilter_tpu_torch.ops.pca_radius import PCAMoments

# Dense-table window (sensor frame): xy bounded by max lidar range (90 m),
# z by physical scene height.  288*288*96 cells at leaf 0.7 = ~32 MB int32.
_HALF_XY = 100.8
_HALF_Z = 33.6

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _dims(leaf: float):
    nx = 2 * int(math.ceil(_HALF_XY / leaf))
    nz = 2 * int(math.ceil(_HALF_Z / leaf))
    return nx, nx, nz


def _shift(v: torch.Tensor, leaf: float, sign: int) -> torch.Tensor:
    """[N,3] ``v`` plus ``sign`` times the window's half extent in cells, per
    axis (Python scalars: no host-to-device copy inside the step)."""
    nx, ny, nz = _dims(leaf)
    return torch.stack([v[:, 0] + sign * (nx // 2), v[:, 1] + sign * (ny // 2), v[:, 2] + sign * (nz // 2)], -1)


def _cells(xyz, valid, leaf: float):
    """Dense linear cell id per point; out-of-window or invalid -> NCELL
    (the sentinel row of the table).  Returns (cell, ijk, ncell)."""
    nx, ny, nz = _dims(leaf)
    ijk = _shift(torch.floor(xyz / leaf).to(torch.int32), leaf, 1)
    in_win = (ijk[:, 0] >= 0) & (ijk[:, 0] < nx) & (ijk[:, 1] >= 0) & (ijk[:, 1] < ny) & (ijk[:, 2] >= 0) & (ijk[:, 2] < nz)
    cell = (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2]
    ncell = nx * ny * nz
    cell = torch.where(valid & in_win, cell, torch.full_like(cell, ncell))
    return cell, ijk, ncell


class _VoxelTable(NamedTuple):
    mom: torch.Tensor  # [V, 10] per-voxel local-frame moment sums
    cell: torch.Tensor  # [V] dense cell id (NCELL for empty rows)
    center: torch.Tensor  # [V, 3] voxel center (sensor frame)
    row_of: torch.Tensor  # [NCELL+1] int32 — cell -> row (-1 if empty)
    point_cell: torch.Tensor  # [N] each input point's cell id
    n_dropped: torch.Tensor  # occupied voxels beyond max_voxels (overflow)


def _build_table(xyz, valid, leaf: float, max_voxels: int) -> _VoxelTable:
    nx, ny, nz = _dims(leaf)
    dev = xyz.device
    cell, ijk, ncell = _cells(xyz, valid, leaf)
    ok = cell < ncell
    vctr = (_shift(ijk.to(torch.float32), leaf, -1) + 0.5) * leaf
    local = xyz - vctr

    order = torch.argsort(cell, stable=True)
    scell, sloc, sok = cell[order], local[order], ok[order]

    head = torch.ones_like(sok)
    head[1:] = scell[1:] != scell[:-1]
    seg = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32) - 1
    n_occ = torch.amax(torch.where(sok, seg, torch.full_like(seg, -1))) + 1
    # Invalid points and voxels past the capacity go to a dump row, dropped.
    seg = torch.where(sok & (seg < max_voxels), seg, torch.full_like(seg, max_voxels)).long()

    ones = sok.to(torch.float32)
    x, y, z = sloc[:, 0], sloc[:, 1], sloc[:, 2]
    feats = torch.stack([ones, x, y, z, x * x, y * y, z * z, x * y, x * z, y * z], -1) * ones[:, None]
    mom = voxel.segment_add(torch.zeros((max_voxels + 1, 10), dtype=torch.float32, device=dev), seg, feats)
    mom = mom[:max_voxels]
    vcell = torch.full((max_voxels + 1,), ncell, dtype=torch.int32, device=dev)
    vcell.scatter_reduce_(0, seg, torch.where(sok, scell, torch.full_like(scell, ncell)), "amin", include_self=True)
    vcell = vcell[:max_voxels]
    occupied = mom[:, 0] > 0
    vcell = torch.where(occupied, vcell, torch.full_like(vcell, ncell))

    iz = vcell % nz
    iy = torch.div(vcell, nz, rounding_mode="floor") % ny
    ix = torch.div(vcell, nz * ny, rounding_mode="floor")
    center = (_shift(torch.stack([ix, iy, iz], -1).to(torch.float32), leaf, -1) + 0.5) * leaf

    # cell -> row; empty rows all write -1 into the sentinel cell.
    rows = torch.arange(max_voxels, dtype=torch.int32, device=dev)
    row_of = torch.full((ncell + 1,), -1, dtype=torch.int32, device=dev)
    row_of.scatter_(0, vcell.long(), torch.where(occupied, rows, torch.full_like(rows, -1)))
    row_of.narrow(0, ncell, 1).fill_(-1)  # a kernel: a 0-dim assignment would copy from the host
    return _VoxelTable(
        mom=mom,
        cell=vcell,
        center=center,
        row_of=row_of,
        point_cell=cell,
        n_dropped=torch.clamp(n_occ - max_voxels, min=0),
    )


def _cube_moments_rows(tbl: _VoxelTable, leaf: float) -> torch.Tensor:
    """Per occupied voxel row: moments of its 3x3x3 cube neighbourhood, in the
    row's own voxel-local frame (translation-shifted sums)."""
    nx, ny, nz = _dims(leaf)
    ncell = nx * ny * nz
    total = torch.zeros_like(tbl.mom)
    own_valid = tbl.cell < ncell
    iz = tbl.cell % nz
    iy = torch.div(tbl.cell, nz, rounding_mode="floor") % ny
    ix = torch.div(tbl.cell, nz * ny, rounding_mode="floor")
    for dx, dy, dz in _OFFSETS:
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        in_win = own_valid & (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
        ncell_id = torch.where(in_win, (jx * ny + jy) * nz + jz, torch.full_like(jx, ncell))
        nrow = tbl.row_of[ncell_id.long()]
        hit = nrow >= 0
        m = torch.where(hit[:, None], tbl.mom[torch.clamp(nrow, min=0).long()], torch.zeros_like(tbl.mom))
        cnt = m[:, 0]
        sx, sy, sz = dx * leaf, dy * leaf, dz * leaf
        total = total + torch.stack(
            [
                cnt,
                m[:, 1] + cnt * sx,
                m[:, 2] + cnt * sy,
                m[:, 3] + cnt * sz,
                m[:, 4] + 2 * sx * m[:, 1] + cnt * sx * sx,
                m[:, 5] + 2 * sy * m[:, 2] + cnt * sy * sy,
                m[:, 6] + 2 * sz * m[:, 3] + cnt * sz * sz,
                m[:, 7] + sx * m[:, 2] + sy * m[:, 1] + cnt * sx * sy,
                m[:, 8] + sx * m[:, 3] + sz * m[:, 1] + cnt * sx * sz,
                m[:, 9] + sy * m[:, 3] + sz * m[:, 2] + cnt * sy * sz,
            ],
            -1,
        )
    return total


def _finalize(total, valid, center) -> PCAMoments:
    cnt = total[:, 0]
    safe_n = torch.clamp(cnt, min=1.0)
    mean_local = total[:, 1:4] / safe_n[:, None]
    xx, yy, zz, xy, xz, yz = (total[:, k] for k in range(4, 10))
    second = torch.stack(
        [torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1), torch.stack([xz, yz, zz], -1)], -2
    )
    cov = second - safe_n[:, None, None] * mean_local[:, :, None] * mean_local[:, None, :]
    mean = mean_local + torch.where(valid[:, None], center, torch.zeros_like(center))
    cnt = torch.where(valid, cnt, torch.zeros_like(cnt))
    return PCAMoments(count=cnt, mean=mean, cov=torch.where(valid[:, None, None], cov, torch.zeros_like(cov)))


def voxel_pca_moments(xyz, valid, leaf: float = 0.7, max_voxels: int | None = None) -> PCAMoments:
    """Per-POINT cube-neighbourhood moments (each point's own voxel's 3x3x3
    block), used by tests and wherever point-resolution moments are needed;
    the front-end classifies at voxel resolution (:func:`voxel_pca_classify`)."""
    if max_voxels is None:
        max_voxels = xyz.shape[0]
    tbl = _build_table(xyz, valid, leaf, max_voxels)
    rows_total = _cube_moments_rows(tbl, leaf)
    prow = tbl.row_of[tbl.point_cell.long()]
    ok = valid & (prow >= 0)
    total = torch.where(ok[:, None], rows_total[torch.clamp(prow, min=0).long()], torch.zeros_like(rows_total[:1]))
    vctr = (torch.floor(xyz / leaf) + 0.5) * leaf
    return _finalize(total, ok, vctr)


class VoxelClassifyResult(NamedTuple):
    beam_mask: torch.Tensor  # [N] bool — per input point
    pillar_mask: torch.Tensor
    facade_mask: torch.Tensor
    n_voxel_dropped: torch.Tensor  # occupied voxels beyond max_voxels


def voxel_pca_classify(xyz, valid, cfg: PCAClassifyConfig, max_voxels: int = 16384) -> VoxelClassifyResult:
    """Classify at voxel resolution and hand each point its voxel's class
    (ref classifies every non-ground point, include/preProcess.hpp:646-736,
    then BPF odometry voxelizes each class at coarser leafs)."""
    leaf = cfg.voxel_leaf
    tbl = _build_table(xyz, valid, leaf, max_voxels)
    total = _cube_moments_rows(tbl, leaf)
    nx, ny, nz = _dims(leaf)
    row_valid = tbl.cell < nx * ny * nz
    moments = _finalize(total, row_valid, tbl.center)
    # Voxel "position" for the beam z-gate: the voxel's own centroid.
    cnt_own = torch.clamp(tbl.mom[:, 0], min=1.0)
    centroid = tbl.center + tbl.mom[:, 1:4] / cnt_own[:, None]
    cls = pca_classify.classify(centroid, row_valid, moments, cfg)

    prow = tbl.row_of[tbl.point_cell.long()]
    ok = valid & (prow >= 0)
    safe = torch.clamp(prow, min=0).long()
    return VoxelClassifyResult(
        beam_mask=ok & cls.beam_mask[safe],
        pillar_mask=ok & cls.pillar_mask[safe],
        facade_mask=ok & cls.facade_mask[safe],
        n_voxel_dropped=tbl.n_dropped,
    )
